"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Takes and restores app states of CPU and CUDA tensors in the JAX
package's on-disk format — a snapshot taken by either package restores
through the other — and runs the flagship transformer's forward pass
with a hand-written CUDA flash-attention kernel. Imports neither JAX nor
the JAX package.
"""

from .coord import Coordinator, DictStore, FileStore, NoOpCoordinator, get_coordinator
from .rng_state import RNGState
from .snapshot import FORMAT_VERSION as __version__, Snapshot
from .state_dict import StateDict
from .stateful import AppState, Stateful

__all__ = [
    "AppState",
    "Coordinator",
    "DictStore",
    "FileStore",
    "NoOpCoordinator",
    "RNGState",
    "Snapshot",
    "StateDict",
    "Stateful",
    "get_coordinator",
    "__version__",
]
