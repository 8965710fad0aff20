"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Takes (synchronously or asynchronously) and restores app states of CPU
and CUDA tensors and DTensors in the JAX package's on-disk format — a
snapshot taken by either package restores through the other — from one
rank or every rank of a ``torch.distributed`` job, elastically: a state
of sharded and replicated values saved by N ranks restores on M. Manages
step-indexed checkpoints with retention; deduplicates takes (compression,
incremental takes against a base, a content-chunk store shared by a run,
with xs128 fingerprints computed by hand-written CUDA kernels); and trains
the flagship transformer with hand-written CUDA flash-attention kernels,
forward and backward. Imports neither JAX nor the JAX package.
"""

from .coord import (
    Coordinator,
    DictStore,
    FileStore,
    NoOpCoordinator,
    StoreCoordinator,
    TorchStore,
    get_coordinator,
)
from .manager import CheckpointManager, PendingManagedSnapshot
from .rng_state import RNGState
from .snapshot import FORMAT_VERSION as __version__, PendingSnapshot, Snapshot
from .state_dict import StateDict
from .stateful import AppState, Stateful
from .utils.train_state import FnStateful, PytreeStateful

__all__ = [
    "AppState",
    "CheckpointManager",
    "Coordinator",
    "DictStore",
    "FileStore",
    "FnStateful",
    "NoOpCoordinator",
    "PendingManagedSnapshot",
    "PendingSnapshot",
    "PytreeStateful",
    "RNGState",
    "Snapshot",
    "StateDict",
    "Stateful",
    "StoreCoordinator",
    "TorchStore",
    "get_coordinator",
    "__version__",
]
