"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Takes (synchronously or asynchronously) and restores app states of CPU
and CUDA tensors and DTensors in the JAX package's on-disk format — a
snapshot taken by either package restores through the other — from one
rank or every rank of a ``torch.distributed`` job, elastically: a state
of sharded and replicated values saved by N ranks restores on M. Manages
step-indexed checkpoints with retention; deduplicates takes (compression,
incremental takes against a base, a content-chunk store shared by a run,
with xs128 fingerprints computed by hand-written CUDA kernels); restores
selected leaves (``paths=``), verifies, copies and diffs snapshots, on the
local filesystem, in memory, on GCS or S3 (``python -m
torchsnapshot_tpu_torch.inspect`` from the shell); migrates snapshots to
and from the reference torchsnapshot's format (``interop``); and trains
the flagship transformer with hand-written CUDA flash-attention kernels,
forward and backward, and the JAX package's other workloads (DLRM with
row-sharded tables, a ResNet CNN, a synthetic DDP model). Its
``faultline`` injects storage and rank faults and checks crash
consistency. Its ``hottier`` acknowledges an async take once every
object is held in the RAM of k peer hosts (real peer processes over the
JAX package's wire format), drains it to durable storage in the
background, and restores from peer RAM with a per-object fallback to
durable storage. Its ``snapserve`` read plane lets N consumers (inference
replicas, eval jobs, resharded starts) share one backend read of a
snapshot through a caching server or a fleet of them (``RemoteSnapshot``,
``snapserve://`` URLs; the JAX package's wire format both ways). Every
take and restore writes the JAX package's telemetry
(flight reports, progress records, the ledger; ``telemetry``) and, with
``TPUSNAPSHOT_TRACE`` set, a Chrome trace (``tracing``). Imports neither
JAX nor the JAX package.
"""

from . import hottier, telemetry

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
from . import snapserve
from .snapserve import RemoteSnapshot
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
    "RemoteSnapshot",
    "Snapshot",
    "StateDict",
    "Stateful",
    "StoreCoordinator",
    "TorchStore",
    "get_coordinator",
    "hottier",
    "snapserve",
    "telemetry",
    "__version__",
]
