"""Interop: migrate between reference torchsnapshot snapshots and this
package, both ways.

- :class:`ReferenceSnapshotReader` reads a snapshot **written by the
  reference library** (``.snapshot_metadata`` and ``torch_save``
  payloads) and restores it into torch statefuls, or converts it to the
  native format.
- ``reference_writer.convert_back`` exports a native snapshot in the
  reference's format (``python -m torchsnapshot_tpu_torch.inspect PATH
  --convert-back DEST``).
- :class:`TorchStateful` and the tree converters keep code written
  against the JAX package's interop running; in the port a torch
  stateful snapshots natively.

The JAX package's ``interop/orbax_format.py`` has no counterpart:
``orbax.checkpoint`` imports JAX, which the port never imports.
"""

from .reference_format import ReferenceSnapshotReader
from .torch_stateful import TorchStateful, numpy_to_torch_tree, torch_to_numpy_tree

__all__ = [
    "ReferenceSnapshotReader",
    "TorchStateful",
    "numpy_to_torch_tree",
    "torch_to_numpy_tree",
]
