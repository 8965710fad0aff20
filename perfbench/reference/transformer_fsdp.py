"""Plain PyTorch reference of the FSDP job's global step, and its inputs.

The ranks' micro-batches together are the global batch: step ``i`` trains
on every rank's ``i``-th micro-batch, rank ``r``'s rows at ``[r·B, (r+1)·B)``
(``perfbench/families/transformer_fsdp.py`` gathers them). The global step
is the sibling's SGD step (``transformer.py``) over all those rows from the
same seeded weights: the mean of the row blocks' gradients, each weighted by
its rows, which is the mean over the ranks of their micro-batch means that
FSDP's reduce-scatter gives. It runs on one card after the window, a row at
a time as the sibling does, since four rows of plain attention at these
widths would not fit beside their activations. Imports only its sibling.
"""

from .transformer import as_tree, dims, first_steps, leaf_shapes, make_batches, make_weights

__all__ = ["as_tree", "dims", "first_steps", "leaf_shapes", "make_batches", "make_weights"]
