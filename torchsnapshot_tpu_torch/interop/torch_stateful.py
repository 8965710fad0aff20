"""TorchStateful: torch-style statefuls in code written against the JAX
package's interop.

In the JAX package the adapter converts a torch stateful's tensors to
numpy on save and pours them back on restore. In the port a torch
stateful (``nn.Module``, an optimizer, anything with ``state_dict`` /
``load_state_dict``) already snapshots natively, so :class:`TorchStateful`
passes its state dict through; it exists so that code using the JAX
package's interop runs unchanged. :func:`torch_to_numpy_tree` and
:func:`numpy_to_torch_tree` convert trees bitwise, the latter in place
into a template's tensors, as the reference restores tensors in place.
"""

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

from ._torch_convert import numpy_to_torch_tensor, torch_tensor_to_numpy


def torch_to_numpy_tree(tree: Any) -> Any:
    """Every torch.Tensor leaf of ``tree`` as numpy, bitwise."""
    if isinstance(tree, torch.Tensor):
        return torch_tensor_to_numpy(tree)
    if isinstance(tree, OrderedDict):
        return OrderedDict((k, torch_to_numpy_tree(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: torch_to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(torch_to_numpy_tree(v) for v in tree)
    return tree


def numpy_to_torch_tree(tree: Any, template: Any = None, _path: str = "") -> Any:
    """Every numpy leaf of ``tree`` as a torch tensor.

    Where ``template`` (the in-memory torch state dict) holds a tensor,
    the value (numpy or a tensor) is written into it in place with
    ``Tensor.copy_``, which keeps its device, ``requires_grad`` and
    aliasing; a dtype or shape that differs raises rather than casts.
    Elsewhere numpy leaves become fresh CPU tensors."""
    if isinstance(template, torch.Tensor):
        if isinstance(tree, np.ndarray):
            tree = numpy_to_torch_tensor(tree)
        if not isinstance(tree, torch.Tensor):
            raise RuntimeError(
                f'"{_path}": template holds a torch.Tensor but the snapshot '
                f"value is a {type(tree).__name__}."
            )
        if tuple(template.shape) != tuple(tree.shape):
            raise RuntimeError(
                f'"{_path}": shape mismatch (snapshot {list(tree.shape)}, '
                f"template {list(template.shape)})."
            )
        if tree.dtype != template.dtype:
            raise RuntimeError(
                f'"{_path}": dtype mismatch (snapshot {tree.dtype}, '
                f"template {template.dtype}). Tensor.copy_ would silently "
                f"cast; cast the template instead — migration does not "
                f"silently convert."
            )
        if tree.data_ptr() == template.data_ptr() and tree.device == template.device:
            return template  # restored in place already
        with torch.no_grad():
            template.detach().copy_(tree)
        return template
    if isinstance(tree, np.ndarray):
        # Never leak numpy leaves into a tree handed to load_state_dict.
        return numpy_to_torch_tensor(tree)
    if isinstance(tree, OrderedDict):
        return OrderedDict(
            (k, numpy_to_torch_tree(v, _child(template, k), f"{_path}/{k}"))
            for k, v in tree.items()
        )
    if isinstance(tree, dict):
        return {
            k: numpy_to_torch_tree(v, _child(template, k), f"{_path}/{k}")
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            numpy_to_torch_tree(v, _child(template, i), f"{_path}/{i}")
            for i, v in enumerate(tree)
        )
    return tree


def _child(template: Any, key: Any) -> Any:
    if isinstance(template, dict):
        return template.get(key)
    if isinstance(template, (list, tuple)):
        return template[key] if isinstance(key, int) and key < len(template) else None
    return None


class TorchStateful:
    """Adapter placing a torch stateful into an app state::

        model = torch.nn.Linear(8, 4)
        Snapshot.take(path, {"model": TorchStateful(model)})
        ...
        Snapshot(path).restore({"model": TorchStateful(model)})  # in place

    The state dict passes through (the port snapshots tensors natively);
    restore writes every value into the stateful's own tensors in place,
    refusing a dtype or shape that differs, then calls its
    ``load_state_dict``."""

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def state_dict(self) -> Dict[str, Any]:
        return self.obj.state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        restored = numpy_to_torch_tree(state_dict, self.obj.state_dict())
        self.obj.load_state_dict(restored)
