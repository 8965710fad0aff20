"""Bitwise torch.Tensor ⇄ numpy conversion, bfloat16 and float8 included,
and the reference manifest's dtype names.

numpy has no native bfloat16 or float8, and torch refuses
``Tensor.numpy()`` on them. Both directions reinterpret the payload
through a same-width integer view (``torch.bfloat16`` ⇄ ``int16`` bits ⇄
``ml_dtypes.bfloat16``), exact by construction. ``ml_dtypes`` is needed
only where a numpy array of such a dtype is asked for, and is imported
there: the port itself never needs it (the machine with the card has
none).
"""

from typing import Any

import numpy as np
import torch

from ..serialization import dtype_to_str

# torch dtypes without a numpy equivalent -> same-width integer dtype.
_VIA_BITS = {
    torch.bfloat16: torch.int16,
    torch.float8_e4m3fn: torch.int8,
    torch.float8_e5m2: torch.int8,
}


def _ml_dtypes() -> Any:
    try:
        import ml_dtypes
    except ImportError:
        raise RuntimeError(
            "a numpy array of bfloat16 or float8 needs ml_dtypes, which is not "
            "installed; keep the value as a torch tensor instead"
        ) from None
    return ml_dtypes


def torch_tensor_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A bitwise-exact host numpy copy of a tensor on any device."""
    t = tensor.detach().cpu().contiguous()
    if t.dtype in _VIA_BITS:
        bits = t.view(_VIA_BITS[t.dtype]).numpy()
        return bits.view(np.dtype(getattr(_ml_dtypes(), dtype_to_str(t.dtype)))).copy()
    return t.numpy().copy()


def numpy_to_torch_tensor(arr: np.ndarray) -> torch.Tensor:
    """A bitwise-exact CPU tensor of a numpy array (an ``ml_dtypes``
    bfloat16 or float8 array by its bits, without importing ml_dtypes)."""
    # A C-order copy is contiguous and, unlike np.ascontiguousarray,
    # keeps 0-d shapes.
    arr = np.asarray(arr).copy(order="C")
    for torch_dtype, int_dtype in _VIA_BITS.items():
        if arr.dtype.name == dtype_to_str(torch_dtype):
            bits = arr.view(np.dtype(str(int_dtype).split(".", 1)[1]))
            return torch.from_numpy(bits).view(torch_dtype)
    return torch.from_numpy(arr)


def torch_dtype_from_name(name: str) -> torch.dtype:
    """The torch dtype of a reference manifest's dtype string
    (``"torch.float32"``; aliases such as ``"torch.float"`` too)."""
    dtype = getattr(torch, name.split(".", 1)[-1], None)
    if not isinstance(dtype, torch.dtype):
        raise RuntimeError(f"Unknown reference dtype name {name!r}")
    return dtype
