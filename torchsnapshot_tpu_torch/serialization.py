"""Array and object (de)serialization, shared on-disk format.

Arrays persist as **raw little-endian C-order payload bytes**; dtype and
shape live in the manifest entry, so a payload is pure data. The dtype
names are the canonical ``np.dtype(...).name`` strings the JAX package
writes (``float32``, ``bfloat16``, ``float8_e4m3fn``, ``bool``, …). This
module maps them to torch dtypes with its own table, so neither
``ml_dtypes`` nor a numpy dtype is needed for bfloat16 or float8 — a
tensor is staged as its raw bytes (``t.view(torch.uint8)``).

Objects (non-array leaves) use pickle protocol 4. Payload integrity tags
are ``crc32:<hex>``, as in the JAX package. ``compression="zlib"``
deflates a stored payload at level 1; the checksum then covers the
compressed bytes, and the entry records the algorithm.
"""

import pickle
import sys
import zlib
from typing import Any, Optional

import numpy as np
import torch

ARRAY_SERIALIZER = "raw"
OBJECT_SERIALIZER = "pickle"

if sys.byteorder != "little":  # pragma: no cover
    raise ImportError("the raw payload format assumes a little-endian host")

# Canonical name -> torch dtype. The names are np.dtype(...).name of the
# numpy / ml_dtypes type the JAX package records for the same data.
_NAME_TO_TORCH = {
    name: getattr(torch, attr)
    for name, attr in (
        ("float64", "float64"),
        ("float32", "float32"),
        ("float16", "float16"),
        ("bfloat16", "bfloat16"),
        ("float8_e4m3fn", "float8_e4m3fn"),
        ("float8_e5m2", "float8_e5m2"),
        ("float8_e4m3fnuz", "float8_e4m3fnuz"),
        ("float8_e5m2fnuz", "float8_e5m2fnuz"),
        ("float8_e8m0fnu", "float8_e8m0fnu"),
        ("int64", "int64"),
        ("int32", "int32"),
        ("int16", "int16"),
        ("int8", "int8"),
        ("uint64", "uint64"),
        ("uint32", "uint32"),
        ("uint16", "uint16"),
        ("uint8", "uint8"),
        ("bool", "bool"),
        ("complex64", "complex64"),
        ("complex128", "complex128"),
    )
    if hasattr(torch, attr)
}
_TORCH_TO_NAME = {dt: name for name, dt in _NAME_TO_TORCH.items()}

# ml_dtypes types with no torch dtype of the same bytes, each one byte an
# element: they restore as their raw bytes, as uint8 (int4 and uint4
# keep the value in the low nibble; torch's int4/uint4 are placeholders
# without conversions, and float4_e2m1fn_x2 packs two to a byte).
_RAW_BYTE_NAMES = ("int4", "uint4", "float4_e2m1fn", "float8_e4m3b11fnuz")


def dtype_to_str(dtype: Any) -> str:
    """Canonical dtype name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_NAME[dtype]
        except KeyError:
            raise TypeError(f"{dtype} has no canonical snapshot name") from None
    return np.dtype(dtype).name


def str_to_torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a stored array of dtype ``name`` restores as:
    ``uint8`` (its raw bytes) for the names of ``_RAW_BYTE_NAMES``."""
    if name in _RAW_BYTE_NAMES:
        return torch.uint8
    try:
        return _NAME_TO_TORCH[name]
    except KeyError:
        raise TypeError(f"Unknown dtype name: {name}") from None


def dtype_itemsize(name: str) -> int:
    return str_to_torch_dtype(name).itemsize


def array_nbytes(dtype_name: str, shape: Any) -> int:
    """Bytes of an uncompressed stored array of this dtype and shape."""
    n = dtype_itemsize(dtype_name)
    for dim in shape:
        n *= int(dim)
    return n


def tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """The C-order payload bytes of ``t`` as a flat uint8 tensor on
    ``t``'s device: a view when ``t`` is contiguous, else a copy (0-d and
    non-contiguous tensors alike write C-order bytes)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def object_to_bytes(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=4)


def bytes_to_object(buf: Any) -> Any:
    return pickle.loads(buf)


_COMPRESSION_LEVELS = {"zlib": 1}  # level 1: several times faster than the
# default, within a few percent of its ratio on float payloads.


def check_compression(algo: Optional[str]) -> None:
    if algo is not None and algo not in _COMPRESSION_LEVELS:
        raise ValueError(
            f'Unknown compression algorithm "{algo}". '
            f"Supported: {sorted(_COMPRESSION_LEVELS)}."
        )


def compress_payload(buf: Any, algo: str) -> bytes:
    """Losslessly compress a stored payload (opt-in: trained float
    weights barely compress; cold embedding rows and integer state do)."""
    check_compression(algo)
    return zlib.compress(buf, level=_COMPRESSION_LEVELS[algo])


def decompress_payload(buf: Any, algo: str) -> bytes:
    check_compression(algo)
    return zlib.decompress(buf)


def compute_checksum(buf: Any) -> str:
    """crc32 of a payload, tagged with the algorithm. zlib.crc32 releases
    the GIL on large buffers, so it runs in parallel across the staging
    threads."""
    return f"crc32:{zlib.crc32(buf) & 0xFFFFFFFF:08x}"


def verify_checksum(buf: Any, expected: Optional[str]) -> None:
    """Raise if ``buf`` does not match ``expected`` (no-op when expected is
    None or the algorithm is unknown — forward compatibility)."""
    if not expected or not expected.startswith("crc32:"):
        return
    actual = compute_checksum(buf)
    if actual != expected:
        raise RuntimeError(
            f"Checksum mismatch: stored object is corrupt "
            f"(expected {expected}, got {actual})."
        )


class StreamingCrc32:
    """Incremental crc32 producing the same ``crc32:<hex>`` tag as
    :func:`compute_checksum`, for verifying a payload piece by piece in
    stream order."""

    def __init__(self) -> None:
        self._crc = 0

    def update(self, chunk: Any) -> None:
        self._crc = zlib.crc32(chunk, self._crc)

    def tag(self) -> str:
        return f"crc32:{self._crc & 0xFFFFFFFF:08x}"
