"""Payload codecs of the content-addressed chunk store, in the JAX
package's format.

Each content chunk may pass through a codec between serialization (raw
little-endian payload bytes) and storage; the codec's name is recorded
per chunk in the manifest, and the read path decodes and verifies each
chunk as it lands.

- ``None`` / ``"identity"`` — stored bytes are the logical bytes.
- ``"zlib"`` — lossless deflate at level 1 (stdlib; always available).
- ``"zstd"`` — lossless zstandard framing, offered only where a backend
  imports (``compression.zstd`` on Python ≥ 3.14, else the
  ``zstandard`` package). The backend is looked up on first use, not at
  import; where neither imports, ``"zstd"`` is absent from
  :func:`lossless_codecs` and requesting it raises, so no snapshot ever
  records a codec this process cannot decode.
- ``"int8"`` — lossy blockwise affine uint8 quantization of float
  payloads (1024-element blocks, a min and a scale a block), in a
  self-verifying ``TSQ1`` frame. Opt-in only: it applies through an
  explicit per-leaf glob, never as the fallback rule.

Error contract of ``int8``: within each block of range ``r`` the absolute
error is at most ``r / 510`` plus the target dtype's own rounding;
:func:`quant_error_bound` computes it. A payload with non-finite values
raises :class:`CodecUnsuitable` and the caller stores it uncoded.

Float dtypes convert through torch (bfloat16 has no numpy dtype without
``ml_dtypes``); the conversions round to nearest even, as ``ml_dtypes``
does, so both packages write the same frames.
"""

import fnmatch
import functools
import logging
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

LOSSY_CODECS = ("int8",)

_QUANT_MAGIC = b"TSQ1"
_QUANT_BLOCK = 1024  # elements per scale block
_QUANT_LEVELS = 255  # uint8 codes 0..255
_QUANTIZABLE_DTYPES = ("float32", "float16", "bfloat16", "float64")

CODEC_ENV_VAR = "TPUSNAPSHOT_CODEC"


class CodecUnavailable(RuntimeError):
    """The named codec's backend is not importable in this process."""


class CodecUnsuitable(ValueError):
    """The payload cannot go through this codec (a non-float dtype for
    int8, non-finite values, …). Callers store it uncoded."""


@functools.lru_cache(maxsize=None)
def _zstd() -> Optional[Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]]:
    """(compress, decompress) of an importable zstd backend, or None."""
    try:
        from compression import zstd  # type: ignore  # Python >= 3.14

        return (lambda b: zstd.compress(bytes(b), 3)), (lambda b: zstd.decompress(bytes(b)))
    except ImportError:
        pass
    try:
        import zstandard  # type: ignore
    except ImportError:
        return None
    # Chunk payloads are bounded (TPUSNAPSHOT_CHUNK_BYTES), so the
    # decompressor's output cap is no resource hazard.
    return (
        lambda b: zstandard.ZstdCompressor(level=3).compress(bytes(b)),
        lambda b: zstandard.ZstdDecompressor().decompress(bytes(b), max_output_size=1 << 31),
    )


def lossless_codecs() -> Tuple[str, ...]:
    return ("zlib",) + (("zstd",) if _zstd() is not None else ())


def available_codecs() -> Tuple[str, ...]:
    return lossless_codecs() + LOSSY_CODECS


def is_lossy(name: Optional[str]) -> bool:
    return name in LOSSY_CODECS


def best_lossless() -> str:
    """The strongest lossless codec this process can encode and decode."""
    return "zstd" if _zstd() is not None else "zlib"


def check_codec(name: Optional[str]) -> None:
    if name is None:
        return
    if name == "zstd" and _zstd() is None:
        raise CodecUnavailable(
            'codec "zstd" needs the compression.zstd stdlib module '
            "(Python >= 3.14) or the zstandard package; neither is "
            'importable here. Use "zlib" or install a backend.'
        )
    if name not in available_codecs():
        raise ValueError(
            f"Unknown codec {name!r}. Available: {sorted(available_codecs())} "
            f"(zstd only when a backend is importable)."
        )


# ------------------------------------------------------------------ int8


def _to_float32(payload: Any, dtype_name: str) -> np.ndarray:
    if dtype_name == "bfloat16":
        raw = np.frombuffer(payload, dtype=np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).float().numpy()
    return np.frombuffer(payload, dtype=np.dtype(dtype_name)).astype(np.float32)


def _from_float32(x: np.ndarray, dtype_name: str) -> bytes:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    return x.astype(np.dtype(dtype_name)).tobytes()


# Half-ulp relative rounding of the dequantized value back into the
# target dtype: the second error term of the int8 contract.
_DTYPE_ROUND_EPS = {
    "float64": 2.0**-52,
    "float32": 2.0**-23,
    "float16": 2.0**-11,
    "bfloat16": 2.0**-8,
}


def quant_error_bound(arr: Any, dtype_name: str = "float32") -> float:
    """The documented per-element absolute error bound of ``int8`` over
    ``arr`` restored as ``dtype_name``: the largest block range / 510,
    plus the target dtype's half-ulp rounding of the dequantized value."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    flat = np.asarray(arr, dtype=np.float32).reshape(-1)
    pad = (-flat.shape[0]) % _QUANT_BLOCK
    if pad:
        flat = np.concatenate([flat, np.repeat(flat[-1:], pad)])
    blocks = flat.reshape(-1, _QUANT_BLOCK)
    r = (blocks.max(axis=1) - blocks.min(axis=1)).max()
    scale = float(r) / (2 * _QUANT_LEVELS)
    eps = _DTYPE_ROUND_EPS.get(dtype_name, 2.0**-8)
    return scale * (1.0 + 1e-5) + 1e-6 + float(np.abs(flat).max() + 2 * scale) * eps


def _quant_encode(payload: Any, dtype_name: str) -> bytes:
    if dtype_name not in _QUANTIZABLE_DTYPES:
        raise CodecUnsuitable(
            f'codec "int8" quantizes float payloads only; dtype {dtype_name!r} '
            f"is not quantizable"
        )
    x = _to_float32(payload, dtype_name)
    if x.size == 0:
        raise CodecUnsuitable("empty payload")
    if not np.isfinite(x).all():
        # A non-finite block range would decode garbage for every
        # element of the block.
        raise CodecUnsuitable("payload contains non-finite values")
    n = x.shape[0]
    pad = (-n) % _QUANT_BLOCK
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad)])
    blocks = x.reshape(-1, _QUANT_BLOCK)
    mins = blocks.min(axis=1)
    ranges = blocks.max(axis=1) - mins
    scales = ranges / np.float32(_QUANT_LEVELS)
    safe = np.where(scales > 0, scales, np.float32(1.0))
    q = np.clip(np.rint((blocks - mins[:, None]) / safe[:, None]), 0, _QUANT_LEVELS).astype(np.uint8)
    name = dtype_name.encode()
    side = np.stack([mins.astype(np.float32), scales.astype(np.float32)], axis=1).tobytes()
    body = side + q.reshape(-1)[:n].tobytes()
    # The frame carries its own body crc: a chunk referenced by a later
    # take has no checksum in that take's manifest, and a lossy decode
    # cannot be checked against the content key.
    header = (
        _QUANT_MAGIC
        + struct.pack("<BIQI", len(name), _QUANT_BLOCK, n, zlib.crc32(body) & 0xFFFFFFFF)
        + name
    )
    return header + body


def _quant_decode(payload: Any) -> bytes:
    buf = bytes(payload)
    if buf[:4] != _QUANT_MAGIC:
        raise RuntimeError(
            'stored chunk claims codec "int8" but carries no TSQ1 frame: '
            "corrupt object or codec mismatch"
        )
    name_len, block, n, crc = struct.unpack_from("<BIQI", buf, 4)
    off = 4 + struct.calcsize("<BIQI")
    dtype_name = buf[off : off + name_len].decode()
    off += name_len
    if zlib.crc32(buf[off:]) & 0xFFFFFFFF != crc:
        raise RuntimeError("int8 chunk frame is corrupt (body crc mismatch)")
    if dtype_name not in _QUANTIZABLE_DTYPES:
        raise RuntimeError(f"int8 chunk frame names dtype {dtype_name!r}")
    n_blocks = (n + block - 1) // block
    side = np.frombuffer(buf, dtype=np.float32, count=2 * n_blocks, offset=off)
    off += side.nbytes
    mins = side.reshape(-1, 2)[:, 0]
    scales = side.reshape(-1, 2)[:, 1]
    q = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off).astype(np.float32)
    pad = (-n) % block
    if pad:
        q = np.concatenate([q, np.zeros((pad,), np.float32)])
    x = q.reshape(-1, block) * scales[:, None] + mins[:, None]
    return _from_float32(x.reshape(-1)[:n], dtype_name)


# ------------------------------------------------------------ encode/decode


def encode(name: Optional[str], payload: Any, dtype_name: Optional[str] = None) -> bytes:
    """Encode a logical payload through ``name``; ``dtype_name`` is
    needed by ``int8``. Raises :class:`CodecUnsuitable` when the payload
    cannot go through."""
    if name is None or name == "identity":
        return bytes(payload)
    if name == "zlib":
        return zlib.compress(payload, level=1)
    if name == "zstd":
        check_codec("zstd")
        return _zstd()[0](payload)
    if name == "int8":
        if dtype_name is None:
            raise CodecUnsuitable('codec "int8" needs the payload dtype')
        return _quant_encode(payload, dtype_name)
    raise ValueError(f"Unknown codec {name!r}")


def decode(name: Optional[str], payload: Any, dtype_name: Optional[str] = None) -> bytes:
    if name is None or name == "identity":
        return bytes(payload)
    if name == "zlib":
        return zlib.decompress(payload)
    if name == "zstd":
        if _zstd() is None:
            raise CodecUnavailable(
                'this snapshot stores "zstd"-coded chunks but no zstd backend '
                "is importable here (compression.zstd or the zstandard "
                "package); install one to restore"
            )
        return _zstd()[1](payload)
    if name == "int8":
        return _quant_decode(payload)
    raise ValueError(f"Unknown codec {name!r}")


# -------------------------------------------------------------- codec plans


CodecSpec = Union[None, str, Dict[str, Optional[str]]]


class CodecPlan:
    """Ordered (glob, codec) rules mapping leaf logical paths to chunk
    codecs; the first matching glob wins, ``"*"`` is the fallback. A
    lossy rule that matches a leaf it cannot quantize (PRNG key data, a
    non-float dtype) falls through to the rules after it."""

    def __init__(self, rules: Sequence[Tuple[str, Optional[str]]]):
        self.rules: List[Tuple[str, Optional[str]]] = list(rules)

    def codec_for(
        self,
        logical_path: str,
        dtype_name: Optional[str] = None,
        prng_impl: Optional[str] = None,
    ) -> Optional[str]:
        for glob, codec in self.rules:
            if glob == "*" or fnmatch.fnmatch(logical_path, glob):
                if is_lossy(codec) and (
                    prng_impl is not None
                    or (dtype_name is not None and dtype_name not in _QUANTIZABLE_DTYPES)
                ):
                    logger.warning(
                        f'codec "int8" matched {logical_path!r} but the leaf is '
                        f"not quantizable (dtype {dtype_name!r}, prng="
                        f"{prng_impl!r}); trying the remaining codec rules"
                    )
                    continue
                return codec
        return None

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, CodecPlan) and self.rules == other.rules


def _normalize_name(raw: str) -> Optional[str]:
    name = raw.strip().lower()
    if name in ("", "none", "identity", "raw"):
        return None
    return name


def resolve_codec_plan(spec: CodecSpec) -> CodecPlan:
    """A :class:`CodecPlan` from a take's ``codec=`` argument::

        None                          -> TPUSNAPSHOT_CODEC (or identity)
        "zstd"                        -> every chunked leaf
        {"opt/**": "int8", "*": "zstd"}
        "opt/**=int8,*=zstd"          -> the env-var string form

    Every named codec is validated here, at take time; a lossy fallback
    rule raises."""
    if spec is None:
        spec = os.environ.get(CODEC_ENV_VAR) or None
    if spec is None:
        return CodecPlan([])
    if isinstance(spec, str) and ("=" in spec or "," in spec):
        parsed: Dict[str, Optional[str]] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                glob, _, name = part.partition("=")
                parsed[glob.strip()] = _normalize_name(name)
            else:
                parsed["*"] = _normalize_name(part)
        spec = parsed
    if isinstance(spec, str):
        spec = {"*": _normalize_name(spec)}
    if not isinstance(spec, dict):
        raise ValueError(
            f"codec spec must be a codec name or a {{glob: codec}} mapping; "
            f"got {type(spec).__name__}"
        )
    # Specific globs in the caller's order, the "*" fallback last.
    items = [(g, c) for g, c in spec.items() if g != "*"]
    if "*" in spec:
        items.append(("*", spec["*"]))
    rules: List[Tuple[str, Optional[str]]] = []
    for glob, name in items:
        codec = _normalize_name(name) if isinstance(name, str) else name
        check_codec(codec)
        if is_lossy(codec) and glob == "*":
            raise ValueError(
                f"lossy codec {codec!r} requires an explicit per-leaf glob "
                f'(e.g. {{"opt/**": "{codec}"}}); refusing to quantize every '
                f"leaf by default"
            )
        rules.append((glob, codec))
    return CodecPlan(rules)
