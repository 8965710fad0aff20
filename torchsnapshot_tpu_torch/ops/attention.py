"""Flash attention forward: a hand-written CUDA kernel and its plain version.

``flash_attention(q, k, v, causal)`` computes softmax(QKᵀ/√D)·V for
``[B, H, S, D]`` tensors without materialising the S×S score matrix; on a
CUDA tensor it launches ``csrc/flash_fwd.cu``, the Hopper port of the JAX
package's Pallas kernel ``_flash_kernel``
(``torchsnapshot_tpu/ops/attention.py``). ``flash_attention_with_lse``
also returns the per-row log-sum-exp, as ``flash_chunk_attention`` does.

- On a CPU tensor the wrapper computes :func:`flash_attention_reference`,
  the plain f32 version of the same function; the tests compare it with
  the JAX kernel run in interpret mode, and ``chip_smoke.py`` compares the
  CUDA kernel with it on the card.
- On a CUDA tensor the wrapper launches the kernel or raises. There is no
  fallback to the plain version.
- ``flash_forward_launches`` counts kernel launches (never plain calls),
  so a run can show that its forward passes went through the kernel.

The forward is a ``torch.autograd.Function`` whose backward raises: the
backward kernels (the JAX package's ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``) are not ported yet.
"""

import ctypes
import math
from typing import Tuple

import torch

from ..utils.env import env_int
from . import build

_NEG_INF = -1e30

# Kernel launches by the CUDA wrapper in this process.
flash_forward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 128


def resolve_flash_block(seq_len: int) -> int:
    """The JAX package's admission policy for flash attention, kept so
    both packages accept and reject the same sequence lengths: the
    largest power-of-two divisor of ``seq_len``, capped at
    ``TPUSNAPSHOT_FLASH_BLOCK_CAP`` (default 1024), must be at least 8.

    The CUDA kernel itself tiles by 64 rows and masks a ragged last tile,
    so on the card the value only gates admission."""
    block = math.gcd(seq_len, env_int("TPUSNAPSHOT_FLASH_BLOCK_CAP", 1024))
    if block < 8:
        raise ValueError(
            f"flash attention needs a sequence length with a power-of-two "
            f"factor >= 8; {seq_len} tiles at {block} rows. Pad the "
            f"sequence or use the einsum path."
        )
    return block


def _gqa_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per key/value head: q-head h reads kv-head h // group."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(
            f"query heads ({hq}) must be a multiple of kv heads ({hkv})"
        )
    return hq // hkv


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, S, D] tensors")
    group = _gqa_group(q, k)
    b, hq, s, d = q.shape
    if tuple(k.shape) != (b, hq // group, s, d) or k.shape != v.shape:
        raise ValueError(
            f"k and v must be [B, Hkv, S, D] = {(b, hq // group, s, d)}; "
            f"got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return group


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: the full f32 score matrix, the
    -1e30 mask, max, exp and sum, GQA by repeating K/V. Returns
    (out ``[B,Hq,S,D]`` in the input dtype, lse ``[B,Hq,S,1]`` f32)."""
    group = _check_inputs(q, k, v)
    d = q.shape[-1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / (d**0.5))
    if causal:
        length = q.shape[2]
        mask = torch.ones(length, length, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (torch.matmul(p, vf) / denom).to(q.dtype)
    return out, m + torch.log(denom)


def _launch_flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    global flash_forward_launches
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the flash kernel takes float32, bfloat16 or float16; got {q.dtype}"
        )
    b, hq, s, d = q.shape
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim <= {_MAX_HEAD_DIM}; got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous q, k and v")
    lib = build.load_library("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float,
        ctypes.c_void_p,
    ]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], s, d, _DTYPE_CODES[q.dtype],
            int(bool(causal)), 1.0 / (d**0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    flash_forward_launches += 1
    return out, lse


def _flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return _launch_flash_forward(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        raise NotImplementedError(
            "The flash attention backward is not ported yet: it needs the "
            "Hopper ports of _flash_bwd_dq_kernel (K2) and "
            "_flash_bwd_dkv_kernel (K3), planned for slice S4."
        )


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B,Hq,S,D]`` in q's dtype, lse ``[B,Hq,S,1]`` f32)."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """softmax(QKᵀ/√D)·V without materialising the S×S score matrix."""
    return flash_attention_with_lse(q, k, v, causal)[0]
