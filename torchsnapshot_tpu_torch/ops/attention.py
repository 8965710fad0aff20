"""Flash attention forward and backward: hand-written CUDA kernels and
their plain versions.

``flash_attention(q, k, v, causal)`` computes softmax(QKᵀ/√D)·V for
``[B, H, S, D]`` tensors without materialising the S×S score matrix, and
is differentiable. On a CUDA tensor the forward launches
``csrc/flash_fwd.cu``, the Hopper port of the JAX package's Pallas kernel
``_flash_kernel`` (``torchsnapshot_tpu/ops/attention.py``), and the
backward launches the two kernels of ``csrc/flash_bwd.cu``, the ports of
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``.
``flash_attention_with_lse`` also returns the per-row log-sum-exp, as
``flash_chunk_attention`` does; a cotangent of the lse folds into the
backward's ``delta``.

- On a CPU tensor the wrappers compute :func:`flash_attention_reference`
  and :func:`flash_attention_backward_reference`, the plain f32 versions
  of the same functions; the tests compare them with the JAX kernels run
  in interpret mode, and ``chip_smoke.py`` compares the CUDA kernels with
  them on the card.
- On a CUDA tensor the wrappers launch the kernels or raise. There is no
  fallback to the plain versions.
- ``flash_forward_launches``, ``flash_bwd_dq_launches`` and
  ``flash_bwd_dkv_launches`` count kernel launches (never plain calls),
  so a run can show that its passes went through the kernels.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils.env import env_int
from . import build

_NEG_INF = -1e30

# Kernel launches by the CUDA wrappers in this process.
flash_forward_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

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


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the flash kernels take float32, bfloat16 or float16; got {q.dtype}"
        )
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(
            f"the flash kernels take head_dim <= {_MAX_HEAD_DIM}; got {q.shape[-1]}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernels take contiguous q, k and v")


def _kernel_fn(library: str, name: str, n_pointers: int):
    """The C entry point ``name`` of ``csrc/<library>.cu``: ``n_pointers``
    tensor pointers, then b, hq, hkv, s, d, dtype, causal, scale, stream."""
    fn = getattr(build.load_library(library), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7 + [
        ctypes.c_float,
        ctypes.c_void_p,
    ]
    return fn


def _padded_width(d: int, dtype: torch.dtype) -> int:
    """``d`` rounded up so that a row of ``dtype`` is a multiple of 16
    bytes: the kernels copy rows in 16-byte pieces."""
    per_copy = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-d // per_copy) * per_copy


def _kernel_operand(x: torch.Tensor, dtype: torch.dtype, width: int) -> torch.Tensor:
    """``x`` as the kernels read it: ``dtype``, contiguous,
    16-byte aligned, zero-padded to ``width`` along its last axis."""
    x = x.to(dtype)
    if x.shape[-1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _forward_kernel_call(q, k, v, causal):
    """The forward kernel bound to its inputs and to fresh outputs, as
    ``_launch_flash_forward`` launches it: (call, (out, lse)). The call
    returns the launch's cudaError_t and counts nothing; ``out`` is
    ``[B, Hq, S, W]`` in q's dtype and ``lse`` ``[B, Hq, S, 1]`` f32, valid
    after the call ran, where W >= D is the head_dim zero-padded to rows
    of 16 bytes. The scale stays that of the true D."""
    _check_kernel_inputs(q, k, v)
    b, hq, s, d = q.shape
    width = _padded_width(d, q.dtype)
    q, k, v = (_kernel_operand(x, q.dtype, width) for x in (q, k, v))
    out = torch.empty((b, hq, s, width), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    fn = _kernel_fn("flash_fwd", "flash_fwd", 5)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, hq, k.shape[1], s, width, _DTYPE_CODES[q.dtype], int(bool(causal)),
            1.0 / (d**0.5))
    held = (q, k, v)  # the pointers above stay valid

    def call(held=held):
        return fn(*args, torch.cuda.current_stream(out.device).cuda_stream)

    return call, (out, lse)


def _launch_flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    global flash_forward_launches
    call, (out, lse) = _forward_kernel_call(q, k, v, causal)
    with torch.cuda.device(q.device):
        err = call()
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    flash_forward_launches += 1
    d = q.shape[-1]
    if out.shape[-1] != d:
        out = out[..., :d].contiguous()
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


def _group_sum(x: torch.Tensor, group: int) -> torch.Tensor:
    """Per-q-head ``[B, Hq, S, D]`` partials summed into their kv-heads."""
    if group == 1:
        return x
    b, hq, s, d = x.shape
    return x.view(b, hq // group, group, s, d).sum(dim=2)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    delta: Optional[torch.Tensor],
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernels: the full f32
    p = exp(s − lse) matrix (0 in rows whose lse is the -1e30 sentinel and
    at causally masked pairs), dP = dO·Vᵀ, ds = p·(dP − delta) and the
    three products, GQA by repeating K/V and summing each group of
    per-q-head dk/dv. ``delta`` is rowsum(dO·O) − dlse ``[B,Hq,S,1]``;
    None computes rowsum(dO·O) from ``out``. Returns f32 (dq, dk, dv)."""
    group = _check_inputs(q, k, v)
    b, hq, s, d = q.shape
    scale = 1.0 / (d**0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    do = d_out.float()
    if delta is None:
        delta = (do * out.float()).sum(dim=-1, keepdim=True)
    delta = delta.float().reshape(b, hq, s, 1)
    lse = lse.float().reshape(b, hq, s, 1)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    lse_safe = lse.clamp(min=_NEG_INF / 2)
    p = torch.where(lse > _NEG_INF / 2, torch.exp(scores - lse_safe), 0.0)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = torch.where(mask, p, 0.0)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), do)
    return dq, _group_sum(dk, group), _group_sum(dv, group)


def _backward_kernel_calls(q, k, v, d_out, lse, delta, causal):
    """The two backward kernels bound to their inputs and to fresh f32
    outputs, as ``_launch_flash_backward`` launches them: (dq call, dkv
    call, (dq, dk, dv)). Each call returns the launch's cudaError_t and
    counts nothing; the outputs are ``[B, Hq, S, W]`` for dq and
    ``[B, Hkv, S, W]`` for dk and dv, valid after both calls ran, where
    W >= D is the kernels' padded head_dim (see below).

    The kernels read dO in q's dtype, as every autograd call hands it
    over. A dO of another dtype is not rounded into q's: the kernels then
    run in f32 on exact upcasts of all four operands. The kernels copy
    rows in 16-byte pieces, so a head_dim whose rows are not a multiple of
    16 bytes is zero-padded and the padding cut from the outputs."""
    _check_kernel_inputs(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d_out.shape != q.shape or lse.numel() != b * hq * s or delta.numel() != b * hq * s:
        raise ValueError(
            f"d_out must be {tuple(q.shape)} and lse, delta [B, Hq, S, 1]; got "
            f"{tuple(d_out.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}"
        )
    dtype = q.dtype if d_out.dtype == q.dtype else torch.float32
    width = _padded_width(d, dtype)
    q, k, v, d_out = (_kernel_operand(x, dtype, width) for x in (q, k, v, d_out))
    lse, delta = (_kernel_operand(x.reshape(b, hq, s), torch.float32, s) for x in (lse, delta))
    dq = torch.empty((b, hq, s, width), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, hkv, s, width), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    shape = (b, hq, hkv, s, width, _DTYPE_CODES[dtype], int(bool(causal)), 1.0 / (d**0.5))
    dq_fn = _kernel_fn("flash_bwd", "flash_bwd_dq", 7)
    dkv_fn = _kernel_fn("flash_bwd", "flash_bwd_dkv", 8)
    held = (q, k, v, d_out, lse, delta)  # the pointers above stay valid

    def stream():
        return torch.cuda.current_stream(dq.device).cuda_stream

    def dq_call(held=held):
        return dq_fn(*inputs, dq.data_ptr(), *shape, stream())

    def dkv_call(held=held):
        return dkv_fn(*inputs, dk.data_ptr(), dv.data_ptr(), *shape, stream())

    return dq_call, dkv_call, (dq, dk, dv)


def _launch_flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    dq_call, dkv_call, grads = _backward_kernel_calls(q, k, v, d_out, lse, delta, causal)
    with torch.cuda.device(q.device):
        err = dq_call()
        if err != 0:
            raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError_t {err}")
        flash_bwd_dq_launches += 1
        err = dkv_call()
        if err != 0:
            raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError_t {err}")
        flash_bwd_dkv_launches += 1
    d = q.shape[-1]
    if grads[0].shape[-1] != d:
        grads = tuple(g[..., :d].contiguous() for g in grads)
    return grads


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    d_lse: Optional[torch.Tensor],
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 (dq, dk, dv) of flash attention from the forward's ``out`` and
    ``lse`` and the cotangents of both (``d_lse`` None counts as zero):
    delta = rowsum(dO·O) − dlse, as ``_flash_chunk_bwd`` folds it."""
    _check_inputs(q, k, v)
    delta = (d_out.float() * out.float()).sum(dim=-1, keepdim=True)
    if d_lse is not None:
        delta = delta - d_lse.float().reshape(delta.shape)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, d_out, delta, causal
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return _launch_flash_backward(q, k, v, d_out, lse, delta, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if grad_out is None:
            grad_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, grad_out, grad_lse, ctx.causal
        )
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


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
