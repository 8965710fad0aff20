"""The port's flash attention against the JAX package's Pallas kernels,
forward and backward.

On the CPU the port's wrappers compute the plain versions
(``flash_attention_reference``, ``flash_attention_backward_reference``);
here they are held against the JAX kernels run in interpret mode on the
same numpy inputs, at tiny grids (the JAX kernels' own tests are marked
slow for interpret-mode cost). The CUDA kernels themselves are compared
with the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import LSE_TOL, OUT_TOL
from torchsnapshot_tpu.ops import attention as jattn
from torchsnapshot_tpu_torch.ops import attention as tattn

# The tolerance tests/test_flash_attention.py holds the kernel to against
# its einsum spec: both sides accumulate in f32, in different orders.
F32_TOL = dict(atol=2e-5, rtol=1e-5)


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, causal, with_lse=False):
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if with_lse:
        out, lse = jattn.flash_chunk_attention(*args, causal, 32, 32, True)
        return np.asarray(out.astype(jnp.float32)), np.asarray(lse)
    out = jattn.flash_attention(*args, causal=causal, block_q=32, block_k=32, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_plain_version_matches_jax_kernel(causal, heads):
    hq, hkv = heads
    q, k, v = _qkv(1, hq, hkv, 64, 16, seed=hq + causal)
    expected_out, expected_lse = _jax_flash(q, k, v, causal, with_lse=True)
    out, lse = tattn.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal
    )
    assert out.dtype == torch.float32 and lse.shape == (1, hq, 64, 1)
    np.testing.assert_allclose(out.numpy(), expected_out, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), expected_lse, **F32_TOL)


def test_plain_version_matches_jax_kernel_bf16():
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in _qkv(1, 2, 2, 64, 16, seed=7))
    expected = _jax_flash(q, k, v, causal=True)

    out, _ = tattn.flash_attention_reference(_bf16(q), _bf16(k), _bf16(v), True)
    assert out.dtype == torch.bfloat16
    # Both round the same f32 result to bf16; f32 sums in different orders
    # may round to neighbouring bf16 values: one bf16 ulp (2^-8 relative).
    np.testing.assert_allclose(out.float().numpy(), expected, atol=1e-2, rtol=8e-3)


def test_wrapper_on_cpu_uses_plain_version_without_launching(monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 48, 8, seed=3))
    monkeypatch.setattr(tattn, "flash_forward_launches", 0)
    out = tattn.flash_attention(q, k, v, causal=True)
    out2, lse = tattn.flash_attention_with_lse(q, k, v, causal=True)
    ref, ref_lse = tattn.flash_attention_reference(q, k, v, True)
    assert torch.equal(out, ref) and torch.equal(out2, ref) and torch.equal(lse, ref_lse)
    assert tattn.flash_forward_launches == 0


@pytest.mark.parametrize("seq_len", [3, 4, 12, 20, 8, 24, 1000, 1024, 2048, 4096])
def test_resolve_flash_block_matches_jax(seq_len):
    try:
        expected = jattn.resolve_flash_block(seq_len)
    except ValueError:
        with pytest.raises(ValueError, match="power-of-two factor"):
            tattn.resolve_flash_block(seq_len)
    else:
        assert tattn.resolve_flash_block(seq_len) == expected


def _bf16(x):
    return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_plain_backward_matches_jax_kernels(causal, heads, dtype):
    hq, hkv = heads
    q, k, v = _qkv(1, hq, hkv, 64, 16, seed=10 + hq + causal)
    rng = np.random.default_rng(20 + hq)
    g = rng.standard_normal((1, hq, 64, 16)).astype(np.float32)
    if dtype == "bf16":
        q, k, v, g = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jattn.flash_chunk_attention(jq, jk, jv, causal, 32, 32, True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1, keepdims=True)
    expected = jattn._flash_backward(jq, jk, jv, jg, lse, delta, causal, 32, 32, True)
    to_torch = _bf16 if dtype == "bf16" else torch.from_numpy
    got = tattn.flash_attention_backward_reference(
        to_torch(q), to_torch(k), to_torch(v), None, torch.from_numpy(np.array(lse)),
        to_torch(g), torch.from_numpy(np.array(delta)), causal,
    )
    # Both compute in f32 from the same (bf16-exact) inputs, summing in
    # other orders: the f32 tolerance, relative to each gradient's size.
    for name, t, e in zip("qkv", got, expected):
        e = np.asarray(e)
        assert t.dtype == torch.float32 and t.shape == e.shape, name
        np.testing.assert_allclose(
            t.numpy(), e, atol=F32_TOL["atol"] * max(1.0, float(np.abs(e).max())),
            rtol=F32_TOL["rtol"], err_msg=f"d{name}",
        )


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, on the low 13 mantissa bits of the int32 view."""
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the backward kernels take an f32 product on the tensor
    cores: each operand split into tf32 hi + lo, and hi·hi + hi·lo + lo·hi
    summed in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _mm_split16(p, b, dtype):
    """p @ b as the 16-bit kernels take it: f32 p split into hi + lo terms
    of the input type, b exact in it; two products summed in f32."""
    hi = p.to(dtype).float()
    lo = (p - hi).to(dtype).float()
    return lo @ b + hi @ b


def _emulated_kernel_backward(q, k, v, lse, d_out, delta, causal):
    """flash_attention_backward_reference with the CUDA kernels' operand
    rounding: 3xTF32 for every f32 product; for 16-bit inputs, exact
    Q·Kᵀ and dO·Vᵀ and two-term splits of p and ds."""
    group = q.shape[1] // k.shape[1]
    b, hq, s, d = q.shape
    scale = 1.0 / d**0.5
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    do = d_out.float()
    if q.dtype == torch.float32:
        plain = rounded = _mm_3xtf32
    else:
        plain = torch.matmul

        def rounded(p, x):
            return _mm_split16(p, x, q.dtype)

    lse = lse.float().reshape(b, hq, s, 1)
    p = torch.exp(plain(qf, kf.transpose(-1, -2)) * scale - lse.clamp(min=-5e29))
    p = torch.where(lse > -5e29, p, 0.0)
    if causal:
        p = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (plain(do, vf.transpose(-1, -2)) - delta.float().reshape(b, hq, s, 1))
    dq = scale * rounded(ds, kf)
    dk = scale * rounded(ds.transpose(-1, -2), qf)
    dv = rounded(p.transpose(-1, -2), do)
    return dq, tattn._group_sum(dk, group), tattn._group_sum(dv, group)


def _emulated_kernel_forward(q, k, v, causal):
    """flash_attention_reference with the forward kernel's operand
    rounding: 3xTF32 for Q·Kᵀ and P·V in f32; for 16-bit inputs, exact
    Q·Kᵀ and p split into hi + lo terms of the input type for P·V; exp
    taken as 2^x of x = (s − m)·log2 e rounded to f32, as the kernel's
    ex2. The softmax is taken over whole rows here, online over key tiles
    in the kernel: both f32, in other orders."""
    group = q.shape[1] // k.shape[1]
    s, d = q.shape[2], q.shape[3]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    if q.dtype == torch.float32:
        scores = _mm_3xtf32(qf, kf.transpose(-1, -2))
        weighted = _mm_3xtf32
    else:
        scores = qf @ kf.transpose(-1, -2)

        def weighted(p, x):
            return _mm_split16(p, x, q.dtype)

    scores = scores * (1.0 / d**0.5)
    if causal:
        scores = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2((scores - m) * math.log2(math.e))
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (weighted(p, vf) / denom).to(q.dtype), m + torch.log(denom)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_forward_kernel_operand_rounding_matches_jax_kernel(causal, heads, dtype):
    """The numerics of the tensor-core forward kernel, emulated on the
    CPU, against the Pallas forward in interpret mode at the tolerances
    chip_smoke.py holds the kernel to (OUT_TOL for out, LSE_TOL for lse)."""
    hq, hkv = heads
    q, k, v = _qkv(1, hq, hkv, 64, 16, seed=60 + hq + causal)
    if dtype == "bf16":
        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    expected_out, expected_lse = _jax_flash(q, k, v, causal, with_lse=True)
    to_torch = _bf16 if dtype == "bf16" else torch.from_numpy
    out, lse = _emulated_kernel_forward(to_torch(q), to_torch(k), to_torch(v), causal)
    atol, rtol = OUT_TOL[out.dtype]
    assert out.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    np.testing.assert_allclose(out.float().numpy(), expected_out, atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse.numpy(), expected_lse, atol=LSE_TOL[0], rtol=LSE_TOL[1])


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11), 3.0 + 2**-10 + 2**-12])
    assert _tf32(x).tolist() == [1.0 + 2**-10, 1.0, -(1.0 + 2**-10), 3.0 + 2**-9]
    hi = _tf32(x)
    assert torch.equal(hi + _tf32(x - hi), x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_kernel_operand_rounding_matches_jax_kernels(causal, heads, dtype):
    """The numerics of the tensor-core backward kernels, emulated on the
    CPU, against the Pallas backward in interpret mode at the tolerance
    chip_smoke.py holds the kernels to (BWD_TOL: 1e-4 + 1e-4·|ref|)."""
    hq, hkv = heads
    q, k, v = _qkv(1, hq, hkv, 64, 16, seed=50 + hq + causal)
    g = np.random.default_rng(51 + hq).standard_normal((1, hq, 64, 16)).astype(np.float32)
    if dtype == "bf16":
        q, k, v, g = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jattn.flash_chunk_attention(jq, jk, jv, causal, 32, 32, True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1, keepdims=True)
    expected = jattn._flash_backward(jq, jk, jv, jg, lse, delta, causal, 32, 32, True)
    to_torch = _bf16 if dtype == "bf16" else torch.from_numpy
    got = _emulated_kernel_backward(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(np.array(lse)),
        to_torch(g), torch.from_numpy(np.array(delta)), causal,
    )
    for name, t, e in zip("qkv", got, expected):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_autograd_through_flash_attention_matches_jax_grad(heads):
    hq, hkv = heads
    q, k, v = _qkv(2, hq, hkv, 32, 8, seed=30 + hq)
    w = np.random.default_rng(31).standard_normal((2, hq, 32, 8)).astype(np.float32)

    def jloss(q, k, v):
        group = hq // hkv
        k, v = (jnp.repeat(x, group, axis=1) for x in (k, v))
        return jnp.sum(jattn._reference_attention(q, k, v, True) * w)

    expected = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for t, e in zip(got, expected):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


def test_lse_cotangent_matches_jax_vjp():
    q, k, v = _qkv(1, 4, 2, 64, 16, seed=40)
    rng = np.random.default_rng(41)
    d_out = rng.standard_normal((1, 4, 64, 16)).astype(np.float32)
    d_lse = rng.standard_normal((1, 4, 64, 1)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: jattn.flash_chunk_attention(q, k, v, True, 32, 32, True),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    expected = vjp((jnp.asarray(d_out), jnp.asarray(d_lse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=True)
    got = torch.autograd.grad(
        (out * torch.from_numpy(d_out)).sum() + (lse * torch.from_numpy(d_lse)).sum(),
        (tq, tk, tv),
    )
    for t, e in zip(got, expected):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=2e-5, rtol=1e-5)


def test_backward_on_cpu_launches_no_kernel(monkeypatch):
    for name in ("flash_forward_launches", "flash_bwd_dq_launches", "flash_bwd_dkv_launches"):
        monkeypatch.setattr(tattn, name, 0)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 2, 2, 16, 8, seed=1))
    grads = torch.autograd.grad(tattn.flash_attention(q, k, v).sum(), (q, k, v))
    assert all(g.shape == x.shape and g.dtype == x.dtype for g, x in zip(grads, (q, k, v)))
    assert (tattn.flash_forward_launches, tattn.flash_bwd_dq_launches,
            tattn.flash_bwd_dkv_launches) == (0, 0, 0)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 16, 8, seed=2))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tattn.flash_attention(q, k[:, :1].expand(1, 3, 16, 8), v, causal=True)
    with pytest.raises(ValueError, match="k and v"):
        tattn.flash_attention(q, k, v[:, :, :8], causal=True)
    with pytest.raises(TypeError, match="dtypes differ"):
        tattn.flash_attention(q, k.double(), v, causal=True)


@pytest.mark.parametrize(
    "d,dtype,width",
    [(64, torch.float32, 64), (30, torch.float32, 32), (80, torch.bfloat16, 80),
     (36, torch.bfloat16, 40), (1, torch.float16, 8)],
)
def test_kernel_rows_are_padded_to_16_bytes(d, dtype, width):
    assert tattn._padded_width(d, dtype) == width


def test_library_path_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header gives a new library path, so no library built
    from the old header is loaded."""
    from torchsnapshot_tpu_torch.ops import build

    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cuh")) == ["flash_common.cuh"]
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// first\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build._library_path("kernel")
    assert build._library_path("kernel") == first
    header.write_text("// second\n")
    second = build._library_path("kernel")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build._library_path("kernel") not in (first, second)


def test_kernel_build_failures_raise(tmp_path, monkeypatch):
    """A kernel that cannot be built raises with the reason; nothing falls
    back to the plain version."""
    from torchsnapshot_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "_TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.build_all(["flash_fwd"])
    # A compiler that fails: its output is in the error.
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_TOOLKIT_NVCC", str(fake))
    with pytest.raises(RuntimeError, match="nvcc failed to build flash_fwd.cu:\n.*bad kernel"):
        build.build_all(["flash_fwd"])
    assert not list(tmp_path.glob("*.so"))
