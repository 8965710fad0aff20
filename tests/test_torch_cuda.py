"""The port on the card: the CUDA flash kernels against their plain
versions, CUDA-tensor take/restore, the device-clone async take, and
two ranks sharing the card over gloo. Marked ``cuda``; every test skips
on a host without a CUDA device. On a machine with one (``--noconftest``: the
suite's conftest.py sets up JAX, which this file does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, io_preparer
from torchsnapshot_tpu_torch.models import transformer as tf
from torchsnapshot_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,dtype,causal",
    [
        (1, 4, 4, 256, 64, torch.float32, True),
        (2, 4, 2, 200, 128, torch.bfloat16, True),
        (1, 2, 1, 130, 32, torch.float16, False),
        (1, 4, 4, 192, 80, torch.bfloat16, True),
        (2, 8, 2, 256, 128, torch.float16, True),
        (1, 2, 2, 200, 128, torch.float32, False),
        (1, 2, 2, 70, 36, torch.bfloat16, True),
        (1, 2, 1, 100, 30, torch.float32, True),
    ],
)
def test_flash_kernel_matches_plain_version(cuda, b, hq, hkv, s, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (
        torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
        for h in (hq, hkv, hkv)
    )
    before = attention.flash_forward_launches
    out, lse = attention.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.flash_forward_launches == before + 1
    ref, ref_lse = attention.flash_attention_reference(q, k, v, causal)
    # f32: 3xTF32 products summed in another order; bf16/f16: one ulp of the
    # output type.
    atol = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=8e-3)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,dtype,causal",
    [
        (2, 4, 2, 320, 64, torch.float32, True),
        (1, 4, 4, 200, 128, torch.bfloat16, False),
    ],
)
def test_flash_forward_kernel_is_deterministic(cuda, b, hq, hkv, s, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (
        torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
        for h in (hq, hkv, hkv)
    )
    first = attention.flash_attention_with_lse(q, k, v, causal)
    second = attention.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(first[0].view(view), second[0].view(view))
    assert torch.equal(first[1].view(torch.int32), second[1].view(torch.int32))


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,dtype,causal",
    [
        (1, 4, 4, 256, 64, torch.float32, True),
        (1, 2, 2, 200, 64, torch.float32, False),
        (2, 4, 2, 200, 128, torch.bfloat16, True),
        (1, 2, 1, 130, 32, torch.float16, False),
        (1, 4, 4, 192, 80, torch.bfloat16, True),
        (2, 8, 2, 256, 128, torch.float16, True),
        (1, 2, 2, 200, 128, torch.float32, False),
        (1, 2, 2, 70, 36, torch.bfloat16, True),
        (1, 2, 1, 100, 30, torch.float32, True),
    ],
)
def test_flash_backward_kernels_match_plain_version(cuda, b, hq, hkv, s, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (
        torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
        for h in (hq, hkv, hkv)
    )
    out, lse = attention.flash_attention_with_lse(q, k, v, causal)
    d_out = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    d_lse = torch.randn((b, hq, s, 1), generator=gen, device=cuda)
    before = (attention.flash_bwd_dq_launches, attention.flash_bwd_dkv_launches)
    got = attention.flash_attention_backward(q, k, v, out, lse, d_out, d_lse, causal)
    torch.cuda.synchronize()
    assert (attention.flash_bwd_dq_launches, attention.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    delta = (d_out.float() * out.float()).sum(-1, keepdim=True) - d_lse
    expected = attention.flash_attention_backward_reference(
        q, k, v, out, lse, d_out, delta, causal)
    for g, e in zip(got, expected):
        assert g.dtype == torch.float32 and g.shape == e.shape
        # f32 sums in another order, relative to the gradient's size.
        torch.testing.assert_close(g, e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)


def _backward_inputs(cuda, b, hq, hkv, s, d, dtype, causal, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (
        torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
        for h in (hq, hkv, hkv)
    )
    out, lse = attention.flash_attention_with_lse(q, k, v, causal)
    d_out = torch.randn((b, hq, s, d), generator=gen, device=cuda)
    return q, k, v, out, lse, d_out


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,dtype,causal",
    [
        (2, 4, 4, 256, 64, torch.float32, True),
        (1, 8, 2, 200, 128, torch.bfloat16, False),
        (1, 4, 4, 192, 80, torch.float16, True),
    ],
)
def test_flash_backward_kernels_are_deterministic(cuda, b, hq, hkv, s, d, dtype, causal):
    q, k, v, out, lse, d_out = _backward_inputs(cuda, b, hq, hkv, s, d, dtype, causal, 3)
    d_out = d_out.to(dtype)
    first = attention.flash_attention_backward(q, k, v, out, lse, d_out, None, causal)
    second = attention.flash_attention_backward(q, k, v, out, lse, d_out, None, causal)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))


def test_flash_backward_wide_cotangent_stays_exact(cuda):
    """A bf16 q with an f32 dO: dO is not rounded to bf16."""
    q, k, v, out, lse, d_out = _backward_inputs(cuda, 1, 4, 2, 192, 64, torch.bfloat16, True, 4)
    got = attention.flash_attention_backward(q, k, v, out, lse, d_out, None, True)
    delta = (d_out * out.float()).sum(-1, keepdim=True)
    expected = attention.flash_attention_backward_reference(
        q, k, v, out, lse, d_out, delta, True)
    rounded = attention.flash_attention_backward_reference(
        q, k, v, out, lse, d_out.to(torch.bfloat16), delta, True)
    for g, e, r in zip(got, expected, rounded):
        torch.testing.assert_close(g, e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)
        # Rounding dO to bf16 would be visible at this tolerance.
        assert float((r - e).abs().max()) > 1e-4 * float(e.abs().max())


def test_flash_attention_autograd_launches_backward_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((1, 2, 96, 64), generator=gen, device=cuda).requires_grad_()
               for _ in range(3))
    before = attention.flash_bwd_dkv_launches
    grads = torch.autograd.grad(attention.flash_attention(q, k, v).square().sum(), (q, k, v))
    assert attention.flash_bwd_dkv_launches == before + 1
    ref = attention.flash_attention_reference
    expected = torch.autograd.grad(ref(q, k, v, True)[0].square().sum(), (q, k, v))
    for g, e in zip(grads, expected):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)


def test_cuda_take_restore_in_place_bit_exact(cuda, tmp_path):
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn((16, 1024, 1024), generator=gen, device=cuda)
    h = torch.randn((333, 517), generator=gen, device=cuda).to(torch.bfloat16)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(w=w, h=h.t())})
    target_w = torch.zeros_like(w)
    target = StateDict(w=target_w, h=torch.zeros(517, 333, dtype=torch.bfloat16, device=cuda))
    Snapshot(path).restore({"s": target})
    assert target["w"] is not None and target["w"].data_ptr() == target_w.data_ptr()
    assert torch.equal(target["w"], w)
    assert torch.equal(target["h"].view(torch.int16), h.t().contiguous().view(torch.int16))
    got = Snapshot(path).read_object("s/w", template=torch.empty(1, device=cuda).expand(16, 1024, 1024))
    assert got.is_cuda and torch.equal(got, w)


def test_flash_forward_matches_einsum_forward(cuda):
    cfg = tf.TransformerConfig(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2,
                               n_layers=2, d_ff=256, max_seq_len=64, flash_attention=True)
    params = tf.init_params(cfg, seed=0)
    tokens = torch.randint(0, 64, (2, 64), device=cuda)
    flash = tf.forward(params, tokens, cfg)
    einsum = tf.forward(params, tokens, dataclasses.replace(cfg, flash_attention=False))
    np.testing.assert_allclose(flash.cpu().numpy(), einsum.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(40, 8), (8, 40)])
def test_cuda_chunked_dense_restore(cuda, tmp_path, monkeypatch, shape):
    """Chunks that are one byte run of the target land by H2D into it;
    chunks split along dim 1 land whole and scatter on the card."""
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 256)
    w = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros_like(w))
    Snapshot(path).restore({"m": target})
    assert torch.equal(target["w"], w)


def test_device_staged_async_take_is_a_consistent_cut(cuda, tmp_path):
    """The clones are ordered before the caller's next in-place update on
    the same stream; the drain stages them on side streams."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((8, 1024, 1024), generator=gen, device=cuda)
    expected = w.clone()
    path = str(tmp_path / "snap")
    pending = Snapshot.async_take(path, {"m": StateDict(w=w, step=torch.ones(1))},
                                  stage="device")
    for _ in range(4):
        w.mul_(3.0).add_(1.0)
    target = StateDict(w=torch.zeros_like(w), step=torch.zeros(1))
    pending.wait().restore({"m": target})
    assert torch.equal(target["w"], expected)
    assert not torch.equal(w, expected)


def test_two_ranks_on_one_card_take_then_restore_at_world_1(cuda, tmp_path):
    """Two spawned ranks share the card over gloo (NCCL refuses two ranks
    on one GPU), take the tiny transformer tensor-parallel as CUDA
    DTensors, and one process restores it onto the card byte-equal."""
    import torch_rank_workers

    from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

    cfg = tf.TransformerConfig(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                               n_layers=2, d_ff=128, max_seq_len=33)
    params = tf.init_params(cfg, seed=5, device="cpu")

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_numpy(v) for v in tree]
        return tree.numpy()

    params_np = to_numpy(params)
    path = str(tmp_path / "snap")
    run_multiprocess(torch_rank_workers.cuda_take, 2, (path, params_np))
    target = tf.TransformerState(tf.Transformer.init(cfg, seed=6, device=cuda))
    Snapshot(path).restore({"model": target})
    for got, want in zip(tf.param_leaves(target.model.params()), tf.param_leaves(params)):
        assert got.is_cuda and torch.equal(got.detach().cpu().view(torch.uint8),
                                           want.view(torch.uint8))


# ------------------------------------------------ the restore fast lane


@pytest.fixture
def fresh_pool():
    from torchsnapshot_tpu_torch import staging_pool

    staging_pool.reset_staging_pool()
    yield staging_pool
    staging_pool.reset_staging_pool()


def test_pooled_buffers_are_pinned(cuda, tmp_path, monkeypatch, fresh_pool):
    """A CUDA target stages through pinned pooled slots, and a second
    restore of the same state reuses them: a hit, no new pinned
    allocation. (One leaf in one slot: one buffer in flight in both.)"""
    lease = fresh_pool.acquire(4096, pinned=True)
    assert lease.buffer.is_pinned()
    lease.release()
    base = fresh_pool.get_staging_pool().stats()["pinned_allocs"]
    w = torch.randn(70000, device=cuda)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros_like(w))
    Snapshot(path).restore({"m": target})
    pool = fresh_pool.get_staging_pool()
    first = pool.stats()
    assert first["pinned_allocs"] - base == 1 and first["in_use_bytes"] == 0
    assert all(b.is_pinned() for bucket in pool._free.values() for b in bucket)
    Snapshot(path).restore({"m": target})
    second = pool.stats()
    assert second["hits"] - first["hits"] == 1
    assert second["pinned_allocs"] == first["pinned_allocs"]
    assert torch.equal(target["w"], w)


def test_streamed_restore_into_cuda_template_is_bit_exact(cuda, tmp_path, monkeypatch, fresh_pool):
    """Chunked, streamed and split leaves land on the card in place;
    every byte placed rode the H2D pipeline, and the device budget held."""
    from torchsnapshot_tpu_torch import snapshot as psnap

    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 1 << 20)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(64 << 10))
    gen = torch.Generator(device=cuda).manual_seed(4)
    state = {
        "runs": torch.randn(1 << 20, generator=gen, device=cuda),  # 4 chunks, streamed
        "cols": torch.randn((256, 2048), generator=gen, device=cuda),  # chunks cut dim 1
        "bf16": torch.randn((333, 517), generator=gen, device=cuda).to(torch.bfloat16),
        "small": torch.randn(7, generator=gen, device=cuda),
    }
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(**state)})
    target = StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})
    ptrs = {k: v.data_ptr() for k, v in target.items()}
    Snapshot(path).restore({"m": target})
    total = 0
    for k, v in state.items():
        assert target[k].data_ptr() == ptrs[k], k
        assert torch.equal(target[k].view(torch.uint8), v.view(torch.uint8)), k
        total += v.numel() * v.element_size()
    report = psnap._last_restore_report
    assert report["substeps"]["h2d_overlap"]["bytes"] == total
    sched = report["scheduler"]
    # "runs" (four chunks) and "bf16" (one object above the threshold)
    # stream; the chunks of "cols" are cut along dim 1 and do not.
    assert sched["streamed_bytes"] == state["runs"].numel() * 4 + state["bf16"].numel() * 2
    assert sched["device_high_water_bytes"] <= sched["device_budget_bytes"]


@pytest.mark.parametrize("budget_mib", [4, 2])
def test_device_budget_bounds_private_buffers(cuda, tmp_path, monkeypatch, budget_mib):
    """Two 3 MiB streamed leaves under a 4 MiB device budget run one after
    the other; under 2 MiB each is force-admitted alone: the overrun is
    one region at most."""
    from torchsnapshot_tpu_torch import snapshot as psnap

    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(256 << 10))
    monkeypatch.setenv("TPUSNAPSHOT_DEVICE_BUDGET_BYTES", str(budget_mib << 20))
    region = 3 << 20
    state = {k: torch.randn(region // 4, device=cuda) for k in ("a", "b")}
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(**state)})
    target = StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"m": target})
    for k, v in state.items():
        assert torch.equal(target[k], v)
    sched = psnap._last_restore_report["scheduler"]
    assert sched["device_high_water_bytes"] == region
    assert sched["device_high_water_bytes"] <= max(budget_mib << 20, region)


def test_failed_restore_leaves_cuda_template_untouched(cuda, tmp_path, monkeypatch, fresh_pool):
    """A corrupt chunk and an injected pipeline failure each fail the
    restore with the CUDA template bit-equal to its old values; the retry
    is bit-exact."""
    from concurrent.futures import Future

    from torchsnapshot_tpu_torch.ops.transfer import H2DPipeline

    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 256 << 10)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(64 << 10))
    w = torch.randn(1 << 18, device=cuda)
    path = tmp_path / "snap"
    Snapshot.take(str(path), {"m": StateDict(w=w)})
    old = torch.randn(1 << 18, device=cuda)
    target = StateDict(w=old.clone())
    victim = path / "chunked" / "0" / "m" / "w__chunk_3"
    good = victim.read_bytes()
    raw = bytearray(good)
    raw[1000] ^= 0x55
    victim.write_bytes(bytes(raw))
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        Snapshot(str(path)).restore({"m": target})
    assert torch.equal(target["w"], old)
    victim.write_bytes(good)

    submit = H2DPipeline.submit
    calls = [0]

    def failing(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            fut = Future()
            fut.set_exception(RuntimeError("injected transfer failure"))
            return fut
        return submit(self, *args, **kwargs)

    monkeypatch.setattr(H2DPipeline, "submit", failing)
    with pytest.raises(RuntimeError, match="injected transfer failure"):
        Snapshot(str(path)).restore({"m": target})
    assert torch.equal(target["w"], old)
    monkeypatch.setattr(H2DPipeline, "submit", submit)
    Snapshot(str(path)).restore({"m": target})
    assert torch.equal(target["w"], w)


def test_failed_transfer_of_a_multi_slot_leaf_leaves_cuda_template_untouched(
    cuda, tmp_path, monkeypatch, fresh_pool
):
    """A single-object leaf of more bytes than one staging slot reaches
    the card as several transfers, so it lands in a private buffer: with
    its second transfer made to fail, the restore raises and the
    template keeps its old values, though the first transfer had landed.
    The retry is bit-exact."""
    from concurrent.futures import Future

    from torchsnapshot_tpu_torch import snapshot as psnap
    from torchsnapshot_tpu_torch.ops import transfer

    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(5 << 20, generator=gen, device=cuda)  # 20 MiB, one object
    nbytes = w.numel() * w.element_size()
    assert transfer.H2D_CHUNK_BYTES < nbytes <= 2 * transfer.H2D_CHUNK_BYTES
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=w)})
    old = torch.randn(5 << 20, generator=gen, device=cuda)
    target = StateDict(w=old.clone())

    submit = transfer.H2DPipeline.submit
    calls = [0]

    def failing(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 2:
            fut = Future()
            fut.set_exception(RuntimeError("injected transfer failure"))
            return fut
        return submit(self, *args, **kwargs)

    monkeypatch.setattr(transfer.H2DPipeline, "submit", failing)
    with pytest.raises(RuntimeError, match="injected transfer failure"):
        Snapshot(path).restore({"m": target})
    assert calls[0] == 2
    torch.cuda.synchronize()
    assert torch.equal(target["w"].view(torch.int32), old.view(torch.int32))
    monkeypatch.setattr(transfer.H2DPipeline, "submit", submit)
    Snapshot(path).restore({"m": target})
    assert torch.equal(target["w"].view(torch.int32), w.view(torch.int32))
    assert psnap._last_restore_report["scheduler"]["private_bytes"] == nbytes


def test_lease_is_not_reused_while_its_dma_is_in_flight(cuda, tmp_path, monkeypatch, fresh_pool):
    """The pipeline holds a pinned lease until its DMA's event completes:
    with a pool of one buffer, a DMA queued behind a long kernel keeps the
    next acquisition waiting until the copy has landed, and only then
    hands the buffer on. Then a depth-2 engine with a pool of two
    sub-reads' bytes restores a leaf of 128 sub-ranges bit-exactly, three
    times over."""
    from torchsnapshot_tpu_torch.ops import transfer

    pool = fresh_pool.StagingPool(capacity_bytes=1 << 20, max_wait_s=60)
    lease = pool.acquire(1 << 20, pinned=True)
    lease.buffer.fill_(5)
    dst = torch.zeros(1 << 20, dtype=torch.uint8, device=cuda)
    busy = torch.cuda.Stream()
    with torch.cuda.stream(busy):
        torch.cuda._sleep(200_000_000)  # keeps the DMA queued behind it
        ready = torch.cuda.Event()
        ready.record(busy)
    fut = transfer.H2DPipeline(depth=2).submit(lease.buffer, dst, ready=ready, lease=lease)
    lease.release()
    again = pool.acquire(1 << 20, pinned=True)
    assert fut.done() and pool.stats()["waits"] == 1
    assert again.buffer.data_ptr() == lease.buffer.data_ptr()
    again.buffer.fill_(9)  # after the DMA: dst keeps the 5s
    fut.result(timeout=60)
    assert torch.equal(dst.cpu(), torch.full((1 << 20,), 5, dtype=torch.uint8))
    again.release()

    monkeypatch.setenv("TPUSNAPSHOT_H2D_DEPTH", "2")
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(64 << 10))
    monkeypatch.setattr(transfer, "H2D_CHUNK_BYTES", 64 << 10)
    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES", str(128 << 10))
    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_POOL_WAIT_S", "0.05")
    fresh_pool.reset_staging_pool()
    transfer._reset_h2d_pipeline_for_tests()
    try:
        w = torch.randn(1 << 21, device=cuda)  # 8 MiB: 128 sub-ranges
        path = str(tmp_path / "snap")
        Snapshot.take(path, {"m": StateDict(w=w)})
        for _ in range(3):
            target = StateDict(w=torch.zeros_like(w))
            Snapshot(path).restore({"m": target})
            assert torch.equal(target["w"], w)
    finally:
        transfer._reset_h2d_pipeline_for_tests()


# ---- Deduplication: K4, K5, the chunk store's device slices, verify_device.

_FP_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.float16, torch.bfloat16,
              torch.float32, torch.int32, torch.int64, torch.float64]


def _fp_input(cuda, dtype, n, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device=cuda) > 0.5
    if not dtype.is_floating_point:
        return torch.randint(-100, 100, (n,), generator=gen, device=cuda).to(dtype)
    return torch.randn(n, generator=gen, device=cuda).to(dtype)


@pytest.mark.parametrize("dtype", _FP_DTYPES)
@pytest.mark.parametrize("n", [0, 1, 3, 5, 13, 4097, 1 << 20])
def test_fingerprint_kernels_match_plain_and_host(cuda, dtype, n):
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    x = _fp_input(cuda, dtype, n, seed=n)
    host = x.cpu()
    before = (ops.fingerprint_box_launches, ops.fingerprint_box_segments)
    got = fp.resolve_fingerprints([fp.fingerprint_device_async(x)])[0]
    assert (ops.fingerprint_box_launches, ops.fingerprint_box_segments) == (
        before[0] + (1 if n else 0), before[1] + (1 if n else 0))
    assert got == fp.resolve_fingerprints([ops.fingerprint_box_reference(x)])[0] == fp.fingerprint_host(host)
    for chunk_bytes in (12, 4096):
        want = fp.fingerprint_host_chunked(host, chunk_bytes)
        assert fp.resolve_chunk_fingerprints([fp.fingerprint_device_chunked_async(x, chunk_bytes)])[0] == want
        assert fp.resolve_chunk_fingerprints([ops.fingerprint_chunked_reference(x, chunk_bytes)])[0] == want


def test_batched_fingerprint_kernels_match_plain_and_host(cuda):
    """One K4 batch and one K5 batch over every dtype, empty and odd
    lengths, 1-byte views at odd offsets, boxes and a tensor given twice
    (fast and general segments in one launch), bit-equal to the plain
    versions and the host twins item by item."""
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    items = [(_fp_input(cuda, dtype, n, seed=n), None) for dtype in _FP_DTYPES for n in (0, 3, 4097, 70001)]
    base = _fp_input(cuda, torch.int8, 100003)
    items += [(base[offset:], None) for offset in (1, 2, 3)]
    m = _fp_input(cuda, torch.float32, 64 * 129).reshape(64, 129)
    items += [(m, [(3, 40), (0, 129)]), (m, [(0, 64), (5, 77)]), (m, [(0, 64), (1, 2)]), items[6]]
    plan = ops.prepare_boxes(items).plan
    assert plan.n_fast and plan.n_general
    rows = ops.fingerprint_boxes(items)
    for (x, box), row in zip(items, rows):
        assert torch.equal(row.cpu(), ops.fingerprint_box_reference(x, box).cpu())
        host = x if box is None else x[tuple(slice(a, b) for a, b in box)]
        assert fp.resolve_fingerprints([row])[0] == fp.fingerprint_host(host.contiguous().cpu())
    tensors = [x for x, box in items if box is None]
    sizes = [4096 + 4 * (i % 3) for i in range(len(tensors))]
    for chunk_bytes in (12, 4096, sizes):
        per = [chunk_bytes] * len(tensors) if isinstance(chunk_bytes, int) else chunk_bytes
        got = ops.fingerprint_chunked_many(tensors, chunk_bytes)
        for x, cb, rows in zip(tensors, per, got):
            assert torch.equal(rows.cpu(), ops.fingerprint_chunked_reference(x, cb).cpu())
            assert fp.resolve_chunk_fingerprints([rows])[0] == fp.fingerprint_host_chunked(x.cpu(), cb)


def test_each_fingerprint_batch_is_one_launch_and_counts_its_leaves(cuda, tmp_path, monkeypatch):
    """A fingerprinted take, an incremental take, a verify_device restore
    and a chunk take each launch K4 or K5 once on the card; the segment
    counters count the leaves."""
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(64 << 10))
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    # Both dtypes proven already: no probe launch in the chunk take.
    monkeypatch.setattr(chunkstore, "_FP_AGREEMENT", {"torch.float32@cuda": True, "torch.bfloat16@cuda": True})
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = {f"w{i}": torch.randn(1000 * (i + 1) + 3, generator=gen, device=cuda) for i in range(5)}
    state["h"] = torch.randn(300, 7, generator=gen, device=cuda).to(torch.bfloat16)
    app = {"m": StateDict(**state)}

    def counted(fn):
        before = (ops.fingerprint_box_launches, ops.fingerprint_box_segments,
                  ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments)
        result = fn()
        torch.cuda.synchronize()
        now = (ops.fingerprint_box_launches, ops.fingerprint_box_segments,
               ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments)
        return result, tuple(a - b for a, b in zip(now, before))

    base, counts = counted(lambda: Snapshot.take(str(tmp_path / "base"), app, fingerprint=True))
    assert counts == (1, 6, 0, 0)
    _, counts = counted(lambda: Snapshot.take(str(tmp_path / "inc"), app, base=base))
    assert counts == (1, 6, 0, 0)
    target = {"m": StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})}
    _, counts = counted(lambda: base.restore(target, verify_device=True))
    assert counts == (1, 6, 0, 0)
    _, counts = counted(lambda: Snapshot.take(str(tmp_path / "chunks"), app, chunks=True))
    assert counts == (0, 0, 1, 6)


@pytest.mark.parametrize("kind", ["boxes", "chunked"])
def test_a_batch_of_non_contiguous_leaves_holds_its_copies_under_the_cap(cuda, monkeypatch, kind):
    """Eight transposed 4 MiB leaves, each copied before its launch: with
    the cap at two copies the batch launches every two, and the device's
    peak stays within the cap plus one copy (not all eight copies)."""
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    leaves = [_fp_input(cuda, torch.float32, 1 << 20, seed=i).reshape(1024, 1024).t() for i in range(8)]
    copy_bytes = 4 << 20
    monkeypatch.setattr(fp, "COPY_BYTES_PER_LAUNCH", 2 * copy_bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    if kind == "boxes":
        launches, segments = ops.fingerprint_box_launches, ops.fingerprint_box_segments
        got = fp.resolve_fingerprints(fp.fingerprint_device_many_async([(x, None) for x in leaves]))
        launches, segments = ops.fingerprint_box_launches - launches, ops.fingerprint_box_segments - segments
    else:
        launches, segments = ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments
        got = fp.resolve_chunk_fingerprints(fp.fingerprint_device_chunked_many_async(leaves, 1 << 20))
        launches, segments = (ops.fingerprint_chunked_launches - launches,
                              ops.fingerprint_chunked_segments - segments)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    if kind == "boxes":
        want = [fp.fingerprint_host(x.contiguous().cpu()) for x in leaves]
    else:
        want = [fp.fingerprint_host_chunked(x.contiguous().cpu(), 1 << 20) for x in leaves]
    assert got == want
    assert (launches, segments) == (4, 8)
    assert peak <= 3 * copy_bytes + (1 << 20), peak


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fingerprint_kernels_at_odd_byte_offsets(cuda, offset):
    from torchsnapshot_tpu_torch import fingerprint as fp

    x = _fp_input(cuda, torch.int8, 100003)[offset:]
    host = x.cpu()
    assert fp.resolve_fingerprints([fp.fingerprint_device_async(x)])[0] == fp.fingerprint_host(host)
    assert fp.resolve_chunk_fingerprints([fp.fingerprint_device_chunked_async(x, 4096)])[0] == (
        fp.fingerprint_host_chunked(host, 4096)
    )


@pytest.mark.parametrize("slices", [
    (slice(3, 40), slice(None)), (slice(None), slice(5, 77)), (slice(None), slice(1, 2)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int8])
def test_fingerprint_box_kernel_reads_runs_in_place(cuda, slices, dtype):
    from torchsnapshot_tpu_torch import fingerprint as fp

    x = _fp_input(cuda, dtype, 64 * 129).reshape(64, 129)
    want = fp.fingerprint_host(x[slices].contiguous().cpu())
    assert fp.resolve_fingerprints([fp.fingerprint_device_async(x, slices)])[0] == want


def test_chunk_stager_slices_on_the_device(cuda, tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(64 << 10))
    copied = []
    orig = chunkstore.device_to_host

    def counting(src, ready=None):
        copied.append(src.numel() * src.element_size())
        return orig(src, ready)

    monkeypatch.setattr(chunkstore, "device_to_host", counting)
    w = torch.randn(1 << 20, device=cuda)  # 4 MiB: 64 chunks
    Snapshot.take(str(tmp_path / "step-1"), {"m": StateDict(w=w)}, chunks=True)
    assert len(copied) == 64 and set(copied) == {64 << 10}
    copied.clear()
    w[5] += 1.0
    w[(1 << 20) - 1] += 1.0
    before = (ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments)
    Snapshot.take(str(tmp_path / "step-2"), {"m": StateDict(w=w)}, chunks=True)
    assert (ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments) == (before[0] + 1, before[1] + 1)
    assert copied == [64 << 10, 64 << 10]  # only the two touched chunks crossed
    target = StateDict(w=torch.zeros_like(w))
    Snapshot(str(tmp_path / "step-2")).restore({"m": target})
    assert torch.equal(target["w"], w)


def test_verify_device_catches_a_byte_flipped_in_hbm(cuda, tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    w = torch.randn(4096, device=cuda)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, fingerprint=True)
    target = StateDict(w=torch.zeros_like(w))
    before = (ops.fingerprint_box_launches, ops.fingerprint_box_segments)
    Snapshot(str(tmp_path / "snap")).restore({"m": target}, verify_device=True)
    assert (ops.fingerprint_box_launches, ops.fingerprint_box_segments) == (before[0] + 1, before[1] + 1)
    real = snapshot_mod._load_stateful

    def flip_after_landing(*args, **kwargs):
        selected = real(*args, **kwargs)
        args[1].state_dict()["w"].view(torch.uint8)[100] ^= 1  # in HBM
        return selected

    monkeypatch.setattr(snapshot_mod, "_load_stateful", flip_after_landing)
    with pytest.raises(RuntimeError, match="m/w"):
        Snapshot(str(tmp_path / "snap")).restore({"m": StateDict(w=torch.zeros_like(w))}, verify_device=True)
    assert snapshot_mod._last_verify_stats == {"verified": 1, "skipped": 0}


def test_chunk_take_on_the_card_raises_when_k5_disagrees_with_the_host(cuda, tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch import chunkstore, fingerprint as fp

    monkeypatch.setattr(chunkstore, "_FP_AGREEMENT", {})
    real = fp.fingerprint_host_chunked
    monkeypatch.setattr(fp, "fingerprint_host_chunked", lambda data, cb: ["xs128:" + "0" * 32] * len(real(data, cb)))
    w = torch.randn(1 << 18, device=cuda)
    with pytest.raises(RuntimeError, match="K5 disagrees"):
        Snapshot.take(str(tmp_path / "step-1"), {"m": StateDict(w=w)}, chunks=True)


@pytest.mark.parametrize("kind", ["incremental", "chunks", "verify_device"])
def test_a_failed_fingerprint_launch_on_the_card_raises(cuda, tmp_path, monkeypatch, kind):
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    monkeypatch.setattr(chunkstore, "_FP_AGREEMENT", {})
    w = torch.randn(1 << 18, device=cuda)
    app = {"m": StateDict(w=w)}
    base = Snapshot.take(str(tmp_path / "base"), app, fingerprint=True)

    def failing(call, out, name):
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t 98")

    monkeypatch.setattr(ops, "_run", failing)
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        if kind == "incremental":
            Snapshot.take(str(tmp_path / "inc"), app, base=base)
        elif kind == "chunks":
            Snapshot.take(str(tmp_path / "step-1"), app, chunks=True)
        else:
            base.restore({"m": StateDict(w=torch.zeros_like(w))}, verify_device=True)


def test_complex_leaf_on_the_card_is_chunked_by_k5_on_its_bytes(cuda, tmp_path):
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    z = torch.randn(1 << 17, dtype=torch.complex64, device=cuda)
    before = (ops.fingerprint_chunked_launches, ops.fingerprint_chunked_segments)
    s = Snapshot.take(str(tmp_path / "step-1"), {"m": StateDict(z=z)}, chunks=True)
    assert ops.fingerprint_chunked_launches > before[0] and ops.fingerprint_chunked_segments > before[1]
    records = s.get_manifest()["0/m/z"].chunks
    want = fp.fingerprint_host_chunked(z.cpu(), records[0]["n"])
    assert [r["k"].split("-")[0] for r in records] == want
    target = StateDict(z=torch.zeros_like(z))
    Snapshot(str(tmp_path / "step-1")).restore({"m": target})
    assert torch.equal(target["z"], z)


# ---- The rest of the API on the card: partial restores, verify, copy_to.


def test_partial_restore_into_cuda_templates_leaves_the_others_untouched(cuda, tmp_path):
    """restore(paths=) into CUDA templates: the selected leaves land in
    their tensors; every other leaf keeps its storage and its bytes."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    saved = {f"w{i}": torch.randn(4096 + i, generator=gen, device=cuda) for i in range(4)}
    saved["big"] = torch.randn(5 << 20, generator=gen, device=cuda)  # 20 MiB: two staging slots
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(**saved)}, fingerprint=True)
    target = StateDict(**{k: torch.full_like(v, 7.0) for k, v in saved.items()})
    ptrs = {k: v.data_ptr() for k, v in target.items()}
    Snapshot(str(tmp_path / "snap")).restore({"m": target}, paths=["m/w1", "m/big"])
    torch.cuda.synchronize()
    for k, v in target.items():
        assert v.is_cuda and v.data_ptr() == ptrs[k], k
        if k in ("w1", "big"):
            assert torch.equal(v, saved[k]), k
        else:
            assert torch.equal(v, torch.full_like(v, 7.0)), k


def test_verify_device_with_paths_launches_k4_once_a_selected_leaf(cuda, tmp_path):
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    gen = torch.Generator(device=cuda).manual_seed(1)
    saved = {f"l{i}/w": torch.randn(2048, generator=gen, device=cuda) for i in range(6)}
    app = {"m": StateDict(layers={k.split("/")[0]: {"w": v} for k, v in saved.items()})}
    Snapshot.take(str(tmp_path / "snap"), app, fingerprint=True)
    target = {"m": StateDict(layers={k.split("/")[0]: {"w": torch.zeros_like(v)} for k, v in saved.items()})}
    before = (ops.fingerprint_box_launches, ops.fingerprint_box_segments)
    Snapshot(str(tmp_path / "snap")).restore(target, paths=["m/layers/l2/**", "m/layers/l4/**"],
                                            verify_device=True)
    torch.cuda.synchronize()
    assert (ops.fingerprint_box_launches - before[0], ops.fingerprint_box_segments - before[1]) == (1, 2)
    assert snapshot_mod._last_verify_stats == {"verified": 2, "skipped": 0}
    layers = target["m"]["layers"]
    assert torch.equal(layers["l2"]["w"], saved["l2/w"]) and not layers["l3"]["w"].any()


def test_verify_and_copy_to_of_a_cuda_snapshot_touch_no_device(cuda, tmp_path, monkeypatch):
    """verify() and copy_to() work from storage alone: no kernel launch,
    no device allocation."""
    from torchsnapshot_tpu_torch.ops import fingerprint as ops

    w = torch.randn(1 << 16, device=cuda)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, fingerprint=True)
    torch.cuda.synchronize()
    allocated, launches = torch.cuda.memory_allocated(), ops.fingerprint_box_launches
    assert Snapshot(str(tmp_path / "snap")).verify() == {}
    Snapshot(str(tmp_path / "snap")).copy_to(str(tmp_path / "copy"))
    assert (torch.cuda.memory_allocated(), ops.fingerprint_box_launches) == (allocated, launches)
    target = StateDict(w=torch.zeros_like(w))
    Snapshot(str(tmp_path / "copy")).restore({"m": target})
    assert torch.equal(target["w"], w)


def test_traced_take_of_cuda_tensors_reports_the_manifest_bytes(cuda, tmp_path):
    """A take and a restore of CUDA tensors with tracing on: the take's
    report counts exactly the payload bytes on disk, the pinned pool's
    high-water stays within its cap, and every span of each root carries
    that root's trace id."""
    import json
    import os

    from torchsnapshot_tpu_torch import tracing

    gen = torch.Generator(device=cuda).manual_seed(3)
    state = {"m": StateDict(
        w=torch.randn(1024, 1024, generator=gen, device=cuda),
        b=torch.randn(4096, generator=gen, device=cuda).to(torch.bfloat16),
    )}
    path, trace = str(tmp_path / "snap"), str(tmp_path / "trace.json")
    tracing.enable(trace)
    try:
        Snapshot.take(path, state)
        target = {"m": StateDict(w=torch.zeros(1024, 1024, device=cuda),
                                 b=torch.zeros(4096, device=cuda, dtype=torch.bfloat16))}
        Snapshot(path).restore(target)
    finally:
        tracing.flush()
        tracing.disable()
    assert torch.equal(target["m"]["w"], state["m"]["w"])
    payload = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, files in os.walk(path) for f in files
        if not os.path.relpath(os.path.join(d, f), path).startswith(".")
    )
    with open(os.path.join(path, ".report.json")) as f:
        report = json.load(f)
    assert report["totals"]["bytes"] == payload == 1024 * 1024 * 4 + 4096 * 2
    with open(os.path.join(path, ".report.restore.json")) as f:
        restore = json.load(f)
    pool = restore["ranks"][0]["memory"]["domains"].get("staging_pool")
    if pool is not None:
        assert pool["high_water_bytes"] <= pool["cap_bytes"]
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "b"]
    roots = [e for e in events if e["name"] in ("Snapshot.take", "Snapshot.restore")]
    assert sorted(e["name"] for e in roots) == ["Snapshot.restore", "Snapshot.take"]
    ids = {e["args"]["trace"] for e in roots}
    assert len(ids) == 2 and {e["args"].get("trace") for e in events} == ids
    assert sum(1 for e in events if e["name"] == "write") == 2


def test_restore_report_probes_h2d_without_a_device_wide_synchronize(cuda, tmp_path, monkeypatch):
    """The restore report's once-a-process H2D probe runs inside the
    restore: it times its own copies and never synchronizes the whole
    device, so a restore makes no ``torch.cuda.synchronize`` call."""
    import json
    import os

    from torchsnapshot_tpu_torch.ops import transfer

    monkeypatch.setenv("TPUSNAPSHOT_H2D_PROBE_MIN_BYTES", "0")
    monkeypatch.setenv("TPUSNAPSHOT_H2D_PROBE_BYTES", str(40 << 20))
    monkeypatch.setattr(transfer, "_report_probe", [])
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(2048, 1024, generator=gen, device=cuda)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=w)})
    target = {"m": StateDict(w=torch.zeros_like(w))}
    calls = []
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    Snapshot(path).restore(target)
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    assert calls == []
    assert torch.equal(target["m"]["w"], w)
    with open(os.path.join(path, ".report.restore.json")) as f:
        profile = json.load(f)["ranks"][0]["consume_profile"]
    assert profile["h2d_probe_gbps"] > 0 and transfer._report_probe[0] > 0


def test_hot_tier_async_take_and_restore_of_a_cuda_state(cuda, tmp_path):
    """A hot-tier async take of a small CUDA state through two in-process
    wire peers (k = 2 of 3 hosts) acks with every object on hosts 0 and 1,
    launches K4 once over its leaves, and restores into a zeroed CUDA
    template served hot, bit-exact; with the local host lost too, the
    peer's replicas still serve it."""
    from torchsnapshot_tpu_torch import hottier
    from torchsnapshot_tpu_torch.hottier import tier as ht_tier
    from torchsnapshot_tpu_torch.hottier.peer import start_local_peer
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    gen = torch.Generator(device=cuda).manual_seed(17)
    state = {"w": torch.randn(300, 257, generator=gen, device=cuda),
             "b": torch.randn(4099, generator=gen, device=cuda).to(torch.bfloat16),
             "i": torch.randint(-9, 9, (77,), generator=gen, device=cuda, dtype=torch.int32)}
    servers = [start_local_peer(h, capacity_bytes=1 << 26)[0] for h in (1, 2)]
    root = str(tmp_path / "step-0")
    try:
        with hottier.hot_tier(rank=0, world=3, k=2, drain="manual"):
            launches, segments = fops.fingerprint_box_launches, fops.fingerprint_box_segments
            Snapshot.async_take(root, {"m": StateDict(**state)}, fingerprint=True).wait()
            assert fops.fingerprint_box_launches - launches == 1
            assert fops.fingerprint_box_segments - segments == len(state)
            keys = ht_tier.keys_for_root(root)
            assert len(keys) == len(state)
            assert {tuple(ht_tier.live_replicas(k)) for k in keys} == {(0, 1)}
            for lost in ((), (0,)):
                for h in lost:
                    hottier.kill_host(h)
                target = {k: torch.zeros_like(v) for k, v in state.items()}
                before = hottier.runtime().stats_snapshot()
                Snapshot(root).restore({"m": StateDict(**target)})
                torch.cuda.synchronize()
                after = hottier.runtime().stats_snapshot()
                assert after["hot_objects"] - before["hot_objects"] == len(state)
                assert after["fallback_objects"] == before["fallback_objects"]
                for k, v in state.items():
                    assert target[k].is_cuda
                    assert torch.equal(target[k].cpu().view(torch.uint8), v.cpu().view(torch.uint8))
            hottier.drain_now()
    finally:
        hottier.disable_hot_tier(flush=False)
        hottier.reset_hot_tier()
        for server in servers:
            server.stop()
