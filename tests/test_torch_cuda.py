"""The port on the card: the CUDA flash kernel against its plain version,
and CUDA-tensor take/restore. Marked ``cuda``; every test skips on a host
without a CUDA device. On a machine with one (``--noconftest``: the
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
    # f32: sums in another order; bf16/f16: one ulp of the output type.
    atol = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=8e-3)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)


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
