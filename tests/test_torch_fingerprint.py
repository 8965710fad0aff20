"""The port's xs128 fingerprints (K4, K5 plain versions; the host twins)
against the JAX package's ``fingerprint_host``,
``fingerprint_host_chunked`` and its jitted device functions on the CPU,
bit for bit: the port's word view is the stored bytes, so every dtype and
edge must agree exactly."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import fingerprint as jfp
from torchsnapshot_tpu_torch import fingerprint as pfp
from torchsnapshot_tpu_torch.ops import fingerprint as ops

DTYPES = ["bool", "int8", "uint8", "float16", "bfloat16", "float32", "int32", "int64", "float64"]
_BITS = {"bfloat16": np.int16}


def _array(name, shape, seed=0):
    rng = np.random.default_rng(seed)
    if name == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.integers(info.min, info.max, shape, dtype=name, endpoint=True)
    if name == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    return rng.standard_normal(shape).astype(name)


def _tensor(a):
    if a.dtype.name in _BITS:
        return torch.from_numpy(np.array(a).view(_BITS[a.dtype.name])).view(getattr(torch, a.dtype.name))
    return torch.from_numpy(np.array(a, copy=True))


def _port(t, slices=None):
    return pfp.resolve_fingerprints([pfp.fingerprint_device_async(t, slices)])[0]


def _port_chunked(t, chunk_bytes):
    return pfp.resolve_chunk_fingerprints([pfp.fingerprint_device_chunked_async(t, chunk_bytes)])[0]


def _jax_device(a, slices=None):
    # 8-byte dtypes keep their width on the JAX side only with x64 on.
    with jax.enable_x64(True):
        return jfp.format_fingerprint(np.asarray(jfp.fingerprint_device_async(jnp.asarray(a), slices)))


def _jax_device_chunked(a, chunk_bytes):
    with jax.enable_x64(True):
        rows = np.asarray(jfp.fingerprint_device_chunked_async(jnp.asarray(a), chunk_bytes))
    return [jfp.format_fingerprint(r) for r in rows]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [0, 1, 3, 5, 13, 1001])
def test_plain_k4_equals_jax_host_and_device(dtype, n):
    a = _array(dtype, (n,), seed=n)
    want = jfp.fingerprint_host(a)
    assert _port(_tensor(a)) == want
    assert pfp.fingerprint_host(a) == want
    assert pfp.fingerprint_host(_tensor(a)) == want
    assert _jax_device(a) == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk_bytes", [4, 12, 64, 1 << 12])
def test_plain_k5_equals_jax_host_and_device_chunked(dtype, chunk_bytes):
    # 777 elements: no chunk size divides the payload.
    a = _array(dtype, (777,), seed=chunk_bytes)
    want = jfp.fingerprint_host_chunked(a, chunk_bytes)
    assert _port_chunked(_tensor(a), chunk_bytes) == want
    assert pfp.fingerprint_host_chunked(a, chunk_bytes) == want
    assert _jax_device_chunked(a, chunk_bytes) == want
    # Each chunk is the fingerprint of its own byte slice.
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    assert want[-1] == jfp.fingerprint_host(raw[(len(want) - 1) * chunk_bytes :].tobytes())


@pytest.mark.parametrize("dtype", ["int8", "uint8", "bool", "float16", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_views_at_odd_byte_offsets(dtype, offset):
    a = _array(dtype, (301,), seed=offset)
    view = _tensor(a)[offset:]
    assert view.storage_offset() == offset
    assert _port(view) == jfp.fingerprint_host(a[offset:])
    assert _port_chunked(view, 8) == jfp.fingerprint_host_chunked(a[offset:], 8)


@pytest.mark.parametrize(
    "slices",
    [
        (slice(1, 4), slice(None), slice(None)),  # along dim 0: one run
        (slice(None), slice(2, 7), slice(None)),  # along dim 1: runs
        (slice(None), slice(None), slice(1, 4)),  # along the last dim
        (slice(2, 3), slice(4, 5), slice(0, 5)),  # one row: one run
        (slice(1, 4), slice(2, 7), slice(None)),  # two dims cut: copied
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_sub_boxes(slices, dtype):
    a = _array(dtype, (6, 9, 5), seed=3)
    want = jfp.fingerprint_host(np.ascontiguousarray(a[slices]))
    assert _port(_tensor(a), slices) == want
    assert _jax_device(a, slices) == want


def test_box_layouts_of_subdivided_boxes():
    # Runs of equal length at a fixed stride: the description K4 reads.
    assert ops.box_layout([6, 9, 5], 4, [(0, 6), (2, 7), (0, 5)]) == (40, 600, 100, 180)
    assert ops.box_layout([6, 9, 5], 4, [(1, 4), (0, 9), (0, 5)]) == (180, 540, 540, 540)
    assert ops.box_layout([6, 9, 5], 4, [(1, 4), (2, 7), (0, 5)]) is None
    assert ops.box_layout([0, 3], 4, None) == (0, 0, 0, 0)


def test_non_contiguous_tensor_fingerprints_its_c_order_bytes():
    a = _array("float32", (7, 11), seed=4)
    t = _tensor(a).t()
    assert not t.is_contiguous()
    assert _port(t) == jfp.fingerprint_host(np.ascontiguousarray(a.T))
    assert _port_chunked(t, 16) == jfp.fingerprint_host_chunked(np.ascontiguousarray(a.T), 16)


def test_complex_raises_in_both_packages():
    a = np.ones(4, np.complex64)
    with pytest.raises(ValueError):
        pfp.fingerprint_device_async(torch.from_numpy(a))
    with pytest.raises(ValueError):
        pfp.fingerprint_device_chunked_async(torch.from_numpy(a), 8)
    with pytest.raises(ValueError):
        jfp.fingerprint_device_async(jnp.asarray(a))


def test_bad_chunk_bytes_rejected():
    with pytest.raises(ValueError):
        pfp.fingerprint_device_chunked_async(torch.ones(8), 6)
    with pytest.raises(ValueError):
        pfp.fingerprint_host_chunked(np.ones(8), 0)


def test_resolve_batches_and_keeps_per_item_errors():
    ts = [torch.arange(n, dtype=torch.float32) for n in (3, 40, 0)]
    got = pfp.resolve_fingerprints([pfp.fingerprint_device_async(t) for t in ts])
    assert got == [jfp.fingerprint_host(t.numpy()) for t in ts]
    mixed = pfp.resolve_fingerprints([pfp.fingerprint_device_async(ts[0]), object()])
    assert mixed[0] == got[0] and isinstance(mixed[1], Exception)


def test_mulmod_stays_exact_at_the_top_of_the_range():
    a = torch.tensor([0xFFFFFFFF, 0x80000001, 12345], dtype=torch.int64)
    got = ops._mulmod32(a, 0xC2B2AE35).tolist()
    assert got == [(int(x) * 0xC2B2AE35) & 0xFFFFFFFF for x in a.tolist()]


def test_plain_versions_run_in_bounded_batches(monkeypatch):
    # Batches of 64 bytes: words, chunk rows and runs cross batch edges.
    monkeypatch.setattr(ops, "_PLAIN_BATCH_BYTES", 64)
    a = _array("int8", (10, 31), seed=5)
    t = _tensor(a)
    assert _port(t) == jfp.fingerprint_host(a)
    assert _port(t, (slice(None), slice(3, 20))) == jfp.fingerprint_host(np.ascontiguousarray(a[:, 3:20]))
    assert _port_chunked(t, 12) == jfp.fingerprint_host_chunked(a, 12)


# ---- The cases of tests/test_fingerprint.py, through the port.


@pytest.mark.parametrize(
    "dtype,shape",
    [
        ("float32", (17, 33)),
        ("int32", (64,)),
        ("uint8", (123,)),
        ("bool", (37,)),
        ("bfloat16", (9, 11)),
        ("float16", (31,)),
        ("int8", (5, 7, 3)),
    ],
)
def test_host_device_agree(dtype, shape):
    a = _array(dtype, shape)
    h = pfp.fingerprint_host(a)
    assert h.startswith(pfp.FINGERPRINT_ALGO + ":") and len(h.split(":")[1]) == 32
    assert _port(_tensor(a)) == h == jfp.fingerprint_host(a)


def test_deterministic_across_calls():
    x = torch.arange(1000, dtype=torch.float32)
    assert _port(x) == _port(x)
    hx = np.arange(1000, dtype=np.float32)
    assert pfp.fingerprint_host(hx) == pfp.fingerprint_host(hx)


def test_sensitive_to_single_bit_flip():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    y = x.copy()
    y.view(np.uint32)[2048] ^= 1
    assert _port(torch.from_numpy(x)) != _port(torch.from_numpy(y))


def test_sensitive_to_permutation():
    x = torch.arange(256, dtype=torch.float32)
    assert _port(x) != _port(x.flip(0))


def test_sensitive_to_trailing_zeros_vs_shape():
    # The words of [1, 0] and [1] differ only by a zero word, which adds
    # nothing: the entry's shape, not the fingerprint, tells them apart.
    a = torch.tensor([1.0, 0.0])
    b = torch.tensor([1.0])
    assert _port(a) == _port(b) == jfp.fingerprint_host(b.numpy())


def test_bytes_input_matches_array_view():
    x = np.arange(100, dtype=np.int32)
    assert pfp.fingerprint_host(x) == pfp.fingerprint_host(x.tobytes()) == _port(torch.from_numpy(x))


def test_slice_fingerprint_matches_host_subbox():
    x = np.random.default_rng(2).standard_normal((8, 12)).astype(np.float32)
    s = (slice(2, 6), slice(3, 9))
    assert _port(torch.from_numpy(x), s) == pfp.fingerprint_host(np.ascontiguousarray(x[2:6, 3:9]))


def test_empty_array():
    z = torch.zeros((0,))
    assert _port(z) == pfp.format_fingerprint(np.zeros(4, np.uint32)) == jfp.fingerprint_host(z.numpy())
    assert _port_chunked(z, 16) == []


def test_odd_byte_lengths_pad_consistently():
    for n in (1, 2, 3, 5, 7):
        x = np.arange(n, dtype=np.uint8)
        assert pfp.fingerprint_host(x) == _port(torch.from_numpy(x)) == jfp.fingerprint_host(x), n


def test_unpadded_prefix_differs_from_padded():
    # [1,2,3] pads to the word of [1,2,3,0]: the same word stream.
    assert _port(torch.tensor([1, 2, 3], dtype=torch.uint8)) == _port(
        torch.tensor([1, 2, 3, 0], dtype=torch.uint8)
    )
