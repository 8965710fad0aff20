"""The port's payload compression (tests/test_compression.py) and chunk
codecs (tests/test_codecs.py), and both crossing between the port and the
JAX package: zlib snapshots restore either way, and the int8 frames of
either package decode in the other to the same bytes."""

import builtins
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import codecs as jcodecs
from torchsnapshot_tpu_torch import Snapshot, StateDict, codecs, io_preparer
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ObjectEntry
from torchsnapshot_tpu_torch.serialization import check_compression, compress_payload, decompress_payload


def _payload(n=5000, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(n).astype(dtype)


# ---- Compression (tests/test_compression.py).


def test_compress_roundtrip_unit():
    payload = b"abc" * 1000
    comp = compress_payload(payload, "zlib")
    assert len(comp) < len(payload)
    assert decompress_payload(comp, "zlib") == payload


def test_unknown_algo_rejected(tmp_path):
    with pytest.raises(ValueError, match="Unknown compression"):
        check_compression("lz77")
    for take in (Snapshot.take, Snapshot.async_take):
        with pytest.raises(ValueError, match="Unknown compression"):
            take(str(tmp_path / "never"), {"s": StateDict(x=1)}, compression="bad")
    assert not os.path.exists(tmp_path / "never")


def test_take_restore_compressed(tmp_path):
    state = {
        "w": torch.arange(64, dtype=torch.float32).repeat(512),
        "b16": torch.zeros((128, 33), dtype=torch.bfloat16),
        "obj": set(range(300)),
        "step": 7,
    }
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)}, compression="zlib")
    target = StateDict(w=torch.zeros(64 * 512), b16=torch.ones((128, 33), dtype=torch.bfloat16), obj=None, step=0)
    Snapshot(str(tmp_path / "snap")).restore({"m": target})
    assert torch.equal(target["w"], state["w"])
    assert torch.equal(target["b16"].view(torch.int16), state["b16"].view(torch.int16))
    assert target["obj"] == state["obj"] and target["step"] == 7


def test_compressed_files_smaller_and_manifest_tagged(tmp_path):
    w = torch.zeros((1024, 256))
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, compression="zlib")
    assert (tmp_path / "snap" / "0" / "m" / "w").stat().st_size < w.numel() * 4 // 100
    entry = Snapshot(str(tmp_path / "snap")).get_manifest()["0/m/w"]
    assert isinstance(entry, ArrayEntry) and entry.compression == "zlib" and entry.checksum is not None


def test_chunked_compressed_restore_into_a_box(tmp_path, monkeypatch):
    """Compressed chunk objects read whole (never ranged or split), and a
    column box of them lands through the whole-object path."""
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 2048)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", "1024")
    data = torch.arange(32, dtype=torch.float32).repeat(64, 1)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=data)}, compression="zlib")
    entry = Snapshot(str(tmp_path / "snap")).get_manifest()["0/m/w"]
    assert len(entry.shards) == 4 and all(s.array.compression == "zlib" for s in entry.shards)
    target = StateDict(w=torch.zeros(64, 32))
    Snapshot(str(tmp_path / "snap")).restore({"m": target})
    assert torch.equal(target["w"], data)


def test_compressed_corruption_detected(tmp_path):
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=torch.arange(4096, dtype=torch.float32))}, compression="zlib")
    stored = tmp_path / "snap" / "0" / "m" / "w"
    payload = bytearray(stored.read_bytes())
    payload[len(payload) // 2] ^= 0xFF
    stored.write_bytes(bytes(payload))
    target = StateDict(w=torch.zeros(4096))
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        Snapshot(str(tmp_path / "snap")).restore({"m": target})
    assert not target["w"].any()


def test_read_object_compressed(tmp_path):
    w = torch.arange(1000, dtype=torch.int64)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w, o={"k", "v"})}, compression="zlib")
    snap = Snapshot(str(tmp_path / "snap"))
    assert torch.equal(snap.read_object("m/w"), w)
    assert snap.read_object("m/o") == {"k", "v"}
    entry = snap.get_manifest()["0/m/o"]
    assert isinstance(entry, ObjectEntry) and entry.compression == "zlib"


def test_mixed_snapshot_restores_uncompressed_entries(tmp_path):
    w = torch.arange(256, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros(256))
    Snapshot(str(tmp_path / "snap")).restore({"m": target})
    assert torch.equal(target["w"], w)
    assert Snapshot(str(tmp_path / "snap")).get_manifest()["0/m/w"].compression is None


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_compressed_snapshots_cross_packages(tmp_path, direction):
    w = np.tile(np.arange(64, dtype=np.float32), 100)
    b16 = np.random.RandomState(1).randn(33, 7).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "snap")
    if direction == "jax->port":
        jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=w, b16=b16, o={"a", "b"})}, compression="zlib")
        target = StateDict(w=torch.zeros(6400), b16=torch.zeros((33, 7), dtype=torch.bfloat16), o=None)
        Snapshot(path).restore({"m": target})
        got_w, got_b = target["w"].numpy(), target["b16"].view(torch.int16).numpy()
        assert target["o"] == {"a", "b"}
    else:
        b16_t = torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16)
        Snapshot.take(path, {"m": StateDict(w=torch.from_numpy(w.copy()), b16=b16_t, o={"a", "b"})}, compression="zlib")
        target = jsnap.StateDict(w=np.zeros_like(w), b16=np.zeros_like(b16), o=None)
        jsnap.Snapshot(path).restore({"m": target})
        assert jsnap.Snapshot(path).verify() == {}
        got_w, got_b = target["w"], np.asarray(target["b16"]).view(np.int16)
        assert target["o"] == {"a", "b"}
    assert np.array_equal(got_w, w)
    assert np.array_equal(got_b, b16.view(np.int16))


# ---- Codecs (tests/test_codecs.py).


def test_zlib_round_trip_bit_exact():
    raw = _payload().tobytes()
    assert codecs.decode("zlib", codecs.encode("zlib", raw)) == raw


def test_identity():
    raw = b"abc" * 100
    assert codecs.encode(None, raw) == raw == codecs.decode(None, raw) == codecs.encode("identity", raw)


def test_zstd_round_trip_or_unavailable():
    raw = _payload().tobytes()
    if "zstd" in codecs.available_codecs():
        assert codecs.decode("zstd", codecs.encode("zstd", raw)) == raw
        assert jcodecs.decode("zstd", codecs.encode("zstd", raw)) == raw
    else:
        with pytest.raises(codecs.CodecUnavailable):
            codecs.check_codec("zstd")


def test_zstd_drops_out_without_a_backend(monkeypatch):
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name.split(".")[0] in ("zstandard", "compression"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", blocked)
    codecs._zstd.cache_clear()
    try:
        assert codecs.lossless_codecs() == ("zlib",)
        assert codecs.best_lossless() == "zlib"
        with pytest.raises(codecs.CodecUnavailable):
            codecs.check_codec("zstd")
        with pytest.raises(codecs.CodecUnavailable):
            codecs.decode("zstd", b"x")
    finally:
        monkeypatch.undo()
        codecs._zstd.cache_clear()


def test_best_lossless_is_usable():
    name = codecs.best_lossless()
    raw = _payload().tobytes()
    assert codecs.decode(name, codecs.encode(name, raw)) == raw


def test_unknown_codec_rejected():
    with pytest.raises(ValueError):
        codecs.encode("lzma9000", b"x")
    with pytest.raises(ValueError):
        codecs.check_codec("lzma9000")


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "float64"])
def test_int8_within_documented_tolerance_and_equal_to_jax(dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = _payload(4096 + 17, seed=3).astype(np_dtype)
    enc = codecs.encode("int8", arr.tobytes(), dtype)
    assert enc == jcodecs.encode("int8", arr.tobytes(), dtype)
    dec = np.frombuffer(codecs.decode("int8", enc, dtype), np_dtype)
    assert codecs.decode("int8", enc, dtype) == jcodecs.decode("int8", enc, dtype)
    err = np.abs(dec.astype(np.float32) - arr.astype(np.float32)).max()
    bound = codecs.quant_error_bound(arr.astype(np.float32), dtype_name=dtype)
    assert bound == jcodecs.quant_error_bound(arr.astype(np.float32), dtype_name=dtype)
    assert 0 < err <= bound


def test_ratio_roughly_4x_for_float32():
    raw = _payload(1 << 16).tobytes()
    assert len(codecs.encode("int8", raw, "float32")) < 0.3 * len(raw)


def test_constant_block_is_exact():
    arr = np.full(2048, 3.25, np.float32)
    dec = np.frombuffer(codecs.decode("int8", codecs.encode("int8", arr.tobytes(), "float32"), "float32"), np.float32)
    assert np.array_equal(dec, arr)


def test_nonfinite_payload_unsuitable():
    arr = _payload(2048)
    arr[100] = np.inf
    with pytest.raises(codecs.CodecUnsuitable):
        codecs.encode("int8", arr.tobytes(), "float32")


def test_int_dtype_unsuitable():
    with pytest.raises(codecs.CodecUnsuitable):
        codecs.encode("int8", np.arange(2048, dtype=np.int32).tobytes(), "int32")


def test_frame_self_verifies():
    enc = bytearray(codecs.encode("int8", _payload(2048).tobytes(), "float32"))
    enc[-1] ^= 0xFF
    with pytest.raises(RuntimeError, match="crc"):
        codecs.decode("int8", bytes(enc), "float32")


def test_non_frame_bytes_rejected():
    with pytest.raises(RuntimeError, match="TSQ1"):
        codecs.decode("int8", b"not a frame at all", "float32")


def test_none_spec_is_identity(monkeypatch):
    monkeypatch.delenv("TPUSNAPSHOT_CODEC", raising=False)
    assert codecs.resolve_codec_plan(None).codec_for("model/w") is None


def test_bare_name_applies_everywhere():
    plan = codecs.resolve_codec_plan("zlib")
    assert plan.codec_for("model/w") == plan.codec_for("opt/mu/w") == "zlib"


def test_glob_mapping_specific_first():
    plan = codecs.resolve_codec_plan({"opt/*": "int8", "*": "zlib"})
    assert plan.codec_for("opt/mu/w", dtype_name="float32") == "int8"
    assert plan.codec_for("model/w", dtype_name="float32") == "zlib"


def test_env_string_form(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_CODEC", "opt/*=int8,*=zlib")
    plan = codecs.resolve_codec_plan(None)
    assert plan.codec_for("opt/nu/w", dtype_name="float32") == "int8"
    assert plan.codec_for("model/w") == "zlib"
    assert plan.rules == jcodecs.resolve_codec_plan(None).rules


def test_lossy_fallback_rejected():
    for spec in ("int8", {"*": "int8"}):
        with pytest.raises(ValueError, match="explicit per-leaf glob"):
            codecs.resolve_codec_plan(spec)


def test_lossy_degrades_on_unquantizable_leaf():
    plan = codecs.resolve_codec_plan({"opt/*": "int8"})
    assert plan.codec_for("opt/step", dtype_name="int64") is None
    assert plan.codec_for("opt/key", dtype_name="uint32", prng_impl="threefry2x32") is None


def test_lossy_degrade_falls_through_to_fallback_rule():
    plan = codecs.resolve_codec_plan({"opt/*": "int8", "*": "zlib"})
    assert plan.codec_for("opt/step", dtype_name="int64") == "zlib"
    assert plan.codec_for("opt/key", dtype_name="uint32", prng_impl="threefry2x32") == "zlib"
    assert plan.codec_for("opt/mu", dtype_name="float32") == "int8"


def test_identity_aliases():
    assert codecs.resolve_codec_plan({"*": "none"}).codec_for("model/w") is None
