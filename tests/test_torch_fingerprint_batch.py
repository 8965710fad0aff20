"""The batched xs128 fingerprints (K4, K5) on the CPU: the host-built
segment table (every word of every segment covered once, indices
restarting at each segment, the fast/general split), a numpy emulation
of the kernel over that table against ``fingerprint_host``, the batched
wrappers against the JAX package's device functions resolved on the
CPU, and the takes and restores that dispatch a batch (incremental,
chunk store, ``verify_device``) against the JAX package on the same
state. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import fingerprint as jfp
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import fingerprint as pfp
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.ops import fingerprint as ops

_GOLD, _M1, _M2 = np.uint32(ops.GOLD), np.uint32(ops.M1), np.uint32(ops.M2)
_TILE_VECS = ops.TILE_WORDS // 4


# ------------------------------------------------------------ the table


def _weights(index):
    """(4, n) u32 weights of u32 word indices."""
    out = []
    for salt in ops.SALTS:
        h = index * _GOLD + np.uint32(salt)
        h ^= h >> np.uint32(16)
        h *= _M1
        h ^= h >> np.uint32(13)
        h *= _M2
        h ^= h >> np.uint32(16)
        out.append(h)
    return np.stack(out)


def _stream_bytes(memory, addr, total, run, stride, j0, j1):
    """Bytes [j0, j1) of a segment's stream, zero past its end."""
    j = np.arange(j0, j1, dtype=np.int64)
    inside = j < total
    if run >= total:
        pos = addr + j
    else:
        pos = addr + (j // run) * stride + j % run
    return np.where(inside, memory[np.where(inside, pos, 0)], 0).astype(np.uint8)


def _emulate(plan, memory, n_rows):
    """Run the kernel's schedule over ``plan`` in numpy: (the (n_rows, 4)
    u32 lanes, per row the count of times each word index was summed)."""
    sec = plan.sections()
    out = np.zeros((n_rows, 4), dtype=np.uint32)
    seen = {}

    def add(row, first_word, words):
        idx = np.arange(first_word, first_word + words.size, dtype=np.int64)
        w = _weights(idx.astype(np.uint32))
        out[row] += (words[None, :] * w).sum(axis=1, dtype=np.uint32)
        counts = seen.setdefault(row, {})
        for i in idx.tolist():
            counts[i] = counts.get(i, 0) + 1

    for g in range(plan.n_groups):
        segs = range(sec["group_first"][g], sec["group_last"][g])
        assert 1 <= len(segs) <= ops.GROUP
        vecs = sec["fast_vecs"][list(segs)]
        assert (np.diff(vecs) <= 0).all(), "a group is sorted by length"
        tile0, n_tiles, per = sec["group_tile0"][g], sec["group_tiles"][g], sec["group_per"][g]
        blocks = range(sec["group_block"][g], sec["group_block"][g + 1])
        assert len(blocks) == -(-n_tiles // per) and per >= 1
        for b in blocks:
            begin = tile0 + (b - blocks[0]) * per
            for t in range(begin, min(begin + per, tile0 + n_tiles)):
                lo = t * _TILE_VECS
                assert vecs[0] > lo, "the first segment reaches every tile of its group"
                for s in segs:
                    n = sec["fast_vecs"][s]
                    if n <= lo:
                        break
                    hi = min(n, lo + _TILE_VECS)
                    a = sec["fast_addr"][s]
                    assert a % 16 == 0
                    add(sec["fast_row"][s], 4 * lo, memory[a + 16 * lo : a + 16 * hi].view(np.uint32))
    for x in range(plan.n_general):
        assert sec["gen_block"][x + 1] - sec["gen_block"][x] == -(-(sec["gen_w1"][x] - sec["gen_w0"][x])
                                                                  // ops.GENERAL_BLOCK_WORDS)
        raw = _stream_bytes(memory, sec["gen_addr"][x], sec["gen_total"][x], sec["gen_run"][x],
                            sec["gen_stride"][x], 4 * sec["gen_w0"][x], 4 * sec["gen_w1"][x])
        add(sec["gen_row"][x], sec["gen_w0"][x], raw.view(np.uint32))
    return out, seen


def _case(name, rng):
    """(memory, segments as (addr, total, run, stride) rows, the bytes of
    each segment in C order) for one table case."""
    specs = []  # (misalignment, bytes) or ("box", rows, cols, c0, c1, itemsize)
    if name == "edges":
        tile = ops.TILE_WORDS
        specs = [(0, 4 * w) for w in (0, 1, 3, 4095, 4096, 4097, tile - 1, tile, tile + 1, 2 * tile + 1)]
        specs += [(0, 4 * 4097 + 3), (0, 5), (0, 17)]
    elif name in ("long_beside_short", "runs_of_tiles"):
        specs = [(0, 4 * 200_000)] + [(0, 4 * 1000)] * 40
    elif name == "fast_general_split":
        specs = [(0, 4 * 5000 + 6), (4, 4 * 5000), (1, 4 * 5000 + 1), (8, 64), (2, 3),
                 ("box", 40, 129, 5, 77, 4), ("box", 40, 129, 1, 2, 1), ("box", 40, 96, 0, 48, 2)]
    memory_parts, segments, payloads, cursor = [], [], [], 0
    for spec in specs:
        if spec[0] == "box":
            _, rows, cols, c0, c1, itemsize = spec
            matrix = rng.integers(0, 256, (rows, cols * itemsize), dtype=np.uint8)
            layout = ops.box_layout((rows, cols), itemsize, [(0, rows), (c0, c1)])
            offset, total, run, stride = layout
            block = matrix.reshape(-1)
            segments.append((cursor + offset, total, run, stride))
            payloads.append(np.ascontiguousarray(matrix[:, c0 * itemsize : c1 * itemsize]).reshape(-1))
        else:
            mis, nbytes = spec
            block = np.concatenate([rng.integers(0, 256, mis, dtype=np.uint8),
                                    rng.integers(0, 256, nbytes, dtype=np.uint8)])
            segments.append((cursor + mis, nbytes, nbytes, nbytes))
            payloads.append(block[mis:])
        pad = (-block.size) % 16 + 16
        memory_parts += [block, rng.integers(0, 256, pad, dtype=np.uint8)]
        cursor += block.size + pad
    return np.concatenate(memory_parts), np.asarray(segments, dtype=np.int64).reshape(-1, 4), payloads


def _chunk_case(rng):
    """Three tensors of different chunk counts (one empty), chunked as K5 plans them."""
    sizes = [4 * 9000 + 2, 0, 4 * 3000]
    memory = np.concatenate([rng.integers(0, 256, n + (-n) % 16 + 16, dtype=np.uint8) for n in sizes])
    starts = np.cumsum([0] + [n + (-n) % 16 + 16 for n in sizes[:-1]])
    chunk = np.asarray([4096, 4096, 4100], dtype=np.int64)
    addr, length, first_row, n_chunks = ops._chunk_segments(
        starts.astype(np.int64), np.asarray(sizes, dtype=np.int64), chunk)
    payloads = [memory[a : a + n] for a, n in zip(addr, length)]
    return memory, np.stack([addr, length, length, length], axis=1), payloads, (first_row, n_chunks, sizes, chunk)


@pytest.mark.parametrize("name", ["edges", "long_beside_short", "runs_of_tiles", "fast_general_split", "chunks"])
def test_the_table_covers_every_word_once_and_matches_the_host(name, monkeypatch):
    if name == "runs_of_tiles":
        # Few blocks wanted: each block runs over several tiles.
        monkeypatch.setattr(ops, "RUN_BLOCKS", 3)
    rng = np.random.default_rng(12)
    if name == "chunks":
        memory, segs, payloads, (first_row, n_chunks, sizes, chunk) = _chunk_case(rng)
        assert n_chunks.tolist() == [-(-n // int(c)) for n, c in zip(sizes, chunk)]
        assert first_row.tolist() == [0, n_chunks[0], n_chunks[0]]
    else:
        memory, segs, payloads = _case(name, rng)
    plan = ops.plan_segments(segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3], np.arange(len(segs)))
    lanes, seen = _emulate(plan, memory, len(segs))
    for row, payload in enumerate(payloads):
        words = -(-payload.size // 4)
        counts = seen.get(row, {})
        assert sorted(counts) == list(range(words)), row
        assert set(counts.values()) <= {1}, row
        assert pfp.format_fingerprint(lanes[row]) == pfp.fingerprint_host(payload), row
    assert plan.fast_words + plan.general_words == sum(-(-p.size // 4) for p in payloads)
    if name == "runs_of_tiles":
        per = plan.sections()["group_per"]
        assert per.max() > 1 and plan.fast_blocks < sum(plan.sections()["group_tiles"])
    if name == "fast_general_split":
        sec = plan.sections()
        # A 16-byte-aligned contiguous segment takes the fast path and its
        # tail the general one; the rest go to the general path, by words
        # where base, run and stride allow.
        assert sec["fast_row"].tolist() == [0]
        modes = dict(zip(sec["gen_row"].tolist(), sec["gen_mode"].tolist()))
        assert modes == {0: ops.MODE_WORD, 1: ops.MODE_WORD, 2: ops.MODE_BYTES, 3: ops.MODE_WORD,
                         4: ops.MODE_BYTES, 5: ops.MODE_WORD, 6: ops.MODE_BYTES, 7: ops.MODE_WORD}
        assert sec["gen_w0"][sec["gen_row"] == 0].tolist() == [5000]
    if name == "long_beside_short":
        # 41 segments in two runs of GROUP: the first run's tile shared by
        # its 32 segments, the long segment's other tiles alone, and the
        # second run's tile shared by its 9.
        sec = plan.sections()
        assert sec["group_tiles"].tolist() == [1, -(-200_000 // ops.TILE_WORDS) - 1, 1]
        assert (sec["group_last"] - sec["group_first"]).tolist() == [32, 1, 9]
        assert plan.weight_indices == 2 * ops.TILE_WORDS
        assert plan.lone_words == 200_000 - ops.TILE_WORDS


# ------------------------------------------------------- the wrappers


_BITS = {"bfloat16": np.int16}


def _array(name, shape, seed):
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


def _jax_box(a, box):
    slices = None if box is None else tuple(slice(lo, hi) for lo, hi in box)
    with jax.enable_x64(True):
        return jfp.format_fingerprint(np.asarray(jfp.fingerprint_device_async(jnp.asarray(a), slices)))


def _jax_chunked(a, chunk_bytes):
    with jax.enable_x64(True):
        rows = np.asarray(jfp.fingerprint_device_chunked_async(jnp.asarray(a), chunk_bytes))
    return [jfp.format_fingerprint(r) for r in rows]


def _mixed_batch():
    """(numpy array, tensor, box) triples: every dtype, an empty and odd
    lengths, a 1-byte view at an odd offset, boxes, one tensor twice."""
    arrays = [_array(d, (n,), seed=i) for i, (d, n) in enumerate(
        [("bool", 13), ("int8", 4097), ("uint8", 3), ("float16", 1001), ("bfloat16", 5), ("float32", 70_000),
         ("int32", 0), ("int64", 333), ("float64", 17)])]
    items = [(a, _tensor(a), None) for a in arrays]
    base = _array("int8", (100_003,), seed=99)
    items.append((base[1:], _tensor(base)[1:], None))
    m = _array("float32", (64, 129), seed=7)
    mt = _tensor(m)
    items += [(m, mt, [(3, 40), (0, 129)]), (m, mt, [(0, 64), (5, 77)]), (m, mt, [(0, 64), (1, 2)])]
    items.append(items[5])
    return items


def test_fingerprint_boxes_equals_jax_and_host_item_by_item():
    items = _mixed_batch()
    rows = ops.fingerprint_boxes([(t, box) for _, t, box in items])
    assert rows.shape == (len(items), 4) and rows.dtype == torch.int32
    got = pfp.resolve_fingerprints(list(rows))
    for (a, _, box), fp in zip(items, got):
        host = a if box is None else a[tuple(slice(lo, hi) for lo, hi in box)]
        assert fp == jfp.fingerprint_host(np.ascontiguousarray(host)) == _jax_box(a, box)
    # The caller's batch, with a non-contiguous tensor and a box cut along
    # two dims (both copied first), equals the same fingerprints.
    many = pfp.fingerprint_device_many_async(
        [(t, None if box is None else tuple(slice(lo, hi) for lo, hi in box)) for _, t, box in items]
        + [(items[-2][1].t(), None), (items[-2][1], (slice(3, 9), slice(2, 5)))])
    assert pfp.resolve_fingerprints(many)[: len(items)] == got
    assert pfp.resolve_fingerprints(many)[len(items):] == [
        pfp.fingerprint_host(np.ascontiguousarray(items[-2][0].T)),
        pfp.fingerprint_host(np.ascontiguousarray(items[-2][0][3:9, 2:5]))]


@pytest.mark.parametrize("chunk_bytes", [12, 4096, "per_item"])
def test_fingerprint_chunked_many_equals_jax_and_host_item_by_item(chunk_bytes):
    items = [(a, t) for a, t, box in _mixed_batch() if box is None]
    sizes = [4096 + 4 * (i % 3) for i in range(len(items))] if chunk_bytes == "per_item" else [chunk_bytes] * len(items)
    arg = sizes if chunk_bytes == "per_item" else chunk_bytes
    got = ops.fingerprint_chunked_many([t for _, t in items], arg)
    many = pfp.fingerprint_device_chunked_many_async([t for _, t in items], arg)
    assert pfp.resolve_chunk_fingerprints(many) == pfp.resolve_chunk_fingerprints(got)
    for (a, _), rows, cb in zip(items, pfp.resolve_chunk_fingerprints(got), sizes):
        assert rows == jfp.fingerprint_host_chunked(a, cb) == _jax_chunked(a, cb)


@pytest.mark.parametrize("kind", ["boxes", "chunked"])
def test_a_batch_launches_early_where_its_copies_pass_the_cap(monkeypatch, kind):
    """Non-contiguous tensors are copied before their launch; a copy
    that would pass ``COPY_BYTES_PER_LAUNCH`` first launches the batch
    so far, which releases its copies. Results are those of one batch."""
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((64, 64)).astype(np.float32) for _ in range(8)]
    copied = {1, 2, 3, 5, 6, 7}  # given transposed: each a 16 KiB copy
    tensors = [torch.from_numpy(a.T.copy()).t() if i in copied else torch.from_numpy(a)
               for i, a in enumerate(arrays)]
    assert [not t.is_contiguous() for t in tensors] == [i in copied for i in range(8)]
    name = "fingerprint_boxes" if kind == "boxes" else "fingerprint_chunked_many"
    real, sizes = getattr(ops, name), []

    def counted(batch, *args):
        sizes.append(len(batch))
        return real(batch, *args)

    monkeypatch.setattr(ops, name, counted)

    def run():
        if kind == "boxes":
            return pfp.resolve_fingerprints(pfp.fingerprint_device_many_async([(t, None) for t in tensors]))
        return pfp.resolve_chunk_fingerprints(pfp.fingerprint_device_chunked_many_async(tensors, 4096))

    whole = run()
    assert sizes == [8]
    sizes.clear()
    monkeypatch.setattr(pfp, "COPY_BYTES_PER_LAUNCH", 40 << 10)  # two copies and a half
    assert run() == whole and sizes == [3, 3, 2]
    want = ([pfp.fingerprint_host(a) for a in arrays] if kind == "boxes"
            else [pfp.fingerprint_host_chunked(a, 4096) for a in arrays])
    assert whole == want


def test_a_batch_lies_on_one_device_and_takes_contiguous_tensors():
    cpu, meta = torch.zeros(8), torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="one device"):
        ops.fingerprint_boxes([(cpu, None), (meta, None)])
    with pytest.raises(ValueError, match="one device"):
        ops.fingerprint_chunked_many([cpu, meta], 4096)
    with pytest.raises(ValueError, match="chunk sizes"):
        ops.fingerprint_chunked_many([cpu, cpu], [4096])
    assert ops.fingerprint_boxes([]).shape == (0, 4) and ops.fingerprint_chunked_many([], 4096) == []


# ------------------------------------------------- the batched callers


def _model_arrays(seed=3):
    """A small model's state in several dtypes (numpy, for both packages)."""
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((257, 32)).astype(np.float32),
        "w1": rng.standard_normal((32, 64)).astype(ml_dtypes.bfloat16),
        "b1": rng.standard_normal(33).astype(np.float16),
        "w2": rng.standard_normal((64, 32)).astype(np.float32),
        "table": rng.integers(-128, 128, 1001, dtype=np.int8),
        "counts": rng.integers(0, 1 << 40, 7, dtype=np.int64),
    }


def _port_state(arrays):
    return {"model": StateDict(**{k: _tensor(v) for k, v in arrays.items()})}


def _jax_state(arrays):
    return {"model": jsnap.StateDict(**{k: v.copy() for k, v in arrays.items()})}


def _fingerprints(manifest):
    return {k: e.fingerprint for k, e in manifest.items() if getattr(e, "fingerprint", None)}


def _chunk_keys(manifest):
    return {k: [r["k"] for r in e.chunks] for k, e in manifest.items() if getattr(e, "chunks", None)}


@pytest.mark.parametrize("kind", ["incremental", "chunks", "verify_device"])
def test_batched_takes_and_restores_match_the_jax_package(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    arrays = _model_arrays()
    changed = dict(arrays, w2=arrays["w2"] + np.float32(1))
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    if kind == "incremental":
        p1 = Snapshot.take(f"{port}-1", _port_state(arrays), fingerprint=True)
        j1 = jsnap.Snapshot.take(f"{jax_}-1", _jax_state(arrays), fingerprint=True)
        p2 = Snapshot.take(f"{port}-2", _port_state(changed), base=p1)
        j2 = jsnap.Snapshot.take(f"{jax_}-2", _jax_state(changed), base=j1)
        for p, j in ((p1, j1), (p2, j2)):
            want = _fingerprints(j.get_manifest())
            assert len(want) == len(arrays) and _fingerprints(p.get_manifest()) == want
    elif kind == "chunks":
        p = Snapshot.take(port, _port_state(arrays), chunks=True)
        j = jsnap.Snapshot.take(jax_, _jax_state(arrays), chunks=True)
        want = _chunk_keys(j.get_manifest())
        assert len(want) == len(arrays) and _chunk_keys(p.get_manifest()) == want
    else:
        Snapshot.take(port, _port_state(arrays), fingerprint=True)
        jsnap.Snapshot.take(jax_, _jax_state(arrays), fingerprint=True)
        for path in (port, jax_):
            target = _port_state({k: np.zeros_like(v) for k, v in arrays.items()})
            Snapshot(path).restore(target, verify_device=True)
            assert snapshot_mod._last_verify_stats == {"verified": len(arrays), "skipped": 0}
            for k, v in arrays.items():
                assert torch.equal(_tensor(v), target["model"][k]), k
