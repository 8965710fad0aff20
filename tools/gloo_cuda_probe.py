#!/usr/bin/env python3
"""Which collectives a gloo process group takes CUDA tensors for, and
which backend the dims of a multi-dim CUDA DeviceMesh get over a gloo
world. Run on a machine with one GPU:

    python3 tools/gloo_cuda_probe.py

A world of 2 for each collective that the port's sequence-parallel
helpers use (``torchsnapshot_tpu_torch/parallel/collectives.py``) tries
it with CUDA tensors on ``cuda:0`` and records whether it ran and gave
the right values, or that gloo killed the ranks; a world of 4 builds
``init_device_mesh("cuda", (1, 2, 2))``. Prints one JSON line each. The port stages CUDA tensors through host
memory on every gloo group whatever this prints; the probe says what
gloo itself would have done.
"""

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess  # noqa: E402


def _attempt(fn):
    """"ok", "wrong values", or the first line of the error raised."""
    try:
        return "ok" if fn() else "wrong values"
    except Exception as e:  # a probe: every outcome is the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _p2p(x, rank):
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return bool((got == 2 - rank).all())


def _all_to_all(x, rank):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return bool((out[:2] == 1).all() and (out[2:] == 2).all())


def _all_reduce(x, rank):
    y = x.clone()
    dist.all_reduce(y)
    return bool((y == 3).all())


def _all_gather(x, rank):
    out = torch.empty(8, device="cuda")
    dist.all_gather_into_tensor(out, x)
    return bool((out[:4] == 1).all() and (out[4:] == 2).all())


def _reduce_scatter(x, rank):
    out = torch.empty(2, device="cuda")
    dist.reduce_scatter_tensor(out, x)
    return bool((out == 3).all())


COLLECTIVES = {
    "batch_isend_irecv": _p2p,
    "all_to_all_single": _all_to_all,
    "all_reduce": _all_reduce,
    "all_gather_into_tensor": _all_gather,
    "reduce_scatter_tensor": _reduce_scatter,
}


def collective(rank, world, name, out_dir):
    """One collective on CUDA tensors, in a world of its own: gloo may
    abort the process on a device pointer (an IoException thrown on its
    own thread), and a failed collective closes the group's connections."""
    torch.cuda.set_device(0)
    x = torch.full((4,), float(rank + 1), device="cuda")
    result = _attempt(lambda: COLLECTIVES[name](x, rank))
    with open(os.path.join(out_dir, f"{name}_{rank}.json"), "w") as f:
        json.dump(result, f)


def mesh(rank, world, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    record = {}
    try:
        m = init_device_mesh("cuda", (1, 2, 2), mesh_dim_names=("dp", "sp", "tp"))
        record["backends"] = {n: str(dist.get_backend(m.get_group(n))) for n in ("dp", "sp", "tp")}
        y = torch.ones(2, device="cuda")
        record["sp_all_reduce"] = _attempt(lambda: dist.all_reduce(y, group=m.get_group("sp")) or True)
    except Exception as e:  # a probe: every outcome is the finding
        record["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    with open(os.path.join(out_dir, f"mesh_{rank}.json"), "w") as f:
        json.dump(record, f)


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as out_dir:
        results = {}
        for name in COLLECTIVES:
            try:
                run_multiprocess(collective, 2, (name, out_dir), timeout_s=120)
            except RuntimeError as e:  # the ranks died, as gloo aborts them
                results[name] = "ranks died: " + " | ".join(str(e).splitlines()[1:3])
                continue
            with open(os.path.join(out_dir, f"{name}_0.json")) as f:
                results[name] = json.load(f)
        print(json.dumps({"probe": "collectives", "world": 2, "torch": torch.__version__,
                          "results": results}), flush=True)
        run_multiprocess(mesh, 4, (out_dir,), timeout_s=120)
        records = []
        for rank in range(4):
            with open(os.path.join(out_dir, f"mesh_{rank}.json")) as f:
                records.append(json.load(f))
        print(json.dumps({"probe": "mesh", "world": 4, "torch": torch.__version__,
                          "ranks": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
