"""The port's synthetic DDP model against the JAX package's: the same
state-dict names and sizes, and the same arrays crossing both packages
bit for bit, replicated as the DDP benchmark takes them."""

import jax
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.models.ddp_synthetic import SyntheticModel as JaxSyntheticModel
from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.models.ddp_synthetic import SyntheticModel


def test_state_dict_names_and_sizes_follow_jax():
    model = SyntheticModel(n_params=3, param_bytes=256, seed=0, device="cpu")
    jmodel = JaxSyntheticModel(n_params=3, param_bytes=256, seed=0)
    assert list(model.state_dict()) == list(jmodel.state_dict()) == ["param_0", "param_1", "param_2"]
    for t, a in zip(model.state_dict().values(), jmodel.state_dict().values()):
        assert tuple(t.shape) == a.shape == (64,) and t.dtype == torch.float32
    assert model.total_bytes() == jmodel.total_bytes() == 768
    again = SyntheticModel(n_params=3, param_bytes=256, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.params.values(), again.params.values()))


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticModel(n_params=1, param_bytes=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_model_crosses_both_ways(tmp_path, dtype):
    import jax.numpy as jnp

    jmodel = JaxSyntheticModel(n_params=4, param_bytes=512, dtype=getattr(jnp, dtype), seed=3)
    arrays = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    jsnap.Snapshot.take(str(tmp_path / "jax"), {"model": jmodel}, replicated=["**"])
    target = SyntheticModel(n_params=4, param_bytes=512, dtype=getattr(torch, dtype), seed=1, device="cpu")
    Snapshot(str(tmp_path / "jax")).restore({"model": target})
    for k, a in arrays.items():
        assert target.params[k].contiguous().view(torch.uint8).numpy().tobytes() == a.tobytes()

    model = SyntheticModel.from_numpy(arrays, device="cpu")
    Snapshot.take(str(tmp_path / "port"), {"model": model}, replicated=["**"])
    other = JaxSyntheticModel(n_params=4, param_bytes=512, dtype=getattr(jnp, dtype), seed=5)
    jsnap.Snapshot(str(tmp_path / "port")).restore({"model": other})
    for k, a in arrays.items():
        assert np.asarray(other.params[k]).tobytes() == a.tobytes()
        assert isinstance(other.params[k], jax.Array)


def test_replicated_take_is_striped_over_the_ranks(tmp_path):
    from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

    path = str(tmp_path / "ddp")

    def take(coord, rank):
        Snapshot.take(path, {"model": SyntheticModel(n_params=6, param_bytes=1024, seed=0, device="cpu")},
                      coord=coord, replicated=["**"])

    run_thread_ranks(2, take)
    manifest = Snapshot(path).get_manifest()
    # The writing owner's entry carries the checksum: three parameters each.
    owned = [sum(1 for p, e in manifest.items() if p.startswith(f"{r}/model/") and e.checksum)
             for r in (0, 1)]
    assert owned == [3, 3]
    assert len(list((tmp_path / "ddp" / "replicated" / "model").iterdir())) == 6
    target = SyntheticModel(n_params=6, param_bytes=1024, seed=1, device="cpu")
    Snapshot(path).restore({"model": target})
    expected = SyntheticModel(n_params=6, param_bytes=1024, seed=0, device="cpu")
    assert all(torch.equal(target.params[k], expected.params[k]) for k in expected.params)
