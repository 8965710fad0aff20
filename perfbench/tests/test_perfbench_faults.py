"""``correct`` comes out false with the timed path broken underneath, and for
the control, at a toy size on the CPU.

Each test drives the rest of a run (``harness.run_cell``, past the look for a
card) with one fault planted: a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; a snapshot's or a
restore's value altered where it is produced, by one element or by two
pieces of a leaf written at each other's offsets; and the control, the plain
reference computed in TF32 put in the program's place. These are the
one-card cells, which have no exchange between chips to leave out; the
faults of a cell laid out a rank per card, that one included, are planted in
every rank by ``test_perfbench_ranks.py``.
"""

import pytest
import torch

from perfbench.reference import dlrm as dlrm_ref
from perfbench.reference import transformer as tf_ref
from perfbench.tests import toy
from torchsnapshot_tpu_torch.models import dlrm, transformer
from torchsnapshot_tpu_torch import snapshot


def _unchanged(monkeypatch, cell):
    def tf_step(params, tokens, cfg, mesh=None, lr=1e-2):
        return params, transformer.loss_fn(params, tokens, cfg).detach()

    def dlrm_step(params, momentum, dense, sparse, labels, cfg, mesh=None, lr=1e-2, beta=0.9):
        return params, momentum, dlrm.loss_fn(params, dense, sparse, labels, cfg).detach()

    monkeypatch.setattr(transformer, "sgd_train_step", tf_step)
    monkeypatch.setattr(dlrm, "sgd_momentum_train_step", dlrm_step)


def _half_batch(monkeypatch, cell):
    tf_step, dlrm_step = transformer.sgd_train_step, dlrm.sgd_momentum_train_step

    def tf_half(params, tokens, cfg, mesh=None, lr=1e-2):
        return tf_step(params, tokens[: tokens.shape[0] // 2], cfg, mesh, lr)

    def dlrm_half(params, momentum, dense, sparse, labels, cfg, mesh=None, lr=1e-2, beta=0.9):
        half = dense.shape[0] // 2
        return dlrm_step(params, momentum, dense[:half], {k: v[:half] for k, v in sparse.items()},
                         labels[:half], cfg, mesh, lr, beta)

    monkeypatch.setattr(transformer, "sgd_train_step", tf_half)
    monkeypatch.setattr(dlrm, "sgd_momentum_train_step", dlrm_half)


def _largest(tree):
    return max(transformer.param_leaves(tree), key=lambda t: t.numel())


def _plus_one(t):
    """One element off by one."""
    out = t.clone()
    out.view(-1)[0] += 1
    return out


def _swapped(t):
    """The leaf's first two halves written at each other's offsets, as a
    split or streamed read that mixes up its pieces would leave it."""
    flat = t.reshape(-1)
    h = flat.numel() // 2
    return torch.cat([flat[h:2 * h], flat[:h], flat[2 * h:]]).view_as(t)


def _wrong_answer(monkeypatch, cell, wrong):
    """A wrong value where the checkpoint produces it, past every checksum
    of the program: the take captures the largest leaf as ``wrong`` makes
    it (take cells), or the restore leaves it so (restore cells)."""
    if cell.endswith("train_async"):
        take = snapshot.Snapshot.async_take.__func__
        states = (transformer.TransformerState, dlrm.DLRMState)
        originals = {cls: cls.state_dict for cls in states}

        def altered(cls):
            def state_dict(self):
                tree = originals[cls](self)
                target = _largest(tree)
                return transformer.map_leaves(lambda t: wrong(t) if t is target else t, tree)
            return state_dict

        def async_take(cls, *args, **kwargs):
            for state in states:
                monkeypatch.setattr(state, "state_dict", altered(state))
            try:
                return take(cls, *args, **kwargs)
            finally:
                for state in states:
                    monkeypatch.setattr(state, "state_dict", originals[state])

        monkeypatch.setattr(snapshot.Snapshot, "async_take", classmethod(async_take))
    else:
        restore = snapshot.Snapshot.restore

        def bad_restore(self, app_state, *args, **kwargs):
            out = restore(self, app_state, *args, **kwargs)
            target = _largest(app_state["model"].state_dict())
            with torch.no_grad():
                target.copy_(wrong(target))
            return out

        monkeypatch.setattr(snapshot.Snapshot, "restore", bad_restore)


def _altered_answer(monkeypatch, cell):
    _wrong_answer(monkeypatch, cell, _plus_one)


def _swapped_pieces(monkeypatch, cell):
    _wrong_answer(monkeypatch, cell, _swapped)


def _control(monkeypatch, cell):
    """The plain reference in TF32 as the training step, on the program's
    own tensors."""
    def tf_step(params, tokens, cfg, mesh=None, lr=1e-2):
        leaves = [p.detach() for p in transformer.param_leaves(params)]
        dm = {"heads": cfg.n_heads, "d": cfg.d_model, "eps": 1e-6, "lr": lr, "layers": cfg.n_layers}
        loss = tf_ref.sgd_step(leaves, tokens, dm, tf32=True)
        return params, torch.tensor(loss)

    def dlrm_step(params, momentum, dense, sparse, labels, cfg, mesh=None, lr=1e-2, beta=0.9):
        dm = {"rows": list(cfg.table_rows.values()), "bottom": [cfg.dense_in, *cfg.bottom_mlp]}
        ps, ms = list(transformer.param_leaves(params)), list(transformer.param_leaves(momentum))
        batch = {"dense": dense, "ids": torch.cat(list(sparse.values()), dim=1), "labels": labels}
        live = [p.detach().requires_grad_() for p in ps]
        value = dlrm_ref.loss(live, batch, dm, tf32=True)
        grads = torch.autograd.grad(value, live)
        with torch.no_grad():
            for p, m, g in zip(ps, ms, grads):
                m.mul_(beta).add_(g)
                p.sub_(lr * m)
        return params, momentum, value.detach()

    monkeypatch.setattr(transformer, "sgd_train_step", tf_step)
    monkeypatch.setattr(dlrm, "sgd_momentum_train_step", dlrm_step)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch, "altered_answer": _altered_answer,
          "swapped_pieces": _swapped_pieces, "control_tf32": _control}
ANSWER_FAULTS = ("altered_answer", "swapped_pieces")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", toy.ONE_CARD)
def test_broken_path_is_not_correct(cell, fault, monkeypatch, tmp_path):
    FAULTS[fault](monkeypatch, cell)
    result = toy.run(cell, tmp_path, seconds=0.5)
    assert result["correct"] is False, result["checks"]
    failing = {name for name, e in result["checks"].items() if not e["value"] <= e["limit"]}
    if fault in ANSWER_FAULTS:
        assert failing & {"snapshot_leaves_differ", "restore_leaves_differ"}
    else:
        assert failing & {"loss_gap", "grad1_gap", "change3_gap"}
