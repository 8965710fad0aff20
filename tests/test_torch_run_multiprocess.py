"""``run_multiprocess``, the spawned gloo launcher of the port's
multi-rank tests and examples: a failing rank's traceback surfaces, and a
rank that hangs, even one that left a half-written failure report, is
killed at the shared deadline instead of blocking the caller.

Before, the ranks reported through a ``multiprocessing.Queue``, and the
caller drained it with ``get(timeout=0.1)`` after killing hung ranks; a
rank killed while writing its traceback into the queue's pipe left a
partial message that ``get`` waited on forever (its body read has no
timeout). The reports are files now, renamed into place whole."""

import time

import pytest

import torch_rank_workers as workers
from torchsnapshot_tpu_torch.utils import test_utils
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess


def test_failing_rank_is_named_with_its_traceback():
    begin = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_multiprocess(workers.fail_on_rank, 2, (1,), timeout_s=120)
    message = str(err.value)
    assert "rank 1:" in message and "ValueError: rank 1 fails on purpose" in message
    # Rank 0 waited in a barrier: it is killed after the grace, not at the
    # deadline.
    assert time.monotonic() - begin < 120


def test_hung_rank_with_a_torn_report_is_killed_at_the_deadline(tmp_path, monkeypatch):
    """The hung rank leaves a half-written report beside where its whole
    one would go; the caller ignores it and returns at the deadline."""
    monkeypatch.setattr(test_utils.tempfile, "tempdir", str(tmp_path))
    begin = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_multiprocess(
            workers.hang_after_torn_report, 2, (str(tmp_path / "run_multiprocess-*"),),
            timeout_s=20,
        )
    assert "still running after 20s; killed" in str(err.value)
    assert "Traceback" not in str(err.value)
    assert time.monotonic() - begin < 20 + 30
