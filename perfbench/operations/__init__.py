"""Checkpoint operations that open a traffic mix's cycles, one module each,
found by the mix's ``operation`` name.

A module defines ``Operation(window, call)``, where ``call`` holds the
mix's keyword arguments for the manager's call, with:

- ``prepare()``: set-up's checkpoint work (a warm-up call, a snapshot to
  roll back to);
- ``run(cycle, last)``: the operation that opens a cycle, inside the
  cycle's span; ``last`` is true in the window's last cycle;
- ``finish()``: after the window, the exact comparisons as
  ``{name: count}``, each held to the limit 0;
- optionally ``drains`` (``DrainWatch``-like objects with ``returned`` and
  ``done_at``) and ``restore_reports``, which per-layer readers read.

Its blocking calls are spans of ``window.rec``; its checks run inside
``window.check(cycle)``, which the window's seconds leave out.
"""
