"""Snapshot inspection CLI.

Usage::

    python -m torchsnapshot_tpu_torch.inspect <snapshot-path> [--rank N] [--raw]

Prints the rank-local view of the manifest, one line an entry: its type,
dtype and shape (arrays), chunk count (sharded arrays), byte size and
location; ``--raw`` prints the whole rank-prefixed manifest. The lines
are the JAX package's ``inspect`` lines for the same snapshot.

Other modes, one at a time: ``--verify`` (scrub every payload; exit 1 on
a bad object), ``--copy-to DEST``, ``--diff OLDER`` (exit 1 when
something changed, 3 when only inconclusive), ``--delete [--sweep]``,
and, with PATH a ``CheckpointManager`` directory, ``--steps`` and
``--reconcile {adopt,sweep}``, and ``--convert-back DEST`` (export to the
reference torchsnapshot format), ``--report`` (the flight records; exit
1 when there are none), ``--doctor`` (the doctor's findings over them:
exit 0 healthy, 1 findings, 2 no report) and, with PATH a manager
directory or a snapshot root, ``--timeline`` (the ledger's per-step
trends and the regression sentinel: exit 0, 1 on a regression, 2 with no
ledger). Needs neither PyYAML nor a device.
"""

import argparse
import sys

from .manifest import (
    ArrayEntry,
    DictEntry,
    ListEntry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    get_available_entries,
)
from .serialization import array_nbytes
from .snapshot import Snapshot

def _human(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _describe(path: str, entry) -> str:
    if isinstance(entry, ShardedArrayEntry):
        nbytes = array_nbytes(entry.dtype, entry.shape)
        return (
            f"{path:60s} ShardedArray {entry.dtype}{tuple(entry.shape)} "
            f"{_human(nbytes)} in {len(entry.shards)} chunks"
        )
    if isinstance(entry, ArrayEntry):
        nbytes = array_nbytes(entry.dtype, entry.shape)
        repl = " replicated" if entry.replicated else ""
        return (
            f"{path:60s} Array {entry.dtype}{tuple(entry.shape)} "
            f"{_human(nbytes)}{repl} @ {entry.location}"
        )
    if isinstance(entry, ObjectEntry):
        repl = " replicated" if entry.replicated else ""
        return f"{path:60s} object{repl} @ {entry.location}"
    if isinstance(entry, PrimitiveEntry):
        return f"{path:60s} {entry.ptype} = {entry.readable}"
    if isinstance(entry, (ListEntry, DictEntry)):
        return f"{path:60s} <{entry.type}>"
    return f"{path:60s} {entry.type}"


def _print_reports(path: str) -> int:
    """Render the snapshot's flight records: the committed take report
    and any restore reports."""
    import asyncio

    from .io_types import IOReq, is_not_found_error
    from .snapshot import SNAPSHOT_METADATA_FNAME
    from .storage_plugin import url_to_storage_plugin
    from .telemetry import report as flight

    storage = url_to_storage_plugin(path)
    try:
        # A mistyped path reads as "no snapshot here", not as a snapshot
        # without a report.
        try:
            asyncio.run(storage.read(IOReq(path=SNAPSHOT_METADATA_FNAME)))
        except Exception as e:
            if is_not_found_error(e):
                print(f"no snapshot at {path}", file=sys.stderr)
                return 1
            raise
        take_report = asyncio.run(flight.aread_json(storage, flight.REPORT_FNAME))
        restore_paths = sorted(
            p
            for p in (asyncio.run(storage.list_prefix(flight.REPORT_PREFIX)) or [])
            if p.startswith(".report.restore.")
        )
        printed = False
        if take_report is not None:
            print(flight.render_report(take_report))
            printed = True
        for rp in restore_paths:
            doc = asyncio.run(flight.aread_json(storage, rp))
            if doc is None:
                continue
            if printed:
                print()
            print(flight.render_report(doc))
            printed = True
        if not printed:
            print(
                f"no flight record at {path} (snapshot taken before "
                f"telemetry existed, or its report write failed)",
                file=sys.stderr,
            )
            return 1
        return 0
    finally:
        storage.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torchsnapshot_tpu_torch.inspect")
    parser.add_argument("path")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--raw", action="store_true")
    parser.add_argument("--delete", action="store_true",
                        help="delete the snapshot (metadata first, then every payload)")
    parser.add_argument("--sweep", action="store_true",
                        help="with --delete: also remove the objects under the prefix "
                        "that no manifest references (works without metadata)")
    parser.add_argument("--verify", action="store_true",
                        help="scrub every payload against its checksum and size; "
                        "exit 1 if any object is bad")
    parser.add_argument("--convert-back", metavar="DEST",
                        help="export to a snapshot the reference torchsnapshot can restore")
    parser.add_argument("--steps", action="store_true",
                        help="treat PATH as a CheckpointManager directory and list its "
                        "committed steps")
    parser.add_argument("--reconcile", choices=["adopt", "sweep"],
                        help="treat PATH as a CheckpointManager directory and adopt or "
                        "sweep the async saves a crash left between commit and finalize")
    parser.add_argument("--copy-to", metavar="DEST",
                        help="copy the snapshot to DEST (any backend), checking every "
                        "payload in transit; the metadata is written last")
    parser.add_argument("--report", action="store_true",
                        help="print the snapshot's flight record (.report.json: per-rank "
                        "phases, bytes, throughput, budget stall, retries, faults) and "
                        "any restore reports; exit 1 when the snapshot has none")
    parser.add_argument("--doctor", action="store_true",
                        help="run the telemetry doctor over the snapshot's flight reports; "
                        "exit 0 healthy, 1 findings, 2 no report to diagnose")
    parser.add_argument("--timeline", action="store_true",
                        help="the telemetry ledger's per-step trends for PATH (a "
                        "CheckpointManager base or snapshot root) and the regression "
                        "sentinel; exit 0 healthy, 1 regression, 2 no ledger")
    parser.add_argument("--diff", metavar="OLDER",
                        help="which logical paths were added, removed, changed or "
                        "unchanged since OLDER, from the metadata alone; exit 1 when "
                        "something changed, 3 when some paths are inconclusive")
    args = parser.parse_args(argv)

    exclusive = [
        bool(args.verify),
        bool(args.delete or args.sweep),
        bool(args.convert_back),
        bool(args.steps),
        bool(args.reconcile),
        bool(args.copy_to),
        bool(args.diff),
        bool(args.report),
        bool(args.doctor),
        bool(args.timeline),
    ]
    if sum(exclusive) > 1:
        parser.error(
            "--verify, --delete/--sweep, --convert-back, --steps, "
            "--reconcile, --copy-to, --diff, --report, --doctor, and "
            "--timeline are mutually exclusive; run them in separate "
            "invocations"
        )
    if args.timeline:
        from .telemetry import timeline as _timeline

        return _timeline.main([args.path])
    if args.report:
        return _print_reports(args.path)
    if args.doctor:
        from .telemetry import doctor as _doctor

        reports = _doctor._collect_snapshot_reports(args.path)
        if not reports:
            print(f"no flight report at {args.path} to diagnose", file=sys.stderr)
            return 2
        findings = _doctor.diagnose(reports)
        print(_doctor.render_findings(findings))
        return 1 if findings else 0
    if args.diff:
        result = Snapshot(args.path).diff(args.diff, rank=args.rank)
        for kind in ("added", "removed", "changed", "unknown"):
            for p in result[kind]:
                print(f"{kind:>9}  {p}")
        print(
            f"{len(result['added'])} added, {len(result['removed'])} "
            f"removed, {len(result['changed'])} changed, "
            f"{len(result['unchanged'])} unchanged, "
            f"{len(result['unknown'])} unknown"
        )
        if result["added"] or result["removed"] or result["changed"]:
            return 1
        # Inconclusive is not "identical", and 2 is argparse's usage error.
        return 3 if result["unknown"] else 0
    if args.copy_to:
        Snapshot(args.path).copy_to(args.copy_to)
        print(f"copied {args.path} -> {args.copy_to} (verified in transit)")
        return 0
    if args.reconcile:
        from .manager import CheckpointManager

        handled = CheckpointManager(args.path).reconcile(adopt=(args.reconcile == "adopt"))
        verb = "adopted" if args.reconcile == "adopt" else "swept"
        if not handled:
            print("no orphaned steps", file=sys.stderr)
            return 0
        for step in handled:
            print(step)
        print(f"{verb} {len(handled)} orphaned step(s)", file=sys.stderr)
        return 0
    if args.steps:
        from .manager import CheckpointManager

        steps = CheckpointManager(args.path).all_steps()
        if not steps:
            # stderr: stdout is the machine-readable step list.
            print("no committed steps", file=sys.stderr)
            return 1
        for step in steps:
            print(step)
        return 0
    if args.convert_back:
        from .interop.reference_writer import convert_back

        convert_back(args.path, args.convert_back)
        print(f"exported {args.path} -> {args.convert_back} (reference format)")
        return 0
    if args.verify:
        problems = Snapshot(args.path).verify()
        if not problems:
            print("OK: all payloads match their manifest checksums")
            return 0
        for location, problem in sorted(problems.items()):
            print(f"BAD {location}: {problem}")
        return 1
    if args.delete:
        Snapshot(args.path).delete(sweep=args.sweep)
        print(f"deleted {args.path}" + (" (swept)" if args.sweep else ""))
        return 0
    if args.sweep:
        parser.error("--sweep requires --delete")

    manifest = Snapshot(args.path).get_manifest()
    view = manifest if args.raw else get_available_entries(manifest, args.rank)
    total = 0
    counted = set()
    for path in sorted(view):
        entry = view[path]
        print(_describe(path, entry))
        if isinstance(entry, (ArrayEntry, ShardedArrayEntry)):
            # With --raw a sharded or replicated value appears once a
            # rank; each logical value counts once.
            logical = path.split("/", 1)[1] if args.raw and "/" in path else path
            if logical not in counted:
                counted.add(logical)
                total += array_nbytes(entry.dtype, entry.shape)
    print(f"\n{len(view)} entries, {_human(total)} of array data")
    return 0


if __name__ == "__main__":
    sys.exit(main())
