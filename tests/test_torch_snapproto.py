"""snapproto for the port: the wire-protocol inventory of
``torchsnapshot_tpu_torch`` and its runtime contracts — the cases of
``tests/test_snapproto.py`` on the port's analyzer, ``snapserve`` and
``hottier``.

Three jobs:

1. **Inventory freshness** — ``docs/PROTOCOL.md`` equals the port's
   ``render_markdown(build_inventory())`` line for line, but for its
   ``> Generated by`` line, which names the CLI that rendered it: the
   port speaks the JAX package's protocol, and its map can never drift
   from the code it describes.
2. **Inventory completeness** — the model covers all three wire stacks
   and every client-dispatched op resolves to a server handler.
3. **Registry/runtime conformance** — the module-level op registries
   the analyzer reads are the SAME objects the runtime dispatches
   through: every declared handler is a real method, the idempotency
   registries match dispatch, the repair facade maps onto real tier
   entry points, and a live ping round-trips against a real server.
"""

import json
import os
import subprocess
import sys

import pytest

from torchsnapshot_tpu_torch import snapserve
from torchsnapshot_tpu_torch.analysis.protocol import (
    FACADE_METHOD_OPS,
    build_inventory,
    render_markdown,
)
from torchsnapshot_tpu_torch.hottier import tier
from torchsnapshot_tpu_torch.hottier.peer import PeerServer
from torchsnapshot_tpu_torch.hottier.transport import (
    HOT_TIER_OPS,
    RemotePeer,
)
from torchsnapshot_tpu_torch.hottier.transport import (
    IDEMPOTENT_OPS as HOT_TIER_IDEMPOTENT_OPS,
)
from torchsnapshot_tpu_torch.snapserve.protocol import (
    IDEMPOTENT_OPS as READ_PLANE_IDEMPOTENT_OPS,
)
from torchsnapshot_tpu_torch.snapserve.protocol import READ_PLANE_OPS
from torchsnapshot_tpu_torch.snapserve.server import SnapServer

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
PROTOCOL_MD = os.path.join(REPO_ROOT, "docs", "PROTOCOL.md")


# ------------------------------------------------------- inventory freshness


GENERATED_BY = "> Generated by "


def _body(markdown):
    return [
        line for line in markdown.splitlines()
        if not line.startswith(GENERATED_BY)
    ]


def test_protocol_md_is_fresh():
    with open(PROTOCOL_MD, encoding="utf-8") as f:
        on_disk = f.read()
    rendered = render_markdown(build_inventory())
    assert _body(on_disk) == _body(rendered), (
        "the port's wire protocol drifted from docs/PROTOCOL.md — compare "
        "with:\n  python -m torchsnapshot_tpu_torch.analysis --inventory"
    )
    (generated,) = [
        line for line in rendered.splitlines()
        if line.startswith(GENERATED_BY)
    ]
    assert generated.startswith(
        "> Generated by `python -m torchsnapshot_tpu_torch.analysis "
        "--inventory`."
    )


def test_render_is_deterministic():
    assert render_markdown(build_inventory()) == render_markdown(
        build_inventory()
    )


# ----------------------------------------------------- inventory completeness


def test_inventory_covers_all_three_transports():
    inv = build_inventory()
    assert [t["name"] for t in inv["transports"]] == [
        "snapserve",
        "snapwire",
        "snapmend",
    ]
    assert inv["wire"]["protocol_version"] == 1


def test_every_dispatched_op_has_a_handler():
    inv = build_inventory()
    for transport in inv["transports"]:
        assert transport["ops_without_handler"] == [], transport["name"]
        for op, meta in transport["ops"].items():
            assert meta["handled"], (transport["name"], op)
            assert meta["handler"], (transport["name"], op)


def test_inventory_ops_match_runtime_registries():
    inv = build_inventory()
    by_name = {t["name"]: t for t in inv["transports"]}
    assert set(by_name["snapserve"]["ops"]) == set(READ_PLANE_OPS)
    assert set(by_name["snapwire"]["ops"]) == set(HOT_TIER_OPS)
    # The repair plane rides the snapwire peer: its op catalog is the
    # facade image, a subset of the hot-tier registry.
    assert set(by_name["snapmend"]["ops"]) <= set(HOT_TIER_OPS)
    assert set(FACADE_METHOD_OPS.values()) == set(
        by_name["snapmend"]["ops"]
    )


# ------------------------------------------- registry/runtime conformance


def test_hot_tier_handlers_are_peer_server_methods():
    for op, meta in HOT_TIER_OPS.items():
        handler = meta["handler"]
        assert callable(getattr(PeerServer, handler, None)), (op, handler)


def test_read_plane_handlers_are_snap_server_methods():
    for op, meta in READ_PLANE_OPS.items():
        handler = meta["handler"]
        assert callable(getattr(SnapServer, handler, None)), (op, handler)


def test_idempotent_registries_cover_dispatch():
    # Both transports retry through a wrapper that consults the
    # registry; every op the dispatch tables know must be declared
    # (SNAP012 enforces the static half of this).
    assert HOT_TIER_IDEMPOTENT_OPS == frozenset(HOT_TIER_OPS)
    assert READ_PLANE_IDEMPOTENT_OPS == frozenset(READ_PLANE_OPS)


def test_facade_methods_map_to_real_entry_points():
    for method, op in FACADE_METHOD_OPS.items():
        assert op in HOT_TIER_OPS, (method, op)
        target = getattr(tier, method, None) or getattr(
            RemotePeer, method, None
        )
        assert callable(target), method


def test_unknown_op_is_a_programming_error_not_a_wire_frame():
    peer = RemotePeer(host_id=0, addr="127.0.0.1:1")
    with pytest.raises(ValueError, match="unknown snapwire op"):
        peer._call_once({"v": 1, "op": "nope"}, b"", 1.0)


def test_ping_round_trips_against_a_live_server():
    server = snapserve.start_local_server()
    try:
        header = snapserve.ping_server(server.addr, timeout_s=10.0)
        assert header.get("ok") is True
        assert header.get("server") == "snapserve"
    finally:
        server.stop()


# ------------------------------------------------ CLI / SARIF contracts


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )


def test_cli_protocol_rules_clean_repo_wide():
    # The acceptance gate verbatim: the four protocol rules exit 0 over
    # the package with zero suppressions spent on them.
    proc = run_cli(
        "--rules",
        "SNAP010,SNAP011,SNAP012,SNAP013",
        "torchsnapshot_tpu_torch/",
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout
    assert "0 suppressed" in proc.stdout


def test_cli_protocol_rules_dirty_on_fixtures_sarif():
    proc = run_cli(
        "--format",
        "sarif",
        "--rules",
        "SNAP010,SNAP011,SNAP012,SNAP013",
        "tests/analysis_fixtures/bad_protocol/",
    )
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    driver = doc["runs"][0]["tool"]["driver"]
    assert {r["id"] for r in driver["rules"]} == {
        "SNAP010", "SNAP011", "SNAP012", "SNAP013",
    }
    fired = {r["ruleId"] for r in doc["runs"][0]["results"]}
    assert fired == {"SNAP010", "SNAP011", "SNAP012", "SNAP013"}


def test_cli_inventory_json_and_markdown():
    md = run_cli("--inventory")
    assert md.returncode == 0, md.stderr
    assert md.stdout.startswith("# Wire-protocol inventory")
    with open(PROTOCOL_MD, encoding="utf-8") as f:
        assert _body(md.stdout) == _body(f.read())
    js = run_cli("--inventory", "--format", "json")
    assert js.returncode == 0, js.stderr
    doc = json.loads(js.stdout)
    assert [t["name"] for t in doc["transports"]] == [
        "snapserve",
        "snapwire",
        "snapmend",
    ]


# --------------------------------------------- wiretap conformance (snapflight)


def test_inventory_stamps_telemetry_keys():
    inv = build_inventory()
    by_name = {t["name"]: t for t in inv["transports"]}
    assert by_name["snapserve"]["telemetry_transport"] == "snapserve"
    assert by_name["snapwire"]["telemetry_transport"] == "snapwire"
    # The repair facade has no frames of its own: its RPCs surface in
    # the wiretap under the snapwire label it rides.
    assert by_name["snapmend"]["telemetry_transport"] == "snapwire"
    for t in inv["transports"]:
        for op, entry in t["ops"].items():
            assert entry["telemetry_key"] == (
                f"{t['telemetry_transport']}/{op}"
            ), (t["name"], op)


def test_every_protocol_op_reports_through_wiretap():
    """The PROTOCOL.md-driven conformance pin: exercising every op of
    every transport produces a wiretap sample under exactly the
    inventory's telemetry keys — no listed op is dark, and no sample
    appears for an op the protocol map does not list (an unlisted key
    would be an instrumented op the inventory lost, or a typo'd
    transport/op label pair)."""
    import asyncio

    from torchsnapshot_tpu_torch import wiretap
    from torchsnapshot_tpu_torch.hottier.peer import start_local_peer
    from torchsnapshot_tpu_torch.io_types import IOReq
    from torchsnapshot_tpu_torch.snapserve.server import fetch_server_stats
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    inv = build_inventory()
    expected = {
        entry["telemetry_key"]
        for t in inv["transports"]
        for entry in t["ops"].values()
    }

    root = "memory://wiretap-conformance/run"
    storage = url_to_storage_plugin(root)
    try:
        asyncio.run(
            storage.write(IOReq(path="0/obj", data=b"x" * 1024))
        )
    finally:
        storage.close()

    wiretap.reset()
    server = snapserve.start_local_server()
    peer_server, _ = start_local_peer(host_id=93, register=False)
    peer = RemotePeer(host_id=93, addr=peer_server.addr)
    try:
        # snapserve: the one-shot client helpers + a plugin read.
        snapserve.ping_server(server.addr, timeout_s=10.0)
        snapserve.fetch_member_info(server.addr, timeout_s=10.0)
        snapserve.plan_remote(
            server.addr,
            {
                "shape": [8, 8],
                "itemsize": 4,
                "record_sizes": [128, 128],
                "boxes": [[[0, 8], [0, 8]]],
            },
            timeout_s=10.0,
        )
        fetch_server_stats(server.addr, timeout_s=10.0)

        async def _read():
            plugin = url_to_storage_plugin(
                f"snapserve://{server.addr}/{root}"
            )
            try:
                await plugin.read(IOReq(path="0/obj"))
            finally:
                plugin.close()

        asyncio.run(_read())

        # snapwire: one RemotePeer call per registry op (the snapmend
        # facade rides these same frames — no extra keys to mint).
        from torchsnapshot_tpu_torch.fingerprint import fingerprint_host

        payload = b"y" * 512
        tag = fingerprint_host(payload)
        stored, _tag = peer.put("k", payload, tag=tag, root=root)
        assert stored
        assert peer.get("k").data == payload
        assert peer.query("k") is not None
        peer.mark_drained("k", tag)
        peer.drop_stale("k", [tag])
        peer.drop("k")
        assert peer.occupancy() is not None
        assert peer.probe() is True
    finally:
        peer.close()
        peer_server.stop()
        server.stop()

    recorded = set(wiretap.summary())
    assert recorded == expected, (
        f"wiretap coverage drifted from the protocol inventory:\n"
        f"  ops with no samples: {sorted(expected - recorded)}\n"
        f"  samples for unlisted ops: {sorted(recorded - expected)}"
    )
