"""Tests for the port's snapcheck (torchsnapshot_tpu_torch.analysis) — and
the port's gate.

The cases of ``tests/test_static_analysis.py`` on the port's analyzer,
against the same fixture corpus, plus PyTorch's host syncs
(``tests/torch_analysis_fixtures/``) and the defects the gate found in
the port. The CLI's cases are in ``test_torch_static_analysis_cli.py``
and ``test_torch_static_analysis_cli_gates.py``.

Two jobs:

1. **Rule tests** — every rule has at least one positive (bad fixture,
   exact rule code + line numbers asserted) and one negative (good
   fixture, zero findings), plus suppression and baseline behavior.
   Fixtures live in ``tests/analysis_fixtures/``; the ones under
   ``scoped/`` carry the file names (``scheduler.py``, ``fingerprint.py``,
   …) that module-scoped rules key on.

2. **The gate** — ``test_repo_is_clean`` runs every rule over the whole
   ``torchsnapshot_tpu_torch`` package and fails tier-1 on any new
   violation.
   Deliberate violations must be suppressed in-line with a justification
   (``# snapcheck: disable=<rule> -- why``), not fixed here.
"""

import os

import pytest

from torchsnapshot_tpu_torch import analysis
from torchsnapshot_tpu_torch.analysis import (
    AckOrderingRule,
    BlockingSyncRule,
    ContextPropagationRule,
    ContractDriftRule,
    DeterminismRule,
    DurabilityOrderRule,
    EventLoopBlockingRule,
    LifecycleRule,
    LocksetRule,
    RetryIdempotencyRule,
    RpcConformanceRule,
    SwallowedExceptionRule,
    UnboundedWireWaitRule,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS_DIR, "analysis_fixtures")
REPO_ROOT = os.path.dirname(TESTS_DIR)
PACKAGE = os.path.join(REPO_ROOT, "torchsnapshot_tpu_torch")
TORCH_FIXTURES = os.path.join(TESTS_DIR, "torch_analysis_fixtures")


def analyze(fixture, rules=None):
    path = os.path.join(FIXTURES, fixture)
    return analysis.run([path], rules or analysis.default_rules())


def findings(result):
    """(code, line) pairs for every violation, sorted."""
    return sorted((d.code, d.line) for d in result.violations)


# ------------------------------------------------------------------- the gate


@pytest.fixture(scope="module")
def package_result():
    """The whole port tree under every rule, once for the module."""
    return analysis.run([PACKAGE], analysis.default_rules())


def test_repo_is_clean(package_result):
    result = package_result
    formatted = "\n".join(d.format() for d in result.violations)
    assert result.ok, (
        f"snapcheck found new violations in torchsnapshot_tpu_torch/ "
        f"(fix them or suppress with a justification — see "
        f"docs/ANALYSIS.md):\n{formatted}"
        + "".join(f"\nunparseable: {p}: {m}" for p, m in result.errors)
    )


def test_fixture_corpus_is_dirty():
    # EVERY registered rule id must have at least one firing fixture; a
    # rule that stops seeing its bad fixture has silently stopped
    # protecting the package too.
    result = analysis.run([FIXTURES], analysis.default_rules())
    codes = {d.code for d in result.violations}
    assert codes == {r.code for r in analysis.default_rules()}
    assert codes == {
        "SNAP001", "SNAP002", "SNAP003", "SNAP004", "SNAP005",
        "SNAP006", "SNAP007", "SNAP008", "SNAP009", "SNAP010",
        "SNAP011", "SNAP012", "SNAP013",
    }


# ------------------------------------------------------- SNAP001 blocking-sync


def test_blocking_sync_positive():
    result = analyze("bad_blocking_sync.py", [BlockingSyncRule()])
    assert findings(result) == [
        ("SNAP001", 8),  # x.block_until_ready()
        ("SNAP001", 9),  # jax.device_get(x)
        ("SNAP001", 10),  # np.asarray(x)
        ("SNAP001", 11),  # time.sleep(0.1)
    ]


def test_blocking_sync_negative():
    # Sync helpers may block (they run in executors); async code that
    # defers through run_in_executor/asyncio.sleep is clean.
    result = analyze("good_blocking_sync.py", [BlockingSyncRule()])
    assert findings(result) == []


# ---------------------------------------------------- SNAP002 durability-order


def test_durability_order_positive():
    result = analyze("bad_durability.py", [DurabilityOrderRule()])
    assert findings(result) == [
        ("SNAP002", 9),  # os.replace, no fsync
        ("SNAP002", 16),  # append-mode write, no fsync (ledger arm)
    ]
    assert "fsync" in result.violations[0].message
    assert "append" in result.violations[1].message


def test_durability_order_negative():
    # Fsynced renames, fsynced appends, and a justified ephemeral-append
    # suppression are all clean.
    result = analyze("good_durability.py", [DurabilityOrderRule()])
    assert findings(result) == []


# ------------------------------------------------- SNAP003 swallowed-exception


def test_swallowed_exception_positive():
    result = analyze("bad_swallowed.py", [SwallowedExceptionRule()])
    assert findings(result) == [
        ("SNAP003", 7),  # except Exception: return None
        ("SNAP003", 15),  # bare except: pass
        ("SNAP003", 22),  # except BaseException: return False
    ]


def test_swallowed_exception_negative():
    # Logging, re-raising, using the bound value, and capturing via
    # traceback all count as handling; narrow catches are out of scope.
    result = analyze("good_swallowed.py", [SwallowedExceptionRule()])
    assert findings(result) == []


# ------------------------------------------------------ SNAP004 nondeterminism


def test_determinism_positive():
    result = analyze(
        os.path.join("scoped", "fingerprint.py"), [DeterminismRule()]
    )
    assert findings(result) == [
        ("SNAP004", 12),  # time.time()
        ("SNAP004", 13),  # random.random()
        ("SNAP004", 14),  # hash(...)
        ("SNAP004", 19),  # json.dumps without sort_keys
        ("SNAP004", 23),  # yaml.dump(..., sort_keys=False)
        ("SNAP004", 28),  # for e in set(entries)
    ]


def test_determinism_negative():
    result = analyze(
        os.path.join("scoped", "manifest.py"), [DeterminismRule()]
    )
    assert findings(result) == []


def test_determinism_is_module_scoped():
    # The identical nondeterministic code outside a serialization module
    # is not this rule's business.
    rule = DeterminismRule()
    assert not rule.applies_to("torchsnapshot_tpu_torch/scheduler.py")
    result = analyze("bad_blocking_sync.py", [rule])
    assert findings(result) == []


# ------------------------------------------------------------ SNAP005 lockset


def test_lockset_positive():
    result = analyze(
        os.path.join("scoped", "scheduler.py"), [LocksetRule()]
    )
    assert findings(result) == [
        ("SNAP005", 18),  # Cell.charge: self.value -= n, no lock
        ("SNAP005", 21),  # Cell.record: self.history.append, no lock
        ("SNAP005", 39),  # executor callback mutates self.count
        ("SNAP005", 48),  # executor callback assigns nonlocal total
        ("SNAP005", 56),  # global _singleton assigned without module lock
        ("SNAP005", 67),  # global _singleton augmented without module lock
    ]


def test_lockset_negative():
    # with-lock mutations pass; a class with no lock attribute is
    # presumed thread-confined and unchecked.
    result = analyze(os.path.join("scoped", "coord.py"), [LocksetRule()])
    assert findings(result) == []


def test_lockset_callback_reported_once():
    # A callback nested under several functions is reachable from every
    # enclosing function's walk; the violation must not be duplicated.
    source = (
        "class C:\n"
        "    def outer(self, executor):\n"
        "        def mid():\n"
        "            def cb():\n"
        "                self.count += 1\n"
        "            executor.submit(cb)\n"
        "        mid()\n"
    )
    result = analysis.analyze_source(
        source, "scheduler.py", [LocksetRule()]
    )
    assert [(d.code, d.line) for d in result.diagnostics] == [("SNAP005", 5)]


def test_lockset_is_module_scoped():
    rule = LocksetRule()
    assert rule.applies_to("torchsnapshot_tpu_torch/coord.py")
    assert not rule.applies_to("torchsnapshot_tpu_torch/snapshot.py")


# ---------------------------------------------- SNAP006 resource-lifecycle


def test_lifecycle_positive():
    result = analyze("bad_lifecycle.py", [LifecycleRule()])
    assert findings(result) == [
        ("SNAP006", 6),   # leaked lease: release skipped on exception edge
        ("SNAP006", 17),  # double release (finally after conditional)
        ("SNAP006", 21),  # acquire result discarded
        ("SNAP006", 25),  # begin_write_through neither noted nor aborted
        ("SNAP006", 31),  # tracing.span called bare, never entered
        ("SNAP006", 35),  # release skipped on early return
    ]
    msgs = {d.line: d.message for d in result.violations}
    assert "exception path" in msgs[6]
    assert "released twice" in msgs[17]
    assert "discarded" in msgs[21]
    assert "hottier-write-through" in msgs[25]
    assert "context manager" in msgs[31]


def test_lifecycle_negative():
    # try/finally releases, ownership transfer (attribute store, call
    # argument, closure handoff, bound-method releaser), context-managed
    # spans, and loop-scoped leases are all clean.
    result = analyze("good_lifecycle.py", [LifecycleRule()])
    assert findings(result) == []


def test_lifecycle_except_exception_cleanup_counts():
    # An `except Exception: release; raise` discharges the exceptional
    # path — what escapes it is tearing down the process.
    source = (
        "def f(pool, n, use):\n"
        "    lease = pool.acquire(n)\n"
        "    try:\n"
        "        use(lease)\n"
        "    except Exception:\n"
        "        lease.release()\n"
        "        raise\n"
        "    lease.release()\n"
    )
    result = analysis.analyze_source(source, "x.py", [LifecycleRule()])
    assert result.diagnostics == []


def test_lifecycle_while_true_has_no_false_exit():
    # `while True:` only exits via break; the path that releases before
    # breaking is the only exit path, so no leak.
    source = (
        "def f(pool, n, step):\n"
        "    lease = pool.acquire(n)\n"
        "    try:\n"
        "        while True:\n"
        "            if step():\n"
        "                break\n"
        "    finally:\n"
        "        lease.release()\n"
    )
    result = analysis.analyze_source(source, "x.py", [LifecycleRule()])
    assert result.diagnostics == []


def test_lifecycle_return_routes_through_finally():
    source = (
        "def f(pool, n, cond):\n"
        "    lease = pool.acquire(n)\n"
        "    try:\n"
        "        if cond:\n"
        "            return 1\n"
        "        return 2\n"
        "    finally:\n"
        "        lease.release()\n"
    )
    result = analysis.analyze_source(source, "x.py", [LifecycleRule()])
    assert result.diagnostics == []


# --------------------------------------------- SNAP007 event-loop-blocking


def test_eventloop_positive():
    result = analyze("bad_eventloop.py", [EventLoopBlockingRule()])
    assert findings(result) == [
        ("SNAP007", 13),  # sync storage helper in async handler
        ("SNAP007", 16),  # untimed lock.acquire in async handler
        ("SNAP007", 23),  # subprocess wait in async handler
        ("SNAP007", 27),  # time.sleep transitively reachable from async
    ]
    transitive = [d for d in result.violations if d.line == 27]
    assert "drain_step" in transitive[0].message  # names the async origin


def test_eventloop_negative():
    # run_in_executor/to_thread routing, awaited asyncio primitives,
    # timeouts, and purely-sync call chains are all clean.
    result = analyze("good_eventloop.py", [EventLoopBlockingRule()])
    assert findings(result) == []


def test_eventloop_does_not_duplicate_snap001_in_async_bodies():
    # time.sleep directly inside an async def is SNAP001's finding;
    # SNAP007 must not double-report it.
    source = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)\n"
    )
    r7 = analysis.analyze_source(
        source, "x.py", [EventLoopBlockingRule()]
    )
    assert r7.diagnostics == []
    r1 = analysis.analyze_source(source, "x.py", [BlockingSyncRule()])
    assert [d.code for d in r1.diagnostics] == ["SNAP001"]


# -------------------------------------------- SNAP008 context-propagation


def test_context_positive():
    result = analyze("bad_context.py", [ContextPropagationRule()])
    assert findings(result) == [
        ("SNAP008", 12),  # executor callback reads current_trace_id
        ("SNAP008", 19),  # thread target emits a span unadopted
        ("SNAP008", 27),  # callback reads a registered ContextVar
    ]


def test_context_negative():
    # Capture-outside-closure, adopt_trace wrapping, copy_context().run
    # submission, and explicit value passing are all clean.
    result = analyze("good_context.py", [ContextPropagationRule()])
    assert findings(result) == []


def test_context_skips_defs_nested_in_submitted_callable():
    # A helper defined INSIDE the submitted callable runs only when the
    # (adopted) body invokes it — the read inside it must not fire.
    source = (
        "from torchsnapshot_tpu_torch import tracing\n"
        "def go(executor, tid):\n"
        "    def work():\n"
        "        def helper():\n"
        "            return tracing.current_trace_id()\n"
        "        with tracing.adopt_trace(tid):\n"
        "            return helper()\n"
        "    executor.submit(work)\n"
    )
    result = analysis.analyze_source(
        source, "x.py", [ContextPropagationRule()]
    )
    assert result.diagnostics == []


# ------------------------------------------------ SNAP009 contract-drift


def test_contract_drift_positive_all_arms():
    result = analyze("contract_tree", [ContractDriftRule()])
    by_arm = sorted(
        (d.message.split("'")[1], os.path.basename(d.path))
        for d in result.violations
    )
    assert by_arm == [
        ("TPUSNAPSHOT_FIXTURE_KNOB", "knobs.py"),
        ("fixture-undocumented-rule", "doctor.py"),
        ("fixture_undocumented", "schedule.py"),
        ("fixture_undocumented_field", "ledger.py"),
        ("tpusnapshot_fixture_undocumented_total", "metrics.py"),
    ]
    # The acceptance-criteria arm: a fixture env knob absent from the
    # fixture doc fails the run.
    assert any(
        "TPUSNAPSHOT_FIXTURE_KNOB" in d.message
        and "docs/api.md" in d.message
        for d in result.violations
    )


def test_contract_drift_negative():
    result = analyze("contract_tree_good", [ContractDriftRule()])
    assert findings(result) == []


def test_contract_drift_resolves_repo_docs_for_package_files():
    # Analyzing a real package file must resolve to the repo's docs/
    # tree (walking up from the file), not require a fixture tree.
    target = os.path.join(PACKAGE, "staging_pool.py")
    result = analysis.run([target], [ContractDriftRule()])
    # staging_pool's knobs are documented in docs/api.md.
    assert findings(result) == []


# -------------------------------------------------------------- suppressions


def test_inline_suppressions():
    result = analyze("suppressed.py")
    # Same-line and comment-line-above forms both silence their finding;
    # the unsuppressed sleep still fires.
    assert findings(result) == [("SNAP001", 15)]
    silenced = sorted((d.code, d.line) for d in result.suppressed)
    assert silenced == [
        ("SNAP001", 6),
        ("SNAP001", 11),
        ("SNAP003", 21),
    ]


def test_suppression_by_rule_code():
    # Diagnostics print the SNAPxxx code first, so a developer copying
    # it from a CI failure into a directive must get a working
    # suppression.
    source = (
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:  # snapcheck: disable=SNAP003 -- probe\n"
        "        return None\n"
    )
    result = analysis.analyze_source(
        source, "x.py", [SwallowedExceptionRule()]
    )
    assert result.diagnostics == []
    assert [d.code for d in result.suppressed] == ["SNAP003"]


def test_suppression_comma_list_tolerates_spaces():
    # "disable=a, b" — a space after the comma must not silently drop
    # the rules that follow it.
    source = (
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:  "
        "# snapcheck: disable=nondeterminism, swallowed-exception -- why\n"
        "        return None\n"
    )
    result = analysis.analyze_source(
        source, "x.py", [SwallowedExceptionRule()]
    )
    assert result.diagnostics == []
    assert [d.code for d in result.suppressed] == ["SNAP003"]


def test_suppression_justification_glued_to_rules():
    # A justification with no space before the "--" must still cut the
    # rule list there, not become part of a (nonexistent) rule name.
    source = (
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:  # snapcheck: disable=swallowed-exception--probe\n"
        "        return None\n"
    )
    result = analysis.analyze_source(
        source, "x.py", [SwallowedExceptionRule()]
    )
    assert result.diagnostics == []
    assert [d.code for d in result.suppressed] == ["SNAP003"]


def test_suppression_inside_string_literal_is_ignored():
    # A directive quoted in a docstring (e.g. documentation of the
    # suppression syntax) must not silence anything — only real
    # comments count.
    source = (
        '"""Docs: write # snapcheck: disable-file=swallowed-exception\n'
        'to silence the rule file-wide."""\n'
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:\n"
        "        return None\n"
    )
    result = analysis.analyze_source(
        source, "x.py", [SwallowedExceptionRule()]
    )
    assert [(d.code, d.line) for d in result.diagnostics] == [("SNAP003", 6)]
    assert result.suppressed == []


def test_filewide_suppression_is_per_rule():
    result = analyze("suppressed_filewide.py")
    # disable-file silences every swallowed-exception in the file but
    # leaves other rules armed.
    assert findings(result) == [("SNAP001", 21)]
    assert {d.code for d in result.suppressed} == {"SNAP003"}


# ------------------------------------------------------------------- baseline


def test_baseline_masks_preexisting_findings(tmp_path):
    bad = os.path.join(FIXTURES, "bad_swallowed.py")
    rules = [SwallowedExceptionRule()]
    first = analysis.run([bad], rules)
    assert len(first.violations) == 3

    baseline_path = tmp_path / "baseline.json"
    analysis.save_baseline(str(baseline_path), first.fingerprints)
    baseline = analysis.load_baseline(str(baseline_path))

    masked = analysis.run([bad], rules, baseline=baseline)
    assert masked.ok
    assert len(masked.baselined) == 3
    assert masked.violations == []


def test_baseline_does_not_mask_new_findings(tmp_path):
    bad = os.path.join(FIXTURES, "bad_swallowed.py")
    rules = [SwallowedExceptionRule()]
    first = analysis.run([bad], rules)
    baseline_path = tmp_path / "baseline.json"
    # Baseline only the first finding: the other two stay violations.
    analysis.save_baseline(str(baseline_path), first.fingerprints[:1])
    baseline = analysis.load_baseline(str(baseline_path))
    partial = analysis.run([bad], rules, baseline=baseline)
    assert len(partial.baselined) == 1
    assert len(partial.violations) == 2
    assert not partial.ok


def test_baseline_fingerprint_survives_line_drift():
    source_v1 = (
        "def f(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:\n"
        "        return None\n"
    )
    # Same flagged code, shifted down by a new leading comment.
    source_v2 = "# a new header comment\n\n" + source_v1
    rules = [SwallowedExceptionRule()]
    r1 = analysis.analyze_source(source_v1, "x.py", rules)
    r2 = analysis.analyze_source(source_v2, "x.py", rules)
    assert r1.diagnostics[0].line != r2.diagnostics[0].line
    assert r1.fingerprints[0] == r2.fingerprints[0]


# ------------------------------------------------- SNAP010 rpc-conformance


def test_rpc_conformance_positive_client():
    result = analyze(
        "bad_protocol/client.py", [RpcConformanceRule()]
    )
    assert findings(result) == [
        ("SNAP010", 29),  # op 'fetch' has no server handler
        ("SNAP010", 30),  # response field 'blob' never written
    ]


def test_rpc_conformance_positive_server():
    result = analyze(
        "bad_protocol/server.py", [RpcConformanceRule()]
    )
    assert findings(result) == [
        ("SNAP010", 30),  # request field 'nonce' never sent
        ("SNAP010", 36),  # dead handler: op 'stale'
    ]


def test_rpc_conformance_negative():
    for path in ("good_protocol/client.py", "good_protocol/server.py"):
        assert findings(analyze(path, [RpcConformanceRule()])) == []


def test_rpc_conformance_clean_on_real_transports():
    # The three real wire stacks are the rule's whole reason to exist;
    # each client/server pair must be conformant end to end.
    for rel in (
        "snapserve/client.py",
        "snapserve/server.py",
        "hottier/transport.py",
        "hottier/peer.py",
    ):
        result = analysis.run(
            [os.path.join(PACKAGE, rel)], [RpcConformanceRule()]
        )
        assert findings(result) == [], rel


# ---------------------------------------------- SNAP011 unbounded-wire-wait


def test_unbounded_wire_wait_positive():
    result = analyze(
        "bad_protocol/client.py", [UnboundedWireWaitRule()]
    )
    assert findings(result) == [
        ("SNAP011", 17),  # raw open_connection
        ("SNAP011", 18),  # raw send_frame
        ("SNAP011", 19),  # raw recv_frame
    ]


def test_unbounded_wire_wait_negative():
    # Good client wraps every wait in wait_for; the bad SERVER is also
    # clean — a responder legitimately blocks on the next request and
    # replies on a connection the client is actively reading.
    for path in (
        "good_protocol/client.py",
        "good_protocol/server.py",
        "bad_protocol/server.py",
    ):
        assert findings(analyze(path, [UnboundedWireWaitRule()])) == []


# ----------------------------------------------- SNAP012 retry-idempotency


def test_retry_idempotency_positive():
    result = analyze(
        "bad_protocol/client.py", [RetryIdempotencyRule()]
    )
    assert findings(result) == [
        ("SNAP012", 22),  # while True retry with no budget
        ("SNAP012", 26),  # fixed 1s backoff, no jitter
        ("SNAP012", 29),  # op 'fetch' retried but not idempotent
    ]


def test_retry_idempotency_negative():
    # Jittered, budgeted, every retried op declared IDEMPOTENT_OPS.
    assert (
        findings(analyze("good_protocol/client.py", [RetryIdempotencyRule()]))
        == []
    )


# --------------------------------------------------- SNAP013 ack-ordering


def test_ack_ordering_positive():
    result = analyze(
        "bad_protocol/server.py", [AckOrderingRule()]
    )
    assert findings(result) == [
        ("SNAP013", 42),  # store before fingerprint verification
        ("SNAP013", 48),  # ok=true acked before the store
        ("SNAP013", 49),  # stores + acks with no verification at all
    ]


def test_ack_ordering_negative():
    # verify -> store -> ack on every path.
    assert (
        findings(analyze("good_protocol/server.py", [AckOrderingRule()]))
        == []
    )


# --------------------------------------------------------------- rule registry


def test_select_rules():
    assert len(analysis.select_rules(None)) == 13
    by_name = analysis.select_rules(["blocking-sync", "lockset"])
    assert sorted(r.code for r in by_name) == ["SNAP001", "SNAP005"]
    by_code = analysis.select_rules(["SNAP002"])
    assert [r.name for r in by_code] == ["durability-order"]
    flow = analysis.select_rules(
        ["resource-lifecycle", "SNAP007", "context-propagation", "SNAP009"]
    )
    assert sorted(r.code for r in flow) == [
        "SNAP006", "SNAP007", "SNAP008", "SNAP009",
    ]
    proto = analysis.select_rules(
        ["rpc-conformance", "SNAP011", "retry-idempotency", "SNAP013"]
    )
    assert sorted(r.code for r in proto) == [
        "SNAP010", "SNAP011", "SNAP012", "SNAP013",
    ]
    with pytest.raises(ValueError, match="Unknown rule"):
        analysis.select_rules(["no-such-rule"])


def test_rule_codes_are_unique_and_stable():
    rules = analysis.default_rules()
    codes = [r.code for r in rules]
    assert len(set(codes)) == len(codes)
    assert all(c.startswith("SNAP") for c in codes)
    assert all(r.name and r.description for r in rules)


def test_syntax_error_is_reported_not_raised(tmp_path):
    result = analysis.analyze_source("def broken(:\n", "broken.py", [])
    assert result.error is not None and "syntax error" in result.error
    # An unparseable file fails the gate: it cannot be proven clean.
    broken = tmp_path / "broken.py"
    broken.write_text("def broken(:\n")
    run_result = analysis.run([str(broken)], analysis.default_rules())
    assert not run_result.ok
    assert run_result.errors and run_result.errors[0][0] == str(broken)


def test_unreadable_file_is_reported_not_raised(tmp_path):
    # A non-UTF8 file must fail the gate as a reported error, not crash
    # the whole run with a raw UnicodeDecodeError.
    binary = tmp_path / "binary.py"
    binary.write_bytes(b"\xff\xfe\x00junk")
    result = analysis.run([str(binary)], analysis.default_rules())
    assert not result.ok
    assert result.errors and "unreadable" in result.errors[0][1]




def test_run_result_reports_stale_entries():
    bad = os.path.join(FIXTURES, "bad_swallowed.py")
    rules = [SwallowedExceptionRule()]
    first = analysis.run([bad], rules)
    fake = dict.fromkeys(first.fingerprints, 1)
    fake["swallowed-exception::gone.py::deadbeef0000"] = 2
    result = analysis.run([bad], rules, baseline=fake)
    assert result.ok
    assert result.stale_baseline == {
        "swallowed-exception::gone.py::deadbeef0000": 2
    }


# ------------------------------------------------- PyTorch's host syncs

# Each sync as the findings print it (the receiver's spelling aside).
TORCH_SYNCS = (
    "torch.cuda.synchronize",
    ".synchronize",
    ".item",
    ".cpu",
    ".numpy",
    ".tolist",
)


def _marked_lines(name, marker, sync):
    """Lines of a torch fixture that carry ``# <marker>: <sync>``."""
    with open(os.path.join(TORCH_FIXTURES, name), encoding="utf-8") as f:
        return [
            i
            for i, line in enumerate(f, start=1)
            if line.rstrip().endswith(f"# {marker}: {sync}")
        ]


def _torch_findings(name, rules):
    return analysis.run([os.path.join(TORCH_FIXTURES, name)], rules)


@pytest.mark.parametrize("sync", TORCH_SYNCS)
def test_torch_sync_directly_in_async_is_snap001(sync):
    lines = _marked_lines("bad_torch_sync.py", "sync", sync)
    assert lines
    result = _torch_findings(
        "bad_torch_sync.py", [BlockingSyncRule(), EventLoopBlockingRule()]
    )
    by_line = {d.line: d for d in result.violations}
    for line in lines:
        diag = by_line[line]
        # Once, as SNAP001: SNAP007 leaves direct async bodies to it.
        assert diag.code == "SNAP001"
        assert [d.line for d in result.violations].count(line) == 1
        assert f"{sync.rsplit('.', 1)[-1]}()'" in diag.message
        assert "waiting for the device's queued work" in diag.message or (
            "waits for the device's queued work" in diag.message
        )


@pytest.mark.parametrize("sync", TORCH_SYNCS)
def test_torch_sync_through_a_helper_is_snap007(sync):
    (line,) = _marked_lines("bad_torch_sync.py", "helper", sync)
    result = _torch_findings(
        "bad_torch_sync.py", [BlockingSyncRule(), EventLoopBlockingRule()]
    )
    hits = [d for d in result.violations if d.line == line]
    assert [d.code for d in hits] == ["SNAP007"]
    # The transitive arm names the async origin and the call chain.
    assert "from async 'drain_step'" in hits[0].message
    assert f"{sync.rsplit('.', 1)[-1]}()'" in hits[0].message


@pytest.mark.parametrize("sync", TORCH_SYNCS)
def test_torch_sync_off_the_loop_is_clean(sync):
    # Plain sync code no async def calls, and the syncs handed to
    # run_in_executor / asyncio.to_thread as arguments.
    assert _marked_lines("good_torch_sync.py", "sync", sync)
    result = _torch_findings("good_torch_sync.py", analysis.default_rules())
    assert findings(result) == []


def test_torch_fixture_codes():
    result = analysis.run([TORCH_FIXTURES], analysis.default_rules())
    assert {d.code for d in result.violations} == {"SNAP001", "SNAP007"}
    assert all(
        os.path.basename(d.path) == "bad_torch_sync.py"
        for d in result.violations
    )


@pytest.mark.parametrize(
    "source",
    [
        "import torch as th\nasync def f():\n    th.cuda.synchronize()\n",
        "from torch.cuda import synchronize\nasync def f():\n"
        "    synchronize()\n",
        "import torch\nasync def f(x):\n    return x.sum().item()\n",
    ],
    ids=["torch-alias", "bare-synchronize", "chained-receiver"],
)
def test_torch_sync_spellings_resolve(source):
    result = analysis.analyze_source(source, "x.py", [BlockingSyncRule()])
    assert [(d.code, d.line) for d in result.diagnostics] == [("SNAP001", 3)]


def test_torch_cuda_synchronize_needs_a_torch_import():
    # Without a torch import, `cuda.synchronize()` is still a
    # `.synchronize()` on some receiver, named as written.
    source = "async def f(cuda):\n    cuda.synchronize()\n"
    result = analysis.analyze_source(source, "x.py", [BlockingSyncRule()])
    assert [d.message.split("'")[1] for d in result.diagnostics] == [
        "cuda.synchronize()"
    ]


# ------------------------------------ defects the gate found in the port


def test_suppressions_carry_a_justification(package_result):
    # Every suppression in the port states why the site is safe, after
    # "--", as the JAX package's do.
    lines = {}
    for diag in package_result.suppressed:
        if diag.path not in lines:
            with open(diag.path, encoding="utf-8") as f:
                lines[diag.path] = f.read().splitlines()
        text = lines[diag.path]
        directive = [
            t for t in (text[diag.line - 1], text[diag.line - 2])
            if "snapcheck: disable" in t
        ]
        assert directive and "--" in directive[0].split("snapcheck:")[1], (
            diag.format()
        )


def test_pinned_source_returns_its_lease_when_the_copy_fails(monkeypatch):
    """``ArrayRestorePlan._pinned_source`` acquires a pinned lease and
    copies the payload into it; the caller releases only a lease it was
    handed, so a copy that raises must give the lease back itself (the
    gate's SNAP006 finding at the acquire)."""
    import types

    import torch

    from torchsnapshot_tpu_torch import io_preparer, staging_pool

    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES", str(1 << 20))
    staging_pool.reset_staging_pool()
    try:
        # The CPU build cannot pin: a plain buffer stands in for one.
        monkeypatch.setattr(
            staging_pool,
            "_allocate",
            lambda nbytes, pinned: torch.empty(nbytes, dtype=torch.uint8),
        )

        def failing_copy(dst, src):
            raise RuntimeError("host copy failed")

        monkeypatch.setattr(io_preparer, "host_copy", failing_copy)
        pool = staging_pool.get_staging_pool()
        before = pool.stats()
        plan = types.SimpleNamespace(_profile=None)
        try:
            io_preparer.ArrayRestorePlan._pinned_source(plan, b"x" * 4096, None)
        except RuntimeError as e:
            # Held, as a failing restore's error is: its traceback keeps
            # the frame, so a lease left there is not yet collected.
            error = e
        assert "host copy failed" in str(error)
        after = pool.stats()
        assert after["in_use_bytes"] == before["in_use_bytes"]
        assert after["free_bytes"] == before["free_bytes"] + 4096
        del error
    finally:
        staging_pool.reset_staging_pool()
