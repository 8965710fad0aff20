"""snapcheck: checkpoint-safety static analysis for torchsnapshot_tpu_torch.

An AST-based, pluggable lint framework encoding this framework's own
safety invariants as CI-gated rules (see ``docs/ANALYSIS.md``).
SNAP001-005 are syntactic; SNAP006-008 are flow-sensitive (statement-
level CFGs + forward dataflow, ``cfg.py``/``dataflow.py``); SNAP009 is
cross-artifact (code vs ``docs/``); SNAP010-013 are wire-protocol
conformance over the models extracted by ``protocol.py``
(``rules_protocol.py`` — snapproto, the gate for the data-plane
unification):

==========  =====================  ==========================================
Code        Rule                   Invariant
==========  =====================  ==========================================
SNAP001     blocking-sync          async pipeline never blocks the device /
                                   event loop
SNAP002     durability-order       data durable before publication (fsync
                                   before rename)
SNAP003     swallowed-exception    retry/commit paths never discard failures
SNAP004     nondeterminism         fingerprint/manifest serialization is
                                   reproducible
SNAP005     lockset                lock-owning state mutated under its lock
SNAP006     resource-lifecycle     acquire/release obligations (leases,
                                   budget holds, write-throughs, spans)
                                   discharge exactly once on every path
SNAP007     event-loop-blocking    blocking calls never reachable from
                                   async code without an executor hop
SNAP008     context-propagation    contextvar readers in submitted
                                   callables adopt their context
SNAP009     contract-drift         env knobs / metrics / doctor rules /
                                   ledger fields / fault kinds stay in
                                   sync with their docs
SNAP010     rpc-conformance        every client-sent op has a server
                                   handler, no dead handlers, no frame
                                   field skew across a transport pair
SNAP011     unbounded-wire-wait    initiator dial/send/recv always under
                                   an asyncio.wait_for deadline
SNAP012     retry-idempotency      retried ops declared IDEMPOTENT_OPS;
                                   retry loops jittered and budgeted
SNAP013     ack-ordering           verify fingerprint before store,
                                   store before positive ack (ack-at-k)
==========  =====================  ==========================================

Run it::

    python -m torchsnapshot_tpu_torch.analysis torchsnapshot_tpu_torch/
    python -m torchsnapshot_tpu_torch.analysis --format json --baseline b.json src/
    python -m torchsnapshot_tpu_torch.analysis --format sarif --changed-only HEAD src/
    python -m torchsnapshot_tpu_torch.analysis --inventory > PROTOCOL.md

Suppress a deliberate violation with a justification::

    except Exception:  # snapcheck: disable=swallowed-exception -- probe

The analyzer itself is pure stdlib — no device, network, or accelerator
stack is touched at analysis time. (Importing this subpackage does import
the parent ``torchsnapshot_tpu_torch`` package, and with it PyTorch, so
the host still needs the port's dependencies installed — true of the
pytest gate and of the card's host, where ``chip_smoke.py`` runs it.)
"""

from typing import List, Optional, Sequence

from .core import (
    Diagnostic,
    FileResult,
    Rule,
    RunResult,
    analyze_file,
    analyze_source,
    fingerprint,
    iter_python_files,
    load_baseline,
    run,
    save_baseline,
)
from .rules_async import BlockingSyncRule
from .rules_context import ContextPropagationRule
from .rules_contracts import ContractDriftRule
from .rules_determinism import DeterminismRule
from .rules_durability import DurabilityOrderRule
from .rules_eventloop import EventLoopBlockingRule
from .rules_exceptions import SwallowedExceptionRule
from .rules_lifecycle import LifecycleRule
from .rules_lockset import LocksetRule
from .rules_protocol import (
    AckOrderingRule,
    RetryIdempotencyRule,
    RpcConformanceRule,
    UnboundedWireWaitRule,
)


def default_rules() -> List[Rule]:
    """Fresh instances of every registered rule."""
    return [
        BlockingSyncRule(),
        DurabilityOrderRule(),
        SwallowedExceptionRule(),
        DeterminismRule(),
        LocksetRule(),
        LifecycleRule(),
        EventLoopBlockingRule(),
        ContextPropagationRule(),
        ContractDriftRule(),
        RpcConformanceRule(),
        UnboundedWireWaitRule(),
        RetryIdempotencyRule(),
        AckOrderingRule(),
    ]


def select_rules(names: Optional[Sequence[str]] = None) -> List[Rule]:
    """Rules filtered by name or code; None = all."""
    rules = default_rules()
    if names is None:
        return rules
    wanted = {n.strip() for n in names if n.strip()}
    chosen = [r for r in rules if r.name in wanted or r.code in wanted]
    known = {r.name for r in rules} | {r.code for r in rules}
    unknown = wanted - known
    if unknown:
        raise ValueError(
            f"Unknown rule(s): {sorted(unknown)}; "
            f"known: {sorted(r.name for r in rules)}"
        )
    return chosen


__all__ = [
    "AckOrderingRule",
    "BlockingSyncRule",
    "ContextPropagationRule",
    "ContractDriftRule",
    "DeterminismRule",
    "Diagnostic",
    "DurabilityOrderRule",
    "EventLoopBlockingRule",
    "FileResult",
    "LifecycleRule",
    "LocksetRule",
    "RetryIdempotencyRule",
    "RpcConformanceRule",
    "Rule",
    "RunResult",
    "SwallowedExceptionRule",
    "UnboundedWireWaitRule",
    "analyze_file",
    "analyze_source",
    "default_rules",
    "fingerprint",
    "iter_python_files",
    "load_baseline",
    "run",
    "save_baseline",
    "select_rules",
]
