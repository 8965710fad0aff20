"""Worklist dataflow over snapcheck CFGs.

A deliberately small forward engine: states are whatever the client
rule chooses (hashable facts in frozensets work well), ``join`` is
set-union for may-analyses (the lifecycle rule tracks the *set of
possible obligation statuses* per acquire site — "a path exists where
the lease is still held" is then just membership at an exit node).

The one non-obvious contract, shared with ``cfg.py``: **normal edges
propagate the post-statement state, exception edges propagate the
pre-statement state** — a statement that raised may not have had its
effect (an ``acquire`` that raised created no obligation; a ``release``
that raised is conservatively still an obligation).
"""

from typing import Callable, Dict, Generic, TypeVar

from .cfg import CFG

S = TypeVar("S")


class ForwardAnalysis(Generic[S]):
    """Forward may/must analysis; subclass or construct with callables.

    ``transfer(node, state) -> state`` applies one CFG node's effect.
    ``join(a, b) -> state`` combines states at merge points (union for
    may, intersection for must). ``bottom`` is the identity of join and
    the initial state of every non-entry node.
    """

    def __init__(
        self,
        transfer: Callable[[object, S], S],
        join: Callable[[S, S], S],
        bottom: S,
        entry_state: S,
        exc_transfer: Callable[[object, S], S] = None,
    ) -> None:
        self.transfer = transfer
        self.join = join
        self.bottom = bottom
        self.entry_state = entry_state
        # What flows along a node's exception edges. Default: the
        # pre-statement state (the statement may not have had its
        # effect). Clients override per-node when they want to assume
        # some effects stick even when the statement raises (e.g. a
        # release call is assumed to release).
        self.exc_transfer = exc_transfer or (lambda node, s: s)

    def run(self, cfg: CFG) -> Dict[int, S]:
        """Fixpoint in-states per node index."""
        ins: Dict[int, S] = {n.index: self.bottom for n in cfg.nodes}
        ins[cfg.entry] = self.entry_state
        work = [n.index for n in cfg.nodes]
        # Chaotic iteration; CFGs here are function-sized, so a simple
        # FIFO worklist converges quickly (the lattices the rules use
        # are small powersets).
        while work:
            idx = work.pop(0)
            node = cfg.nodes[idx]
            out = self.transfer(node, ins[idx])
            pre = self.exc_transfer(node, ins[idx])
            for s in node.succ:
                merged = self.join(ins[s], out)
                if merged != ins[s]:
                    ins[s] = merged
                    if s not in work:
                        work.append(s)
            for s in node.exc_succ:
                merged = self.join(ins[s], pre)
                if merged != ins[s]:
                    ins[s] = merged
                    if s not in work:
                        work.append(s)
        return ins
