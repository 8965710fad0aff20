"""Stateful protocol: the unit of checkpointable application state.

A "state dict" is a tree of plain containers (dict / OrderedDict / list /
tuple) whose leaves are ``torch.Tensor``, ``numpy.ndarray``, or arbitrary
picklable objects. Anything that can produce and absorb one — a model
wrapper, a data-loader cursor, a metric accumulator — participates in
snapshotting by implementing this protocol.
"""

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    """Protocol for checkpointable objects.

    ``state_dict`` returns a tree of plain containers; ``load_state_dict``
    absorbs one. ``Snapshot`` calls the statefuls of an app state in
    sorted key order, the RNG stateful first on take and last on restore.
    """

    def state_dict(self) -> Dict[str, Any]:
        ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        ...


# The top-level unit handed to Snapshot.take / restore: a mapping from a
# user-chosen key (e.g. "model", "optim", "progress") to a Stateful.
AppState = Dict[str, Stateful]
