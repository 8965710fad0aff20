"""Stateful adapters for common training-state shapes.

The ``Stateful`` protocol expects objects with ``state_dict`` /
``load_state_dict``; training code often holds bare trees (parameter
dicts, NamedTuple optimizer states) or state behind getters and setters.
These adapters bridge the two without wrapper classes.
"""

from typing import Any, Callable, Dict

from .tree import from_state_dict, to_state_dict


class PytreeStateful:
    """Wraps a bare tree so it participates in an app state.

    A plain-container tree (nested dict/list/tuple of tensors) passes
    through as it is; set ``convert=True`` for others (NamedTuple states)
    to round-trip through plain containers, keeping the original
    structure on load::

        state = PytreeStateful({"params": params})
        Snapshot.take(path, {"train": state})
        ...
        Snapshot(path).restore({"train": state})
        params = state.tree["params"]
    """

    def __init__(self, tree: Any, convert: bool = False) -> None:
        self.tree = tree
        self._convert = convert

    def state_dict(self) -> Dict[str, Any]:
        if self._convert:
            return to_state_dict(self.tree)
        return self.tree

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        if self._convert:
            self.tree = from_state_dict(self.tree, state_dict)
        else:
            self.tree = state_dict


class FnStateful:
    """Builds a Stateful from getter/setter callables, for state owned by
    an object you cannot (or do not want to) subclass::

        FnStateful(lambda: trainer.get_state(), trainer.set_state)
    """

    def __init__(
        self,
        get_fn: Callable[[], Dict[str, Any]],
        set_fn: Callable[[Dict[str, Any]], None],
    ) -> None:
        self._get = get_fn
        self._set = set_fn

    def state_dict(self) -> Dict[str, Any]:
        return self._get()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self._set(state_dict)
