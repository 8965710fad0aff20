"""StateDict: a dict that is its own state dict.

Useful for capturing scalars that live outside any model/optimizer —
epoch counters, step numbers, best-metric trackers::

    progress = StateDict(epoch=0, step=0)
    app_state = {"model": model_state, "progress": progress}
    ...
    progress["step"] += 1
"""

from typing import Any, Dict


class StateDict(dict):
    """A ``dict`` that implements the ``Stateful`` protocol."""

    def state_dict(self) -> Dict[str, Any]:
        return dict(self)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.clear()
        self.update(state_dict)
