"""RNGState: capture/restore the process's implicit RNG streams.

Captured:

- the global numpy RNG (``np.random.get_state``) and Python's ``random``
  module state — the same two keys the JAX package records, so an RNG
  state taken by either package restores through the other;
- ``torch.get_rng_state()`` (the CPU generator) and, once CUDA has been
  initialised, ``torch.cuda.get_rng_state_all()``. A snapshot without
  these keys (one taken by the JAX package) still loads: absent streams
  keep their current state.

``Snapshot.take`` saves the RNG stateful *first* and re-loads it after
all other statefuls were saved, so RNG side effects of their
``state_dict()`` calls do not leak into the post-take program; restore
loads it last. At most one ``RNGState`` may appear in an app state.
"""

import random
from typing import Any, Dict

import numpy as np
import torch

_TORCH_KEY = "torch_rng_state"
_CUDA_KEY = "torch_cuda_rng_states"


class RNGState:
    """A ``Stateful`` that captures the implicit RNG streams."""

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "numpy_rng_state": np.random.get_state(),
            "python_rng_state": random.getstate(),
            _TORCH_KEY: torch.get_rng_state(),
        }
        if torch.cuda.is_initialized():
            state[_CUDA_KEY] = torch.cuda.get_rng_state_all()
        return state

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        np_state = state_dict["numpy_rng_state"]
        # The state tuple's second element may round-trip as a list/array
        # of ints; np.random.set_state requires the canonical tuple form.
        if isinstance(np_state, (list, tuple)):
            np_state = tuple(
                np.asarray(e, dtype=np.uint32)
                if isinstance(e, (list, np.ndarray)) and i == 1
                else e
                for i, e in enumerate(np_state)
            )
        np.random.set_state(np_state)
        py_state = state_dict["python_rng_state"]
        if isinstance(py_state, list):
            py_state = tuple(
                tuple(e) if isinstance(e, list) else e for e in py_state
            )
        random.setstate(py_state)
        if state_dict.get(_TORCH_KEY) is not None:
            torch.set_rng_state(state_dict[_TORCH_KEY].cpu())
        cuda_states = state_dict.get(_CUDA_KEY)
        if cuda_states is not None:
            torch.cuda.set_rng_state_all([s.cpu() for s in cuda_states])
