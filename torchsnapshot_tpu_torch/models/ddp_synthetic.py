"""Synthetic DDP-style benchmark model, ported from the JAX package.

The analog of the reference's DDP benchmark (reference
benchmarks/ddp/main.py:38-39): a model that is nothing but ``n_params``
large parameters (200 × 100 MiB ≈ 20 GB in the reference; sized down per
run). Its state dict is ``param_0 … param_{n-1}``, as in
``torchsnapshot_tpu/models/ddp_synthetic.py``, so a snapshot of the same
arrays has the same logical paths in either package; taken with
``replicated=["**"]`` it measures raw throughput with replicated striping.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .transformer import _resolve_device, params_from_numpy


class SyntheticModel:
    """A Stateful of ``n_params`` dense 1-D tensors of ``param_bytes``
    each, drawn from a seeded ``torch.Generator`` on ``device`` (the card
    unless the caller passes ``device="cpu"``). The numbers differ from
    the JAX model's; :meth:`from_numpy` loads the JAX model's arrays."""

    def __init__(
        self,
        n_params: int = 200,
        param_bytes: int = 100 * 1024 * 1024,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device: Any = None,
    ) -> None:
        device = _resolve_device(device)
        n_elems = param_bytes // dtype.itemsize
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params: Dict[str, torch.Tensor] = {
            f"param_{i}": torch.randn(n_elems, generator=gen, device=device, dtype=dtype)
            for i in range(n_params)
        }

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device: Any = None) -> "SyntheticModel":
        """The model holding ``arrays`` (the JAX model's ``state_dict()``
        as numpy) as tensors on ``device``."""
        model = cls.__new__(cls)
        model.params = params_from_numpy(dict(arrays), device)
        return model

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.params = dict(state_dict)

    def total_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.params.values())
