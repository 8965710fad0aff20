"""The comparisons that decide ``correct``.

Three layers are compared:

- the training step: the program's first steps (run in set-up, on the same
  object and through the same call the window drives) against the plain
  reference's, from the same seeded weights and batches. Each step's loss,
  each leaf's first gradient norm as the optimizer applies it, and each
  leaf's change after the steps, each as the gap of the program's norm from
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger, taken at the worst leaf. Leaves whose reference
  gradient is under a thousandth of the median leaf's move by round-off
  alone and are left out of the gradient and change gaps.
- the take: the last snapshot the window committed, restored after the
  window, holds bit for bit the state at the step it captured (digests that
  depend on each word's value and place).
- the restore: after every restore in the window the state is bit for bit
  the rolled-back snapshot's (the same digests).
"""

import statistics
from typing import Any, Dict, List

import torch

# Elements of a leaf digested at once: bounds the temporaries (two int32
# tensors of this many elements) and keeps a chunk's sum under 2**53.
_DIGEST_CHUNK = 1 << 22
# Host-side combination of the chunk sums: modulo a Mersenne prime, each
# chunk's sum times a multiplier drawn from its place in the state.
_PRIME = (1 << 61) - 1
_WEIGHTS: Dict[Any, torch.Tensor] = {}


def _weights(device: torch.device, chunk: int) -> torch.Tensor:
    """[2, chunk] int32 weights in [1, 2**15), fixed for every run: one row
    for the low and one for the high half-words of a chunk's elements."""
    key = (str(device), chunk)
    if key not in _WEIGHTS:
        g = torch.Generator().manual_seed(0x5EED)
        _WEIGHTS[key] = torch.randint(1, 1 << 15, (2, chunk), generator=g, dtype=torch.int32).to(device)
    return _WEIGHTS[key]


def _multiplier(leaf: int, chunk: int) -> int:
    return (0x9E3779B97F4A7C15 * (leaf * 1_000_003 + chunk + 1)) % _PRIME or 1


def digests(tensors: List[torch.Tensor], chunk: int = _DIGEST_CHUNK) -> List[int]:
    """Per tensor: a digest of its 32-bit words (float32 state) that depends
    on each word's value and place. Each half-word is weighted by a fixed
    pseudo-random weight of its offset in its chunk, and each chunk's exact
    sum by a multiplier of the chunk's place, so an altered element, pieces
    written at each other's offsets and transposed rows all change it. One
    transfer to the host for all."""
    sums, counts = [], []
    for t in tensors:
        words = t.detach().reshape(-1).view(torch.int32)
        w = _weights(words.device, chunk)
        parts = torch.split(words, chunk)
        for part in parts:
            n = part.numel()
            lo = (part & 0xFFFF).mul_(w[0, :n])
            hi = (part >> 16).bitwise_and_(0xFFFF).mul_(w[1, :n])
            sums.append(torch.stack((lo.sum(dtype=torch.int64), hi.sum(dtype=torch.int64))))
        counts.append(len(parts))
    flat = torch.stack(sums).tolist() if sums else []
    out, at = [], 0
    for leaf, (t, n) in enumerate(zip(tensors, counts)):
        d = t.numel()
        for c in range(n):
            lo, hi = flat[at + c]
            d = (d + _multiplier(leaf, 2 * c) * lo + _multiplier(leaf, 2 * c + 1) * hi) % _PRIME
        out.append(d)
        at += n
    return out


def norm_gap(program: List[float], reference: List[float], keep: List[bool]) -> float:
    """Worst leaf's |‖program‖ − ‖reference‖| over max(reference leaf, median leaf)."""
    kept = [r for r, k in zip(reference, keep) if k]
    median = statistics.median(kept)
    return max(abs(p - r) / max(r, median) for p, r, k in zip(program, reference, keep) if k)


def step_gaps(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, float]:
    """The three numbers of the training-step comparison."""
    median = statistics.median(reference["grad1"])
    keep = [g >= 1e-3 * median for g in reference["grad1"]]
    loss_gap = max(
        abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])
    )
    return {
        "loss_gap": loss_gap,
        "grad1_gap": norm_gap(program["grad1"], reference["grad1"], keep),
        "change3_gap": norm_gap(program["change"], reference["change"], keep),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every number compared."""
    return {name: {"value": numbers[name], "limit": limits[name]} for name in numbers}


def passed(table: Dict[str, Dict[str, float]]) -> bool:
    # A NaN reads as failed: the comparison is False.
    return all(entry["value"] <= entry["limit"] for entry in table.values())
