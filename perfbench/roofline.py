"""Peaks of the card and the operation and byte counts of the measured work.

NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 495 TFLOP/s in
TF32 on the tensor cores, 3.35 TB/s of HBM3. A float32-accurate product is
at least three TF32 products (3xTF32: hi·hi + hi·lo + lo·hi of each operand's
two TF32 terms, as the port's flash kernels compute float32), so the least
time for float32 work is at 495/3 = 165 TFLOP/s; the 67 TFLOP/s float32 rate
outside the tensor cores is slower. No float32-accurate step can read above
100 % of this peak. The bounds below are copied from ``chip_smoke.py``'s
``flash_bound`` and ``bwd_bound``.
"""

PEAK_F32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def flash_forward_bound_s(b: int, h: int, s: int, d: int, causal: bool = True) -> float:
    """Least seconds of one float32 flash forward (K1): Q·Kᵀ and P·V over the
    (query, key) pairs the mask keeps, 2 flops a multiply-add; q, k, v read
    and out, lse written once."""
    flops = 4 * b * h * d * _pairs(s, causal)
    nbytes = 4 * b * h * s * d * F32_BYTES + b * h * s * 4
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def flash_backward_bound_s(b: int, h: int, s: int, d: int, products: int, out_heads: int,
                           causal: bool = True) -> float:
    """Least seconds of one float32 flash backward kernel: ``products``
    products of 2·D flops a kept pair; q, dO, k, v read, lse and delta in
    float32, ``out_heads`` float32 [B, S, D] outputs written once. K2 (dq)
    has 3 products and H output heads, K3 (dk, dv) 4 and 2·H."""
    flops = products * 2 * d * b * h * _pairs(s, causal)
    nbytes = 4 * b * h * s * d * F32_BYTES + 2 * b * h * s * 4 + out_heads * b * s * d * 4
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


# Kernel name (as the profiler reports it) -> bound of one launch at (B, H, S, Dh).
FLASH_KERNELS = {
    "flash_fwd_kernel": lambda b, h, s, d: flash_forward_bound_s(b, h, s, d),
    "flash_bwd_dq_kernel": lambda b, h, s, d: flash_backward_bound_s(b, h, s, d, 3, h),
    "flash_bwd_dkv_kernel": lambda b, h, s, d: flash_backward_bound_s(b, h, s, d, 4, 2 * h),
}


def transformer_step_flops(b: int, s: int, d: int, ff: int, layers: int, vocab: int, heads: int) -> float:
    """Model flops of one training step (forward and backward, 3× the
    forward's products, nothing recomputed counted): per layer the q, k, v,
    o and MLP products and causal attention's two products over the kept
    pairs; the tied head."""
    tokens = b * s
    per_layer = 2 * tokens * (4 * d * d + 2 * d * ff)
    attention = 4 * b * heads * (d // heads) * _pairs(s, True)
    head = 2 * tokens * d * vocab
    return 3.0 * (layers * (per_layer + attention) + head)
