"""Matrix products with both operands rounded to TF32 (10 mantissa bits,
round to nearest) and float32 accumulation, as the tensor cores compute with
TF32 on: the references' control, one precision below float32."""

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # Sum any broadcast batch dims of b back to its shape.
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` in float32, or with TF32 operands where ``tf32``."""
    return _Matmul.apply(a, b) if tf32 else torch.matmul(a, b)
