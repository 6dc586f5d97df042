"""The arithmetic of the plain reference: every product in float32 with
TF32 off, or, for the control, every product's operands rounded to fp8
(e4m3, one scale per tensor) first and the product accumulated in float32:
what an fp8 path would compute in the program's place."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def strict_fp32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Numerics:
    """``precision`` "fp32" (the reference) or "fp8" (the control)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product: float32, or its fp8 rounding."""
        t = t.float()
        if self.precision == "fp32":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """x @ w^T + b with w in torch's [out, in] layout."""
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b.float()

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def conv3d(self, x: torch.Tensor, w: torch.Tensor, b, stride, padding) -> torch.Tensor:
        """NCDHW x, OIDHW w."""
        return F.conv3d(self.q(x), self.q(w), None if b is None else b.float(), stride, padding)
