"""Operand rounding of the reference's matrix products.

``Precision("f32")`` leaves them as they are (float32 with TF32 off).
``Precision("fp8")`` rounds both operands of every product to float8 e4m3
with a per-tensor scale (the tensor's largest magnitude onto e4m3's
largest, 448), as an fp8 GEMM takes them; the gradient passes straight
through the rounding. That is the control: the step below the bfloat16
that the configurations state."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()

    def linear(self, x, w, b=None):
        y = self(x) @ self(w).t()
        return y if b is None else y + b

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self(a), self(b))
