"""The arithmetic the plain references run in.

``F32`` is the reference: every product in float32 on the CUDA cores
(TF32 off, see :func:`strict_f32`).  ``FP8`` is the control, the
reference a precision step below the configurations' bfloat16: each
matrix product's operands, and the scan's r, k, v, rounded to float8
e4m3 with one scale a tensor (its largest magnitude to 448), the product
and everything else still in float32.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, in f32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    # rounding has no useful derivative: pass the gradient straight through
    return x + (q - x).detach() if x.requires_grad else q


@dataclass(frozen=True)
class Precision:
    name: str
    fp8: bool = False

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return to_fp8(x) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` in f32 from this precision's operands."""
        return self.operand(x) @ self.operand(w)


F32 = Precision("f32")
FP8 = Precision("fp8", fp8=True)


@contextlib.contextmanager
def strict_f32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN, put
    back as they were on exit."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)
