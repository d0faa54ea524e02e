"""The arithmetic the references run their products in.

``Exact`` is float32 with TF32 off: the reference. ``Fp8`` is the control,
one step below the bfloat16 the configurations state: both operands of every
product are rounded to float8 e4m3 with a per-tensor scale (largest
magnitude to 448, as an fp8 path with per-tensor scaling would do), then
multiplied in float32. Everything else (norms, softmax, sums) stays float32
in both.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def exact_float32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Exact:
    name = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, x, w, b=None):
        """``x @ w.T + b``, ``w`` in ``nn.Linear``'s [out, in] layout."""
        y = torch.matmul(self.q(x), self.q(w).t())
        return y if b is None else y + b


class Fp8(Exact):
    name = "fp8_e4m3"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = E4M3_MAX / amax
        # the rounding is the control's; the gradient passes straight through
        y = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (y - x).detach()


def make(name: str) -> Exact:
    return {"float32": Exact, "fp8_e4m3": Fp8}[name]()
