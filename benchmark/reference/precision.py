"""The precision a reference solve computes in.

"float64" is the reference. "float32" is the precision the configurations
state (TF32 off): a witness of what that precision alone does to the
answer, never a limit's reading. The two lower ones are controls, the step
a program might be tempted to take: "bf16" keeps every stage's output
(poses, residuals, Jacobians, Hessian blocks, gradient, step, the cost it
reports) in bfloat16 and computes in float32 between the stores, since
torch has no bfloat16 Cholesky; "tf32" computes in float32 with TF32
switched on (`torch.backends.cuda.matmul.allow_tf32`, for the card's
matrix products) and also rounds both operands of every product (the
Jacobian products, the Schur complement's and the back substitution's
matrix products) to TF32's 10-bit mantissa, as a tensor core does, so that
it means the same on any device.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("float64", "float32", "bf16", "tf32")


class Precision:
    def __init__(self, name: str = "float64"):
        if name not in NAMES:
            raise ValueError(f"unknown precision {name!r}; one of {NAMES}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's output as this precision keeps it."""
        if self.name == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product as this precision's multiplier reads it."""
        if self.name != "tf32":
            return x
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.operand(a), self.operand(b))

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 switched on for the card's float32 products while a "tf32"
        solve runs, off (as the program has it) otherwise."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.name == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
