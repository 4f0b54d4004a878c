"""Plain ops that give every instance the same bits under ``vmap``,
whatever the batch.

On the card, cuBLAS and cuSOLVER take another algorithm for a batched
matrix product or solve than for a single one, and PyTorch's reductions
split a long sum by the number of outputs: under vmap an instance's
result would depend on how many instances share the call, and an
ill-conditioned solve grows that last bit into millimetres of pose within
a few scans.  Each op here is a custom operator whose vmap rule makes the
single call once per instance, on that instance's slice (its strides as
the single call has them), so every instance gets exactly the bits of its
own single step, on any device.  Outside vmap each is the plain op
itself.

A call under vmap costs one single call per instance, so the fleet's main
path on the card keeps them off its hot loops: its users there are the
two sums of ``pipeline._adjust_voxel_size``.  The plain versions of the
hand kernels (registration's among them), which the CPU takes, use them
too; on the card those run as kernels, one launch a fleet.
"""

from typing import Optional

import torch
from torch import Tensor


def _each(fn, info, in_dims, *args):
    outs = [fn(*(a.select(d, i) if d is not None else a
                 for a, d in zip(args, in_dims)))
            for i in range(info.batch_size)]
    return torch.stack(outs), 0


@torch.library.custom_op("superodom::matmul", mutates_args=())
def matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b``."""
    return torch.matmul(a, b)


@matmul.register_vmap
def _(info, in_dims, a, b):
    return _each(torch.matmul, info, in_dims, a, b)


def _einsum(equation: str, a: Tensor, b: Tensor,
            c: Optional[Tensor] = None) -> Tensor:
    return torch.einsum(equation, a, b) if c is None \
        else torch.einsum(equation, a, b, c)


@torch.library.custom_op("superodom::einsum", mutates_args=())
def einsum(equation: str, a: Tensor, b: Tensor,
           c: Optional[Tensor] = None) -> Tensor:
    """``torch.einsum(equation, a, b[, c])``."""
    return _einsum(equation, a, b, c)


@einsum.register_vmap
def _(info, in_dims, equation, a, b, c=None):
    return _each(_einsum, info, in_dims, equation, a, b, c)


def _solve(A: Tensor, B: Tensor) -> Tensor:
    # solve_ex: no host round trip for the error check; a singular system
    # yields non-finite entries, which the callers zero out
    return torch.linalg.solve_ex(A, B)[0]


@torch.library.custom_op("superodom::solve", mutates_args=())
def solve(A: Tensor, B: Tensor) -> Tensor:
    """X with A X = B (``torch.linalg.solve_ex``, its info not read)."""
    return _solve(A, B)


@solve.register_vmap
def _(info, in_dims, A, B):
    return _each(_solve, info, in_dims, A, B)


def _sum(x: Tensor, dim: Optional[int] = None) -> Tensor:
    return torch.sum(x) if dim is None else torch.sum(x, dim=dim)


@torch.library.custom_op("superodom::reduce_sum", mutates_args=())
def reduce_sum(x: Tensor, dim: Optional[int] = None) -> Tensor:
    """``torch.sum(x)``, or over ``dim``."""
    return _sum(x, dim)


@reduce_sum.register_vmap
def _(info, in_dims, x, dim=None):
    return _each(_sum, info, in_dims, x, dim)
