"""The 3xTF32 split that K3-K5 and K7 run on the tensor cores, in plain PyTorch.

A TF32 tensor-core product keeps 10 explicit mantissa bits of each operand
(~1e-3 relative over a sum of 1024 terms), too coarse for the kernels' 1e-4
gates.  Each fp32 operand splits into ``big = tf32_round(x)`` and ``small =
tf32_round(x - big)``; ``big*big + big*small + small*big`` accumulated in fp32
keeps ~21 bits (the dropped small*small term is ~2^-22 of the product).

``tf32_round`` is the kernels' ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero), so K7's wrapper uses ``split_tf32`` to prepare its weight
halves on the device.  K3-K5 split in registers and leave the small half's
rounding to the tensor core, which truncates (``matmul_3xtf32(small=
"trunc")``).  ``matmul_3xtf32`` emulates the kernels' products: a
product of two TF32 values is exact in fp32, so an fp32 matmul of the halves
is the tensor cores' arithmetic up to summation order.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp32 holding the nearest TF32 value, ties away from zero.

    Adding half a TF32 unit to the magnitude bits and clearing the 13 low
    bits rounds the magnitude; the sign bit is untouched."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): TF32 halves with big + small ~= x to ~2^-22 relative."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp32 with the 13 low mantissa bits cleared: how a tensor core
    reads a .tf32 operand register."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, small: str = "round") -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 products, fp32 sums.

    small="round": both halves rounded to TF32 (K7, whose halves are stored);
    small="trunc": big rounded, the remainder passed whole and truncated by
    the tensor core (K3-K5's in-register split, ``tc_tile.cuh::split_mma``)."""
    if small not in ("round", "trunc"):
        raise ValueError(small)
    halves = []
    for x in (a, b):
        big = tf32_round(x)
        rest = x.to(torch.float32) - big
        halves.append((big, tf32_round(rest) if small == "round" else tf32_trunc(rest)))
    (ab, as_), (bb, bs) = halves
    return as_ @ bb + ab @ bs + ab @ bb


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (for comparison: what plain TF32 would give)."""
    return tf32_round(a) @ tf32_round(b)
