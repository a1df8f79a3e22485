"""Matmul precision of the trainers' steps and the fits' step loops
(counterpart of ``jax.default_matmul_precision`` as the JAX package uses
it: ``training.matmul_precision`` and ``FittingConfig.matmul_precision``).

The accepted names are JAX's, mapped to three precisions:

- "default", "highest", "float32" -> ``F32``: every product as without a
  context (fp32, TF32 off; K3-K6 split each operand in 3xTF32);
- "high", "tensorfloat32" -> ``TF32``: both operands of a product rounded
  to TF32 (``tf32.tf32_round``: nearest, ties away), the product summed in
  fp32; K3-K6 issue one tensor-core pass on those operands (the split's
  big halves);
- "bfloat16" -> ``BF16``: both operands rounded to bf16 (``bf16_round``:
  nearest even), the product summed in fp32; K3-K6 issue one TF32 pass
  on them, which is exact (a bf16 value is a TF32 value: the same 8-bit
  exponent and 7 of TF32's 10 mantissa bits).

"default" stays fp32 as the JAX package's own comments mean it
("f32-equivalent"); "high" is TF32, what JAX gives on an NVIDIA GPU.  Any
other name raises, JAX's dot-algorithm presets included (not ported).

``matmul_precision(name)`` sets the precision for the code it wraps, on a
``contextvars.ContextVar`` restored on exit; ``current()`` reads it.  It
never touches ``torch.backends`` or ``torch.set_float32_matmul_precision``,
so the arithmetic is the same on every host and nothing leaks past the
block.  Its readers: the models' products (``matmul`` and ``einsum`` here,
through ``models/``), the plain Broyden search and IFT correction
(``fitting/broyden.py``), K3-K6 and their plain versions.  K1, K2 and K7
and K2's plain version ignore it: the JAX package's K2 forces HIGHEST, and
extraction and posing run outside every scope.

Autograd threads do not inherit a context variable: whatever runs in a
backward pass (K4 and K6, the rounding's derivatives, a checkpointed
forward's recompute) takes the precision its forward saw.

Rounding is differentiated straight through.  ``matmul`` and ``einsum``
round what they multiply in every derivative too: the cotangent entering
a product's backward and, in a double backward, the cotangent entering
that backward's products, as the kernels' reverse products, tangent
products and lane contraction round theirs.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import functools

import torch

from nphm_tpu_torch.ops.tf32 import tf32_round


class Precision(enum.IntEnum):
    """The port's precisions; the values are the kernels' precision codes
    (``csrc/tc_tile.cuh`` ``tc::Precision``)."""

    F32 = 0
    TF32 = 1
    BF16 = 2


NAMES = {
    "default": Precision.F32,
    "highest": Precision.F32,
    "float32": Precision.F32,
    "high": Precision.TF32,
    "tensorfloat32": Precision.TF32,
    "bfloat16": Precision.BF16,
}

_CURRENT = contextvars.ContextVar("nphm_matmul_precision", default=Precision.F32)


def counters() -> dict:
    """A launch count per precision, all 0 (the kernel wrappers'
    ``launches_at``)."""
    return {p: 0 for p in Precision}


def resolve(name) -> Precision:
    """The precision of a JAX precision name; raises ValueError for any
    other value."""
    if isinstance(name, str) and name in NAMES:
        return NAMES[name]
    raise ValueError(f"matmul_precision {name!r}: expected one of {', '.join(NAMES)}")


def current() -> Precision:
    """The precision in effect (F32 outside every ``matmul_precision``)."""
    return _CURRENT.get()


@contextlib.contextmanager
def matmul_precision(name):
    """Run the block at the precision of ``name`` (a JAX name or a
    ``Precision``); the previous one is restored on exit, also on an
    exception."""
    token = _CURRENT.set(name if isinstance(name, Precision) else resolve(name))
    try:
        yield
    finally:
        _CURRENT.reset(token)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp32 holding the nearest bf16 value, ties to even (the
    kernels' ``cvt.rn.bf16.f32``): torch's bf16 cast and back, two
    elementwise kernels (bit for bit the integer form: add half a bf16 unit
    less one, plus the kept part's lowest bit, and clear the 16 low bits;
    NaN payloads aside)."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def round_operand(x: torch.Tensor, p: Precision) -> torch.Tensor:
    """x rounded as a product at precision p reads it (F32: unchanged)."""
    if p == Precision.TF32:
        return tf32_round(x)
    if p == Precision.BF16:
        return bf16_round(x)
    return x


class _RoundIn(torch.autograd.Function):
    """An operand rounded; its derivative is the identity, taken through
    ``_RoundOut`` so that a derivative of it rounds in turn."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return round_operand(x, p)

    @staticmethod
    def backward(ctx, g):
        return _RoundOut.apply(g, ctx.p), None


class _RoundOut(torch.autograd.Function):
    """A product's output unchanged; the cotangent entering its backward is
    rounded (through ``_RoundIn``)."""

    @staticmethod
    def forward(ctx, y, p):
        ctx.p = p
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _RoundIn.apply(g, ctx.p), None


def _at_precision(product, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``product(a, b)`` at the current precision (at F32 exactly it)."""
    p = current()
    if p == Precision.F32:
        return product(a, b)
    return _RoundOut.apply(product(_RoundIn.apply(a, p), _RoundIn.apply(b, p)), p)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` at the current precision."""
    return _at_precision(torch.matmul, a, b)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` at the current precision."""
    return _at_precision(functools.partial(torch.einsum, equation), a, b)
