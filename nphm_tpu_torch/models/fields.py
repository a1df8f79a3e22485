"""Field calculus for implicit decoders (counterpart of
``nphm_tpu/models/fields.py``; reference ``diff_operators.py``).

Fields are point-wise: the value at point i depends only on x_i, so the
per-point derivatives are reverse passes of sums over the points: one for a
gradient, one per output for a 3x3 Jacobian, one per output and input
direction for a Hessian.  Every pass is taken with ``create_graph`` so an
outer loss can differentiate the result again (the eikonal double backprop;
reference ``diff_operators.py:69-79``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from nphm_tpu_torch.ops import precision


def _grad_input(xyz):
    """A node to differentiate with respect to: a fresh leaf when ``xyz``
    carries no graph, else a copy inside the graph (outer gradients still
    reach ``xyz``, and only paths through the copy count as the field's)."""
    return xyz.clone() if xyz.requires_grad else xyz.detach().requires_grad_(True)


def value_and_spatial_gradient(field_fn, xyz):
    """(field values, per-point gradients [..., N, 3]) from one forward pass.

    field_fn: xyz [..., N, 3] -> values [..., N, 1] (or [..., N]).
    """
    with torch.enable_grad():
        q = _grad_input(xyz)
        values = field_fn(q)
        (grads,) = torch.autograd.grad(values.sum(), q, create_graph=True)
    return values, grads


def rematerialized(field_fn):
    """``field_fn`` whose forward is recomputed in the backward pass instead
    of kept (``torch.utils.checkpoint``, non-reentrant, so the recompute is
    differentiable again under ``create_graph``; the counterpart of
    ``jax.checkpoint``).  The recompute runs at the forward's matmul
    precision; the field must draw no random numbers (none of the decoders
    does), so no RNG state is saved."""

    def field(xyz):
        p = precision.current()

        def run(x):
            with precision.matmul_precision(p):
                return field_fn(x)

        return torch.utils.checkpoint.checkpoint(run, xyz, use_reentrant=False,
                                                 preserve_rng_state=False)

    return field


def spatial_gradient(field_fn, xyz):
    """Per-point gradient [..., N, 3] of a scalar field, differentiable."""
    return value_and_spatial_gradient(field_fn, xyz)[1]


def _rows(out, q, create_graph: bool):
    """[..., C, 3]: d out[..., c] / d q per channel c of out [..., C]."""
    n = out.shape[-1]
    rows = [torch.autograd.grad(out[..., c].sum(), q, retain_graph=create_graph or c < n - 1,
                                create_graph=create_graph)[0] for c in range(n)]
    return torch.stack(rows, dim=-2)


def point_jacobian(vector_fn, xyz, *, create_graph: bool = True):
    """Per-point 3x3 Jacobian of a point-wise map vector_fn: [..., N, 3] ->
    [..., N, 3].

    Returns J [..., N, 3, 3] with J[..., i, j] = d out_i / d x_j, the layout
    of the reference ``jac`` (diff_operators.py:26-54).  ``create_graph=False``
    gives a constant (a search's initial inverse Jacobian needs no graph).
    """
    with torch.enable_grad():
        q = _grad_input(xyz)
        return _rows(vector_fn(q), q, create_graph)


def warp_jacobian(deform_fn, xyz):
    """Jacobian of the forward warp x -> x + delta(x)."""
    return point_jacobian(lambda x: x + deform_fn(x), xyz)


def point_hessian(field_fn, xyz):
    """Per-point Hessian of a point-wise field.

    field_fn: xyz [..., N, 3] -> values [..., N, C] (or [..., N]).
    Returns H [..., N, C, 3, 3] with H[..., c, i, j] = d^2 f_c / dx_i dx_j,
    the layout of the reference ``hessian`` (diff_operators.py:5-24) minus
    its NaN status flag.
    """
    with torch.enable_grad():
        q = _grad_input(xyz)
        values = field_fn(q)
        if values.shape == q.shape[:-1]:
            values = values[..., None]
        grads = _rows(values, q, True)  # [..., N, C, 3]
        return _rows(grads.reshape(grads.shape[:-2] + (-1,)), q, True).reshape(
            grads.shape + (3,))


def divergence(vector_fn, xyz):
    """Per-point divergence [..., N, 1] of a point-wise R^3 -> R^3 field
    (reference diff_operators.py:62-66): the trace of its Jacobian."""
    J = point_jacobian(vector_fn, xyz)
    return torch.diagonal(J, dim1=-2, dim2=-1).sum(dim=-1, keepdim=True)


def laplace(field_fn, xyz):
    """Per-point Laplacian [..., N, 1] of a scalar field (reference
    diff_operators.py:57-59): the divergence of its gradient."""
    return divergence(lambda x: spatial_gradient(field_fn, x), xyz)
