"""Field calculus for implicit decoders (counterpart of the part of
``nphm_tpu/models/fields.py`` that stage-1 training uses).

Fields are point-wise: the value at point i depends only on x_i, so the
per-point spatial gradient is one reverse pass of the summed field, taken
with ``create_graph`` so an outer loss can differentiate it again (the
eikonal double backprop; reference ``diff_operators.py:69-79``).
"""

from __future__ import annotations

import torch


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


def spatial_gradient(field_fn, xyz):
    """Per-point gradient [..., N, 3] of a scalar field, differentiable."""
    return value_and_spatial_gradient(field_fn, xyz)[1]
