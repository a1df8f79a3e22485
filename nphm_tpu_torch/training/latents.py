"""Auto-decoder latent tables (counterpart of ``nphm_tpu/training/latents.py``).

Replicates the reference's latent machinery (training.py:29-55):

- ``torch.nn.Embedding(n, d, max_norm=1.0)``: rows accessed in a forward
  pass are renormed to norm <= max_norm before lookup (``renorm_rows``).
- ``torch.optim.SparseAdam``: one global step counter per table; moments
  are updated only for rows that received gradient this step, and bias
  correction uses the global step (``row_adam_update``).
- ``clip_grad_norm_`` over the (coalesced) sparse gradient == global-norm
  clip of the dense gradient (``clip_global_norm``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RowAdamState(NamedTuple):
    step: torch.Tensor  # scalar int32
    exp_avg: torch.Tensor  # [n, d]
    exp_avg_sq: torch.Tensor  # [n, d]


def renorm_rows(table, idx, max_norm: float):
    """Rows ``idx`` projected to norm <= max_norm (a new table)."""
    rows = table[idx]
    norms = torch.sqrt(torch.sum(rows * rows, dim=-1, keepdim=True))
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return table.index_put((idx,), rows * scale)


def row_adam_init(table) -> RowAdamState:
    return RowAdamState(torch.zeros((), dtype=torch.int32, device=table.device),
                        torch.zeros_like(table), torch.zeros_like(table))


def row_adam_update(table, grads, state: RowAdamState, idx, lr, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8):
    """SparseAdam step: moments and updates only on rows present in ``idx``.

    grads: dense [n, d] gradient (zeros on untouched rows, which is what
    autograd through a gather produces).  Returns (table, state).
    """
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    touched[idx] = True
    touched = touched[:, None]
    step = state.step + 1
    exp_avg = torch.where(touched, b1 * state.exp_avg + (1 - b1) * grads, state.exp_avg)
    exp_avg_sq = torch.where(
        touched, b2 * state.exp_avg_sq + (1 - b2) * grads * grads, state.exp_avg_sq
    )
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=table.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=table.device), stepf)
    denom = torch.sqrt(exp_avg_sq / bc2) + eps
    update = torch.where(touched, lr * (exp_avg / bc1) / denom, 0.0)
    return table - update, RowAdamState(step, exp_avg, exp_avg_sq)


def clip_global_norm(grads, max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics on a list of tensors.

    Returns (clipped list, total norm).
    """
    total = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [g * scale for g in grads], total
