"""What the port's accuracy gates (``test_torch_accuracy_gate*.py``) share:
the box, held-out head, ground-truth surface and Chamfer-L1 of
``nphm_tpu_torch.synthetic_e2e``, the JAX decoders' init as port tensors,
and the gates' CPU settings.  A gate imports ``two_threads`` so that the
fixture applies to its module."""

import numpy as np
import pytest

import jax
import torch

from nphm_tpu_torch import synthetic_e2e
from nphm_tpu_torch.synthetic_e2e import (  # noqa: F401  (re-exported for the gates)
    BOX,
    HELDOUT_CENTER,
    HELDOUT_RADII,
    _gt_surface,
)
from nphm_tpu_torch.utils.params import from_numpy_pytree

DEV = "cpu"
# the trainers' epoch-0 reconstruction logs (read by no assertion) at the
# gates' own extraction resolution, not the trainer default 256
RECON_RES = 64


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    where more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_init(jax_decoder, key: int):
    """The JAX decoder's init at ``key``, as port tensors on the CPU."""
    params = jax_decoder.init(jax.random.PRNGKey(key))
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, params), DEV)


def chamfer(mesh, gt_pts):
    """Chamfer-L1 of ``mesh`` against ``gt_pts``, as ``synthetic_e2e``
    measures it; prints the figure (seen with ``pytest -s``)."""
    ch = synthetic_e2e._chamfer(mesh, gt_pts)
    print(f"chamfer_l1 {ch:.5f}")
    return ch
