"""nphm_tpu_torch: the PyTorch/CUDA port of ``nphm_tpu`` for NVIDIA Hopper.

The JAX package ``nphm_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find:

- ``models``: the NPHM ensemble decoder and the forward deformation field,
  as plain functions over dicts of tensors (same key paths as the JAX
  parameter pytrees; ``utils.params`` bridges the two).
- ``ops``: the hand-written CUDA kernels (``csrc/*.cu``) with their plain
  PyTorch versions beside them: ensemble grid evaluation (``ops.ensemble``),
  the fused Broyden search (``ops.search``) and the fit field forward and
  backward (``ops.fit_fields``).
- ``fitting``: Broyden root finding, IFT gradients and ``fit_joint``.
- ``reconstruction``: dense grid logits, mesh extraction and deformation.

The package imports ``torch`` and never ``jax``.  Host-side numpy modules of
``nphm_tpu`` (marching, grids, mesh IO) are reused as they are.
"""

__version__ = "0.1.0"
