"""nphm_tpu_torch: the PyTorch/CUDA port of ``nphm_tpu`` for NVIDIA Hopper.

The JAX package ``nphm_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find:

- ``models``: the NPHM ensemble decoder, the forward deformation field in
  all five modes and the field calculus, as plain functions over dicts of
  tensors (same key paths as the JAX parameter pytrees; ``utils.params``
  bridges the two).
- ``ops``: the hand-written CUDA kernels (``csrc/*.cu``) with their plain
  PyTorch versions beside them: ensemble grid evaluation (``ops.ensemble``),
  the fused Broyden search (``ops.search``), the fit field forward and
  backward (``ops.fit_fields``) and the training field with its double
  backprop (``ops.train_fields``); host marching (``ops.marching``).
- ``fitting``: Broyden root finding, IFT gradients and ``fit_joint``.
- ``reconstruction``: dense grid logits, mesh extraction and deformation.
- ``training``: the stage-1 identity trainer, its loss, latent optimizers
  and checkpoints; ``data``: the synthetic identity dataset.

The package imports ``torch`` and never ``jax``, and nothing of ``nphm_tpu``:
what it needs of the JAX package's host code (paths, mesh IO, marching and
its C++ source, synthetic data) it keeps as its own copies under the same
module names.  Entry points run on the GPU (``utils.params.default_device``)
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
