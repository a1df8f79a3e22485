"""Data preparation CLIs (counterparts of ``scripts/data_processing/``):
``sample_surface`` (identity supervision), ``sample_deformation_field``
(expression correspondences) and ``generate_single_view_observations``
(the test split's single-view point clouds).  Host-only numpy; their worker
pools start by ``spawn`` and import no torch."""
