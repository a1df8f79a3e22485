from nphm_tpu_torch.models.deepsdf import DeepSDFConfig, apply_deepsdf, init_deepsdf
from nphm_tpu_torch.models.decoders import (
    Decoder,
    make_deformation_decoder,
    make_nphm_decoder,
    make_npm_decoder,
)
from nphm_tpu_torch.models.deformation import (
    DeformationConfig,
    apply_deformation,
    init_deformation,
)
from nphm_tpu_torch.models.ensemble import (
    NPHMConfig,
    apply_nphm,
    gaussian_blend,
    init_nphm,
    predict_anchors,
)
from nphm_tpu_torch.models.fields import (
    divergence,
    laplace,
    point_hessian,
    point_jacobian,
    spatial_gradient,
    value_and_spatial_gradient,
    warp_jacobian,
)

__all__ = [
    "DeepSDFConfig",
    "init_deepsdf",
    "apply_deepsdf",
    "NPHMConfig",
    "init_nphm",
    "apply_nphm",
    "predict_anchors",
    "gaussian_blend",
    "DeformationConfig",
    "init_deformation",
    "apply_deformation",
    "Decoder",
    "make_nphm_decoder",
    "make_deformation_decoder",
    "make_npm_decoder",
    "spatial_gradient",
    "value_and_spatial_gradient",
    "point_jacobian",
    "warp_jacobian",
    "point_hessian",
    "divergence",
    "laplace",
]
