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
]
