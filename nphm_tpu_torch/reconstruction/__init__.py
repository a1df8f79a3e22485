from nphm_tpu_torch.reconstruction.extract import (
    deform_mesh,
    extract_mesh,
    extract_mesh_streamed,
    get_logits,
    get_logits_backward,
    make_point_evaluator,
)
from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse

__all__ = [
    "make_point_evaluator",
    "get_logits",
    "get_logits_backward",
    "deform_mesh",
    "extract_mesh",
    "extract_mesh_streamed",
    "extract_mesh_sparse",
]
