from nphm_tpu_torch.evaluation.metrics import distance_p2p, eval_pointcloud
from nphm_tpu_torch.evaluation.render import (
    fibonacci_sphere,
    gen_render_samples,
    look_at,
    rasterize,
)

__all__ = [
    "eval_pointcloud",
    "distance_p2p",
    "rasterize",
    "gen_render_samples",
    "fibonacci_sphere",
    "look_at",
]
