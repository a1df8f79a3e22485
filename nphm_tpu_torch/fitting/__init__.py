from nphm_tpu_torch.fitting.inference import (
    FittingConfig,
    default_joint_lambdas,
    default_joint_schedule,
    fit_identity,
    fit_joint,
    fit_joint_batch,
)

__all__ = [
    "FittingConfig",
    "default_joint_lambdas",
    "default_joint_schedule",
    "fit_identity",
    "fit_joint",
    "fit_joint_batch",
]
