from .core import SAMPLER_REGISTRY, GaussianDiffusion
from .guidance import guided_score, make_guided_denoiser, prob_mask_like
from .losses import p_losses, pointwise_loss
from .schedule import (
    DiffusionSchedule,
    clip_x0,
    extract,
    make_beta_schedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
    normalize_to_neg_one_to_one,
    predict_noise_from_start,
    predict_start_from_noise,
    q_posterior,
    q_sample,
    unnormalize_to_zero_to_255,
)

__all__ = [
    "SAMPLER_REGISTRY",
    "GaussianDiffusion",
    "DiffusionSchedule",
    "guided_score",
    "make_guided_denoiser",
    "prob_mask_like",
    "p_losses",
    "pointwise_loss",
    "clip_x0",
    "extract",
    "make_beta_schedule",
    "make_ddim_sampling_parameters",
    "make_ddim_timesteps",
    "normalize_to_neg_one_to_one",
    "predict_noise_from_start",
    "predict_start_from_noise",
    "q_posterior",
    "q_sample",
    "unnormalize_to_zero_to_255",
]
