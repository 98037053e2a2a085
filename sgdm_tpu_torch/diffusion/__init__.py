from .core import GaussianDiffusion
from .guidance import guided_score, make_guided_denoiser
from .schedule import DiffusionSchedule

__all__ = ["GaussianDiffusion", "DiffusionSchedule", "guided_score",
           "make_guided_denoiser"]
