from .attention_lr import AttentionLR, CrossAttentionLR
from .factory import UNET_FAST_IN64, create_denoiser, init_random_params
from .unet import UNetBackbone, UNetModel
from .zoo import LatentFC, VDMUNet

__all__ = ["AttentionLR", "CrossAttentionLR", "UNetBackbone", "UNetModel", "create_denoiser",
           "init_random_params", "UNET_FAST_IN64", "LatentFC", "VDMUNet"]
