"""Core: the paper's contribution, TDC + Winograd deconvolution (numpy and
torch only)."""
from .baselines import standard_deconv2d
from .tdc import (
    ConvDims, ConvSubFilterPlan, DeconvDims, SubFilterPlan, conv_plan, conv_same_dims,
    decompose_conv_weights, decompose_weights, plan,
)
from .winograd import WinogradTransform, f23, get_transform
from .winograd_deconv import transform_conv_weights, transform_weights

__all__ = [
    "DeconvDims", "SubFilterPlan", "plan", "decompose_weights",
    "ConvDims", "ConvSubFilterPlan", "conv_plan", "conv_same_dims", "decompose_conv_weights",
    "WinogradTransform", "get_transform", "f23",
    "transform_weights", "transform_conv_weights", "standard_deconv2d",
]
