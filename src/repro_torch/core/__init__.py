"""Core: the paper's contribution, TDC + Winograd deconvolution (numpy and
torch only)."""
from .baselines import standard_deconv2d
from .tdc import DeconvDims, SubFilterPlan, decompose_weights, plan
from .winograd import WinogradTransform, f23, get_transform
from .winograd_deconv import transform_weights

__all__ = [
    "DeconvDims", "SubFilterPlan", "plan", "decompose_weights",
    "WinogradTransform", "get_transform", "f23",
    "transform_weights", "standard_deconv2d",
]
