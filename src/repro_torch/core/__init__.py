"""Core: the paper's contribution, TDC + Winograd deconvolution (numpy and
torch only)."""
from .baselines import lax_deconv2d, standard_deconv2d, zero_padded_deconv2d
from .tdc import (
    ConvDims, ConvSubFilterPlan, DeconvDims, SubFilterPlan, conv_plan, conv_same_dims,
    decompose_conv_weights, decompose_weights, interleave_crop, pad_input_for_subconv, plan, tdc_deconv2d,
    SubFilterPlan1D, decompose_weights_1d, plan_1d, tdc_deconv1d,
)
from .winograd import WinogradTransform, f23, get_transform
from .winograd_deconv import (
    transform_conv_weights, transform_input_tiles, transform_weights, winograd_deconv2d, winograd_domain_matmuls,
)

__all__ = [
    "DeconvDims", "SubFilterPlan", "plan", "decompose_weights", "pad_input_for_subconv", "interleave_crop",
    "tdc_deconv2d", "SubFilterPlan1D", "plan_1d", "decompose_weights_1d", "tdc_deconv1d",
    "ConvDims", "ConvSubFilterPlan", "conv_plan", "conv_same_dims", "decompose_conv_weights",
    "WinogradTransform", "get_transform", "f23",
    "transform_weights", "transform_conv_weights", "transform_input_tiles", "winograd_domain_matmuls",
    "winograd_deconv2d", "standard_deconv2d", "zero_padded_deconv2d", "lax_deconv2d",
]
