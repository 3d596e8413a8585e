"""Multi-device training on ``torch.distributed`` (the reference's
``parallel`` package): sharding specs for the GAN and the LM trees and
per-rank blocks, int8 gradient compression, the bucketed sharded train
steps, and the LM's tensor-parallel operators over "model" (``tp``)."""
from .sharding import (
    MeshAxes,
    P,
    PartitionSpec,
    Placement,
    audio_decoder_param_specs,
    block_of,
    cache_specs,
    gan_batch_specs,
    gan_param_specs,
    gather,
    lm_batch_specs,
    lm_grad_partial,
    lm_local_specs,
    lm_param_specs,
    named,
    opt_specs,
)

__all__ = ["MeshAxes", "P", "PartitionSpec", "Placement", "audio_decoder_param_specs", "block_of", "cache_specs",
           "gan_batch_specs", "gan_param_specs", "gather", "lm_batch_specs", "lm_grad_partial", "lm_local_specs",
           "lm_param_specs", "named", "opt_specs"]
