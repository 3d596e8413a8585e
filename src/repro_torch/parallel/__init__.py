"""Multi-device training on ``torch.distributed`` (the GAN half of the
reference's ``parallel`` package): sharding specs and per-rank blocks,
int8 gradient compression, and the bucketed sharded train steps."""
from .sharding import (
    MeshAxes,
    P,
    PartitionSpec,
    Placement,
    audio_decoder_param_specs,
    block_of,
    gan_batch_specs,
    gan_param_specs,
    gather,
    named,
    opt_specs,
)

__all__ = ["MeshAxes", "P", "PartitionSpec", "Placement", "audio_decoder_param_specs", "block_of",
           "gan_batch_specs", "gan_param_specs", "gather", "named", "opt_specs"]
