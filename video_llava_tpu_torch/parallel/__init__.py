"""Parallelism over torch.distributed: the ('data', 'model') mesh, the
JAX package's partition rules applied to the port's modules (tensor
parallel on 'model', FSDP on 'data'), the collectives with their
gradients, the multi-process helpers and the follower loop through which
rank 0 drives the other ranks in inference.

Counterpart of video_llava_tpu/parallel/. The JAX package is one
controller whose compiler (GSPMD) places the collectives; here every
rank is a process of its own that holds its shard of each parameter and
runs the same program on it, with the collectives written out where a
spec shards a dimension (Megatron-style): a sum after a row-sharded
linear, a gather after a column-sharded one whose output must be whole,
an FSDP leaf gathered at use. Training (train/train.py) runs SPMD: each
rank its own loop on the batch rows of its 'data' coordinate.
"""

from video_llava_tpu_torch.parallel.mesh import make_mesh
from video_llava_tpu_torch.parallel.sharding import (
    batch_spec,
    cache_spec,
    constrain_kv_cache,
    shard_params,
    videollava_param_specs,
)
