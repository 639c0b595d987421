"""Mesh and sharding utilities for multi-device gangs (counterpart of
``kubeshare_tpu/parallel/``): meshes and the sharded train step
(:mod:`.mesh`), the gang runner (:mod:`.runner`), ring and Ulysses
sequence parallelism (:mod:`.ringattention`, :mod:`.ulysses`), the
pipeline (:mod:`.pipeline`), over the differentiable collectives of
:mod:`.collectives`."""

from .mesh import (
    data_sharding,
    make_hybrid_mesh,
    make_mesh,
    make_sharded_train_step,
    param_sharding,
    replicated,
    shard_init,
    token_sharding,
)
from .pipeline import (make_pipeline, microbatch, pipeline_shard,
                       stage_sharding)
from .ringattention import make_ring_attention, ring_attention_shard
from .ulysses import make_ulysses_attention, ulysses_attention_shard

__all__ = [
    "data_sharding",
    "make_hybrid_mesh",
    "make_mesh",
    "make_pipeline",
    "make_ring_attention",
    "make_ulysses_attention",
    "make_sharded_train_step",
    "microbatch",
    "param_sharding",
    "pipeline_shard",
    "replicated",
    "ring_attention_shard",
    "ulysses_attention_shard",
    "shard_init",
    "stage_sharding",
    "token_sharding",
]
