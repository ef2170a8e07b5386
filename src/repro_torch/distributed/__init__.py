"""Distributed paths of the port: concat tensor parallelism over
``torch.distributed`` (``tp``) and d-Xenos's parameter-synchronization
schedules (``collectives``)."""
from .collectives import ps_sync, ring_allreduce
from .tp import (KV_HEAD_DIM, SERVING_AXIS, SERVING_TP_AXES, ServingMesh,
                 serving_cache_dims, serving_mesh_shards,
                 serving_param_specs, shard_params, validate_serving_tp)

__all__ = ["KV_HEAD_DIM", "SERVING_AXIS", "SERVING_TP_AXES", "ServingMesh",
           "ps_sync", "ring_allreduce", "serving_cache_dims",
           "serving_mesh_shards", "serving_param_specs", "shard_params",
           "validate_serving_tp"]
