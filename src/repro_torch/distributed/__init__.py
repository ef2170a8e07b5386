"""Distributed serving of the port: concat tensor parallelism over
``torch.distributed`` (``tp``)."""
from .tp import (KV_HEAD_DIM, SERVING_AXIS, SERVING_TP_AXES, ServingMesh,
                 serving_cache_dims, serving_mesh_shards,
                 serving_param_specs, shard_params, validate_serving_tp)

__all__ = ["KV_HEAD_DIM", "SERVING_AXIS", "SERVING_TP_AXES", "ServingMesh",
           "serving_cache_dims", "serving_mesh_shards",
           "serving_param_specs", "shard_params", "validate_serving_tp"]
