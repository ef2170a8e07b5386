"""Continuous-batching serving stack of the port."""
from .engine import Request, ServingEngine, settle_ticks
from .kv_pool import KVBlockPool, MixedKVPool, PoolConfig, PoolError
from .router import AFFINITY_SLACK_SLOTS, ReplicaRouter, prefix_key
from .sampling import SamplingParams, sample_tokens
from .scheduler import (RequestState, ScheduledRequest, Scheduler,
                        SchedulerConfig, TickPlan, serve_plan_graph)

__all__ = ["ServingEngine", "Request", "Scheduler", "SchedulerConfig",
           "RequestState", "ScheduledRequest", "TickPlan",
           "serve_plan_graph", "SamplingParams", "sample_tokens",
           "settle_ticks", "KVBlockPool", "MixedKVPool", "PoolConfig",
           "PoolError", "ReplicaRouter", "prefix_key",
           "AFFINITY_SLACK_SLOTS"]
