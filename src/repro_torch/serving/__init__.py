"""Continuous-batching serving stack of the port."""
from .engine import Request, ServingEngine, settle_ticks
from .kv_pool import KVBlockPool, PoolConfig, PoolError
from .sampling import SamplingParams, sample_tokens
from .scheduler import (RequestState, ScheduledRequest, Scheduler,
                        SchedulerConfig, TickPlan, serve_plan_graph)

__all__ = ["ServingEngine", "Request", "Scheduler", "SchedulerConfig",
           "RequestState", "ScheduledRequest", "TickPlan",
           "serve_plan_graph", "SamplingParams", "sample_tokens",
           "settle_ticks", "KVBlockPool", "PoolConfig", "PoolError"]
