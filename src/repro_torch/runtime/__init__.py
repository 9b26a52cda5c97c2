"""repro_torch.runtime — training, serving, the engine, the scheduler, the
KV pool and the metrics (the port of ``repro.runtime``; the same names)."""

from repro_torch.runtime.train_loop import (init_opt_state, make_train_step,
                                            opt_state_specs, train_shardings,
                                            batch_specs)
from repro_torch.runtime.serve_loop import (PlanServer, ServeRequest,
                                            cache_shardings, greedy_decode,
                                            make_decode_step, make_prefill)
from repro_torch.runtime.engine import (Clock, RequestHandle, ServingEngine,
                                        TokenEvent, VirtualClock, WallClock)
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler,
                                           QueuedRequest, RequestQueue,
                                           simulate_arrivals)
from repro_torch.runtime.kv_cache import CacheArena, KVCachePool, PoolMetrics
from repro_torch.runtime.metrics import (LatencyStats, PlanCacheMetrics,
                                         SchedulerMetrics, StepTimer,
                                         format_metrics, pool_summary,
                                         scheduler_summary, serve_summary)

__all__ = ["make_train_step", "init_opt_state", "opt_state_specs",
           "train_shardings", "batch_specs", "make_decode_step",
           "make_prefill", "cache_shardings", "greedy_decode", "PlanServer",
           "ServeRequest", "ServingEngine", "RequestHandle", "TokenEvent",
           "Clock", "VirtualClock", "WallClock",
           "ContinuousBatchingScheduler", "RequestQueue",
           "QueuedRequest", "simulate_arrivals", "StepTimer",
           "format_metrics", "LatencyStats", "PlanCacheMetrics",
           "SchedulerMetrics", "scheduler_summary", "serve_summary",
           "KVCachePool", "CacheArena", "PoolMetrics", "pool_summary"]
