"""KV-cache-aware routing.

The port's own copy of dynamo_tpu/kv_router/ (the indexers, the cost-based
scheduler, KvRouter / KvPushRouter, the workers' publishers and the
recorder); its module docstrings name what each leaves out.

Role-equivalent of the reference's lib/llm/src/kv_router.rs + kv_router/*:
workers publish KV-cache events (block stored/removed, keyed by the token
hash chain of ``tokens.py``) and load metrics; the router keeps a global
radix tree over those events and picks the worker whose cached prefix
overlaps the request best, weighed against its predicted load.

Subjects mirror the reference (kv_router.rs:50-52): ``kv_events`` per
namespace, ``kv-hit-rate`` for routing-quality events, ``load_metrics`` for
worker ForwardPassMetrics.
"""

from dynamo_tpu_torch.kv_router.indexer import (
    ApproxKvIndexer,
    KvIndexer,
    OverlapScores,
    RadixTree,
    ShardedKvIndexer,
)
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvStats,
    RouterEvent,
    SpecDecodeStats,
    WorkerStats,
)
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    KvScheduler,
)

KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_SUBJECT = "kv-hit-rate"
KV_METRICS_ENDPOINT = "load_metrics"

__all__ = [
    "ApproxKvIndexer",
    "DefaultWorkerSelector",
    "ForwardPassMetrics",
    "KV_EVENT_SUBJECT",
    "KV_HIT_RATE_SUBJECT",
    "KV_METRICS_ENDPOINT",
    "KvCacheEvent",
    "KvIndexer",
    "KvPushRouter",
    "KvRouter",
    "KvRouterConfig",
    "KvScheduler",
    "KvStats",
    "OverlapScores",
    "RadixTree",
    "RouterEvent",
    "ShardedKvIndexer",
    "SpecDecodeStats",
    "WorkerStats",
]
