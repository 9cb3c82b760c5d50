"""Batched multi-instance sampling service (paper §V-C, lifted to requests).

The port of ``repro.serve``: the front door for serving many concurrent,
heterogeneous sampling requests — admission-controlled queueing,
padding-bucket batching keyed on lowered transition programs, fused
launches on the card, per-request results.  Two serving modes share the
cohort machinery: the batch :class:`SamplingService` (submit-then-drain,
in-memory or out-of-memory placement) and the always-on
:class:`StreamingSamplingService` (continuous batching under latency SLOs,
priority tiers, per-tenant quotas).  Every request's walks equal
``repro``'s under the same keys.
"""
from repro_torch.serve.queue import (
    AdmissionError,
    Cohort,
    RequestQueue,
    SamplingRequest,
    ServiceConfig,
    cohort_key,
)
from repro_torch.serve.service import (
    DrainError,
    RequestLatency,
    RequestResult,
    SamplingService,
    ServiceStats,
)
from repro_torch.serve.stream import (
    Priority,
    StreamConfig,
    StreamFuture,
    StreamingSamplingService,
    TenantQuota,
)

__all__ = [
    "AdmissionError",
    "DrainError",
    "Cohort",
    "Priority",
    "RequestLatency",
    "RequestQueue",
    "RequestResult",
    "SamplingRequest",
    "SamplingService",
    "ServiceConfig",
    "ServiceStats",
    "StreamConfig",
    "StreamFuture",
    "StreamingSamplingService",
    "TenantQuota",
    "cohort_key",
]
