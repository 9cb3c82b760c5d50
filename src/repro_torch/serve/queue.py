"""Request queue: admission control and padding-bucket batching.

The service's front door, as ``repro.serve.queue``.  Independent user
requests — each its own seed set, walk length and
:class:`~repro_torch.core.api.SamplingSpec` — are admitted against capacity
limits and grouped into **cohorts**: sets of requests that one fused launch
can serve.  Two requests share a cohort iff

1. their specs lower to the same transition program (:func:`cohort_key`),
2. their walk lengths round up to the same depth bucket, and
3. their walker counts round up to the same width bucket,

so the packed seed matrix has one shape per (program, depth bucket, width
bucket) triple.  Padding buckets are powers of two: a request is never
padded past 2x its true size in either axis.  The port has no trace to
reuse, but the buckets stay: they fix each request's padded geometry, and
with it the walks, which must equal ``repro``'s bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import transition as tp
from repro_torch.core.api import SamplingSpec


class AdmissionError(RuntimeError):
    """A request the queue refuses: malformed, oversized, or over capacity.

    Every limit-violation message names the violated limit and its
    configured value (``max_depth=512``, ``tenant_quota[t].walkers_per_s=...``)
    so callers can tell back-pressure (drain/retry) from misconfiguration
    (resize the limit) without string-guessing.
    """


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Capacity limits and batching knobs of a :class:`~repro_torch.serve.SamplingService`.

    max_pending_requests / max_pending_walkers: admission-control ceilings —
    ``submit`` raises :class:`AdmissionError` past either.
    max_walkers_per_request / max_depth: per-request size ceilings.
    min_walker_bucket / min_depth_bucket: smallest padding buckets.
    max_requests_per_launch: cap on the fused request axis ``R`` — larger
    cohorts split into several launches.
    fuse: ``False`` serves each request in its own launch (the baseline).
    Results are bit-identical either way — fusing is a pure batching
    transform (``engine.random_walk_segments``).
    """

    max_pending_requests: int = 256
    max_pending_walkers: int = 1 << 18
    max_walkers_per_request: int = 1 << 14
    max_depth: int = 512
    min_walker_bucket: int = 16
    min_depth_bucket: int = 4
    max_requests_per_launch: int = 64
    fuse: bool = True


def _pow2_bucket(n: int, lo: int) -> int:
    """Smallest power of two >= max(n, lo)."""
    return max(lo, 1 << max(n - 1, 0).bit_length())


def cohort_key(spec: SamplingSpec) -> tuple:
    """The fusion key: requests with equal keys may share one launch.

    The lowered transition program (``core.transition.lower``) captures the
    full step semantics of flat- and window-bias specs with declarative
    epilogues, so program equality alone suffices there (the factories'
    flat biases are module-level functions, so two ``deepwalk()`` calls
    fuse; node2vec closes its hook per call, so two ``node2vec()`` calls do
    not).  Opaque parts say nothing about their hooks, so the raw callables
    join the key for them.
    """
    program = tp.lower(spec)
    extras: list = []
    if program.mode == "opaque":
        extras += [spec.edge_bias, spec.needs_prev_neighbors]
    if isinstance(program.epilogue, tp.OpaqueEpilogue):
        extras.append(spec.update)
    return (program, tuple(extras))


@dataclasses.dataclass(frozen=True)
class SamplingRequest:
    """One admitted user request, as the queue holds it."""

    request_id: int
    seeds: np.ndarray  # (n,) int32 host array, validated in [0, V)
    depth: int  # requested walk length (steps)
    spec: SamplingSpec
    key: np.ndarray  # uint32[2] per-request key (core.rng) — isolates its stream

    @property
    def num_walkers(self) -> int:
        return int(self.seeds.shape[0])


@dataclasses.dataclass(frozen=True)
class Cohort:
    """Requests one fused launch serves, plus the launch's padded geometry."""

    key: tuple
    requests: Tuple[SamplingRequest, ...]
    depth: int  # depth bucket: max over members, rounded up to a power of 2
    width: int  # walker bucket: per-request padded row width

    @property
    def num_walkers(self) -> int:
        return sum(r.num_walkers for r in self.requests)


def validate_request(request: SamplingRequest, config: ServiceConfig) -> None:
    """Per-request admission checks (shape + size ceilings) or raise
    :class:`AdmissionError`.  Shared by the batch queue and the streaming
    front door, so both admit exactly the same requests."""
    n = request.num_walkers
    if request.seeds.ndim != 1 or n == 0:
        raise AdmissionError(
            f"request {request.request_id}: seeds must be a non-empty "
            f"1-D array, got shape {request.seeds.shape}"
        )
    if n > config.max_walkers_per_request:
        raise AdmissionError(
            f"request {request.request_id}: {n} walkers > "
            f"max_walkers_per_request={config.max_walkers_per_request}"
        )
    if not 1 <= request.depth <= config.max_depth:
        raise AdmissionError(
            f"request {request.request_id}: depth {request.depth} outside "
            f"[1, max_depth={config.max_depth}]"
        )


def check_capacity(
    pending_requests: int, pending_walkers: int, incoming_walkers: int,
    config: ServiceConfig,
) -> None:
    """Back-pressure ceilings over a pending population, or raise
    :class:`AdmissionError`.  Shared by the batch queue and the streaming
    backlog."""
    if pending_requests >= config.max_pending_requests:
        raise AdmissionError(
            f"queue full: {pending_requests} pending requests "
            f"(max_pending_requests={config.max_pending_requests}); drain first"
        )
    if pending_walkers + incoming_walkers > config.max_pending_walkers:
        raise AdmissionError(
            f"queue full: {pending_walkers}+{incoming_walkers} walkers > "
            f"max_pending_walkers={config.max_pending_walkers}; drain first"
        )


class RequestQueue:
    """Admission control + cohort formation over pending requests."""

    def __init__(self, config: ServiceConfig):
        self.config = config
        self._pending: List[SamplingRequest] = []
        self._pending_walkers = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_walkers(self) -> int:
        return self._pending_walkers

    def submit(self, request: SamplingRequest) -> None:
        """Admit ``request`` or raise :class:`AdmissionError` (shape and
        size checks, then the two pending-total ceilings: the service's
        back-pressure signal)."""
        validate_request(request, self.config)
        check_capacity(
            len(self._pending), self._pending_walkers,
            request.num_walkers, self.config,
        )
        self._pending.append(request)
        self._pending_walkers += request.num_walkers

    def take_cohorts(self, bucket_by_shape: bool = True) -> List[Cohort]:
        """Group and remove all pending requests into padded cohorts.

        With ``bucket_by_shape`` (the in-memory fused path), requests are
        bucketed by ``(cohort_key(spec), depth bucket, width bucket)``.
        Without it (the out-of-memory path, where per-instance
        ``depth_limits`` absorb mixed walk lengths and requests concatenate
        along one flat instance axis), only the transition program keys the
        grouping.  Each group splits into cohorts of at most
        ``max_requests_per_launch`` members.

        **Ordering contract** (deterministic, FIFO-fair): within a cohort
        key, members appear in submission order, so a request's row in the
        packed launch — and its flat instance index on the OOM path — is
        fixed by the submission history alone.  Across keys, cohorts come in
        order of each group's earliest member submission, and a group's
        cohorts (when it splits) stay in member order.  Two queues fed the
        same submissions produce identical cohort lists.
        """
        cfg = self.config
        groups: Dict[tuple, List[SamplingRequest]] = {}
        for req in self._pending:
            ck = cohort_key(req.spec)
            gk: tuple = (ck,)
            if bucket_by_shape:
                gk = (
                    ck,
                    _pow2_bucket(req.depth, cfg.min_depth_bucket),
                    _pow2_bucket(req.num_walkers, cfg.min_walker_bucket),
                )
            groups.setdefault(gk, []).append(req)
        self._pending = []
        self._pending_walkers = 0

        cohorts = []
        for gk, reqs in groups.items():
            for at in range(0, len(reqs), cfg.max_requests_per_launch):
                members = tuple(reqs[at : at + cfg.max_requests_per_launch])
                if bucket_by_shape:
                    _, depth_b, width_b = gk
                else:
                    depth_b = _pow2_bucket(
                        max(r.depth for r in members), cfg.min_depth_bucket
                    )
                    width_b = max(r.num_walkers for r in members)
                cohorts.append(
                    Cohort(key=gk[0], requests=members, depth=depth_b, width=width_b)
                )
        return cohorts
