"""Always-on streaming sampling service: continuous batching under SLOs.

The port of ``repro.serve.stream``.  The batch
:class:`~repro_torch.serve.SamplingService` is submit-then-drain: a closed
world where every request is present before the first launch.  A front end
serving continuous traffic lives on the *temporal* axis instead — requests
arrive at all times, each carries a latency budget, and the scheduler
decides **when** to launch a cohort, trading batching efficiency (wait, so
more requests share the launch) against latency (launch, so the oldest
request makes its deadline).  Cohort *formation* (grouping, padding
buckets, packing, placement routing) is the batch service's, reached
through ``SamplingService._run_cohort``, so a streamed request's walks are
bit-identical to the same request batch-served or launched standalone at
the padded geometry — streaming changes launch *timing*, never packing
*semantics*.

The scheduling policy:

- **Forming cohorts**: submitted requests join the forming cohort of their
  group key — the same ``(cohort_key, depth bucket, width bucket)`` the
  batch queue uses on the in-memory placement, program-only on the OOM and
  sharded placements — in strict arrival order (the ``take_cohorts`` FIFO
  contract).
- **Launch triggers**, per forming cohort: *fill* (the cohort reaches
  ``max_requests_per_launch``); *slack* (the most urgent member's remaining
  deadline slack approaches ``slack_factor ×`` the cohort key's measured
  launch cost — an EMA over observed launch wall times, each of which ends
  with the results on the host); *window* (a deadline-less request has
  waited ``max_batch_window_ms`` — the implied SLO).
- **Launch order**: among due cohorts, earliest effective deadline first
  (EDF); priority tiers break ties, then arrival order.  One launch at a
  time, re-evaluating between launches so late arrivals can join
  still-forming cohorts.
- **Admission**: the batch service's per-request and back-pressure checks
  (``serve.queue``) apply verbatim to the streaming backlog, extended with
  per-tenant token buckets (``TenantQuota``) — every rejection is an
  :class:`~repro_torch.serve.queue.AdmissionError` naming the violated
  limit and its value.
- **Delivery**: per-request :class:`StreamFuture`\\ s (blocking ``result()``
  or ``add_done_callback``), never a global drain.  A failed cohort launch
  fails exactly its members' futures (with a
  :class:`~repro_torch.serve.service.DrainError` carrying how much of the
  cohort completed); every other request is untouched.

Two execution modes share the scheduler: a background thread
(``start=True``) and synchronous polling (``start=False`` +
``poll()``/``flush()`` with an injectable ``clock``), which makes every
policy decision deterministic — and is why the same clock script drives
this service and ``repro``'s to the same launches.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.api import SamplingSpec
from repro_torch.serve.queue import (
    AdmissionError,
    Cohort,
    SamplingRequest,
    _pow2_bucket,
    check_capacity,
    cohort_key,
    validate_request,
)
from repro_torch.serve.service import (
    DrainError,
    RequestLatency,
    RequestResult,
    SamplingService,
)


class Priority(enum.IntEnum):
    """Request priority tiers — lower value preempts higher on deadline ties.

    Tiers order launches; they never change results (per-request RNG keys
    make a request's walks independent of when and with whom it launches).
    """

    INTERACTIVE = 0  # user-facing: short deadlines, launches first on ties
    STANDARD = 1  # the default tier
    BULK = 2  # corpus generation / backfill: yields ties to everyone


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant token bucket: sustained walkers/s with a burst allowance.

    A submit costs ``num_walkers`` tokens; the bucket refills continuously
    at ``walkers_per_s`` up to ``burst_walkers``.  Insufficient tokens
    raise :class:`AdmissionError` (named limit + value) and count in
    ``ServiceStats.stream_quota_rejections`` — quota is admission control,
    not silent deprioritization, so tenants see their back-pressure.
    """

    walkers_per_s: float
    burst_walkers: float


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Scheduling knobs of a :class:`StreamingSamplingService`.

    max_batch_window_ms: longest a deadline-less request waits for
    co-batching — the implied SLO.  Explicit ``deadline_ms`` overrides it
    per request (tighter OR looser: a bulk request with a loose deadline
    keeps accumulating cohort-mates past the window).
    slack_factor: launch a cohort when its most urgent member's remaining
    slack falls below ``slack_factor ×`` the estimated launch cost (the
    safety margin over EMA noise; 1.0 would aim to finish exactly at the
    deadline).
    launch_cost_prior_ms / launch_cost_alpha: initial estimate and EMA
    weight for per-cohort-key launch cost measurement.
    tenant_quotas: token buckets by tenant name; tenants without an entry
    (and requests without a tenant) are unmetered.
    batching: ``False`` launches every request immediately in its own
    cohort — the launch-per-request baseline; results
    are bit-identical either way.
    """

    max_batch_window_ms: float = 20.0
    slack_factor: float = 2.0
    launch_cost_prior_ms: float = 25.0
    launch_cost_alpha: float = 0.25
    default_priority: Priority = Priority.STANDARD
    tenant_quotas: Mapping[str, TenantQuota] = dataclasses.field(
        default_factory=dict
    )
    batching: bool = True


class StreamFuture:
    """One streamed request's pending result.

    ``result(timeout)`` blocks for the :class:`RequestResult` (raising the
    launch error if the cohort failed); ``add_done_callback`` runs the
    callback with this future from the scheduler thread (or inline when
    already done).  After completion, ``latency`` holds the request's
    :class:`RequestLatency` record (also appended to
    ``ServiceStats.stream_latencies``).
    """

    def __init__(self, request_id: int, tier: Priority):
        self.request_id = request_id
        self.tier = tier
        self.latency: Optional[RequestLatency] = None
        self._event = threading.Event()
        self._result: Optional[RequestResult] = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["StreamFuture"], None]] = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within {timeout}s"
            )
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within {timeout}s"
            )
        return self._exception

    def add_done_callback(self, fn: Callable[["StreamFuture"], None]) -> None:
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _finish(
        self,
        result: Optional[RequestResult],
        exception: Optional[BaseException],
        latency: Optional[RequestLatency],
    ) -> None:
        self._result = result
        self._exception = exception
        self.latency = latency
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


@dataclasses.dataclass
class _Pending:
    """A submitted streaming request while it waits in a forming cohort."""

    req: SamplingRequest
    future: StreamFuture
    priority: Priority
    deadline: Optional[float]  # absolute clock time, None = window-bound
    submitted_at: float
    seq: int

    @property
    def effective_deadline(self) -> float:
        # resolved against the service window at evaluation time instead?
        # no: the window is a config constant, bind it at submit (cheaper,
        # and a mid-flight config swap must not reorder admitted requests)
        return self._eff

    def bind_window(self, window_s: float) -> "_Pending":
        self._eff = (
            self.deadline if self.deadline is not None
            else self.submitted_at + window_s
        )
        return self


class _TokenBucket:
    """Continuous-refill token bucket (tokens = walkers)."""

    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.level = float(quota.burst_walkers)
        self.last = now

    def try_take(self, tokens: float, now: float) -> bool:
        q = self.quota
        self.level = min(
            float(q.burst_walkers), self.level + q.walkers_per_s * (now - self.last)
        )
        self.last = now
        if tokens > self.level + 1e-9:
            return False
        self.level -= tokens
        return True


class StreamingSamplingService:
    """Always-on front door over a :class:`SamplingService` (any placement).

    >>> svc = SamplingService(graph, device="cpu")          # doctest: +SKIP
    >>> stream = StreamingSamplingService(svc)              # doctest: +SKIP
    >>> fut = stream.submit([0, 1], depth=8, spec=alg.deepwalk(),
    ...                     deadline_ms=50,
    ...                     priority=Priority.INTERACTIVE)  # doctest: +SKIP
    >>> fut.result().walks.shape                            # doctest: +SKIP
    (2, 9)

    The wrapped service's cohort machinery does all packing and launching;
    this class only decides *when* each forming cohort launches (module
    docstring).  With ``start=True`` (default) a daemon
    scheduler thread runs the loop; with ``start=False`` the caller drives
    it via :meth:`poll` / :meth:`flush` against the injected ``clock`` —
    the deterministic mode the policy tests and the parity harness use.

    The streaming front door owns the wrapped service's request-id and
    launch-key sequences while active; interleaving direct batch
    ``submit``/``drain`` calls on the same service is safe (ids stay
    unique) but their requests are invisible to the streaming scheduler.
    """

    def __init__(
        self,
        service: SamplingService,
        config: Optional[StreamConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
    ):
        self._svc = service
        self.config = config or StreamConfig()
        self._clock = clock
        self._window_s = self.config.max_batch_window_ms / 1e3
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._launch_lock = threading.Lock()  # serializes device launches
        self._forming: Dict[tuple, List[_Pending]] = {}
        self._backlog_walkers = 0
        self._seq = 0
        self._cost_s: Dict[tuple, float] = {}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start the scheduler thread (idempotent)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="stream-scheduler", daemon=True
        )
        self._thread.start()

    def close(self, flush: bool = True) -> None:
        """Stop admitting, optionally serve the backlog, stop the thread.

        With ``flush`` (default) every pending request still completes —
        an admitted request is never dropped by shutdown.  Without it,
        pending futures fail with :class:`DrainError`.
        """
        with self._wake:
            if self._closed:
                return
            self._closed = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if flush:
            self.flush()
        else:
            with self._lock:
                orphans = [p for ms in self._forming.values() for p in ms]
                self._forming.clear()
                self._backlog_walkers = 0
            for p in orphans:
                p.future._finish(
                    None,
                    DrainError(
                        f"request {p.req.request_id} cancelled: streaming "
                        f"service closed with flush=False", {},
                    ),
                    None,
                )

    def __enter__(self) -> "StreamingSamplingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))

    # -- intake ------------------------------------------------------------

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(m) for m in self._forming.values())

    @property
    def stats(self):
        return self._svc.stats

    def prewarm(self, spec: SamplingSpec, **kwargs) -> tuple:
        """The wrapped service's :meth:`SamplingService.prewarm`, under the
        launch lock: the caches it fills (the plans and tables of
        ``core.methods``, ``core.oom`` and ``shard.walk``) are module state that launches
        from the scheduler thread read and fill too.  Call this, not the
        service's own, once :meth:`start` has run."""
        with self._launch_lock:
            return self._svc.prewarm(spec, **kwargs)

    def launch_cost_ms(self, spec: SamplingSpec, *, depth: int = 1,
                       width: int = 1) -> float:
        """Current launch-cost estimate for ``spec``'s cohort key at the
        bucketed geometry (the slack trigger's input) in milliseconds."""
        ck = self._cost_key(self._group_key(spec, depth, width))
        with self._lock:
            return self._cost_s.get(
                ck, self.config.launch_cost_prior_ms / 1e3
            ) * 1e3

    def submit(
        self,
        seeds,
        *,
        depth: int,
        spec: SamplingSpec,
        key=None,
        deadline_ms: Optional[float] = None,
        priority: Optional[Priority] = None,
        tenant: Optional[str] = None,
    ) -> StreamFuture:
        """Admit one request into its forming cohort; returns its future.

        ``deadline_ms`` is the latency budget from NOW (absolute-ized
        against the service clock); omitted, the batching window is the
        implied SLO.  ``priority`` orders launches on deadline ties.
        ``tenant`` meters the request against its configured
        :class:`TenantQuota`.  Raises
        :class:`~repro_torch.serve.queue.AdmissionError` (named limit + value)
        on malformed requests, backlog back-pressure, or quota exhaustion.
        """
        if priority is None:
            priority = self.config.default_priority
        with self._wake:
            if self._closed:
                raise AdmissionError("streaming service is closed")
            now = self._clock()
            req = self._svc._make_request(seeds, depth=depth, spec=spec, key=key)
            validate_request(req, self._svc.config)
            n_pending = sum(len(m) for m in self._forming.values())
            check_capacity(
                n_pending, self._backlog_walkers, req.num_walkers,
                self._svc.config,
            )
            self._check_quota(tenant, req.num_walkers, now)
            self._svc._next_id += 1  # all checks passed: consume the id
            gk = self._group_key(spec, req.depth, req.num_walkers)
            if not self.config.batching:
                gk = gk + (self._seq,)  # never co-batch: the baseline mode
            fut = StreamFuture(req.request_id, priority)
            pending = _Pending(
                req=req, future=fut, priority=priority,
                deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
                submitted_at=now, seq=self._seq,
            ).bind_window(self._window_s)
            self._seq += 1
            self._forming.setdefault(gk, []).append(pending)
            self._backlog_walkers += req.num_walkers
            self._svc.stats.stream_requests += 1
            self._wake.notify_all()
            return fut

    def _check_quota(self, tenant: Optional[str], walkers: int, now: float) -> None:
        quota = (
            self.config.tenant_quotas.get(tenant) if tenant is not None else None
        )
        if quota is None:
            return
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TokenBucket(quota, now)
        if not bucket.try_take(float(walkers), now):
            self._svc.stats.stream_quota_rejections += 1
            raise AdmissionError(
                f"tenant {tenant!r} over quota: request needs {walkers} "
                f"walkers, {bucket.level:.1f} available "
                f"(tenant_quotas[{tenant!r}].walkers_per_s="
                f"{quota.walkers_per_s}, burst_walkers={quota.burst_walkers})"
            )

    # -- cohort bookkeeping ------------------------------------------------

    def _group_key(self, spec: SamplingSpec, depth: int, width: int) -> tuple:
        """The forming-cohort key: identical grouping to
        ``RequestQueue.take_cohorts`` for this service's placement."""
        ck = cohort_key(spec)
        if self._svc.placement == "memory":
            cfg = self._svc.config
            return (
                ck,
                _pow2_bucket(depth, cfg.min_depth_bucket),
                _pow2_bucket(width, cfg.min_walker_bucket),
            )
        return (ck,)

    @staticmethod
    def _cost_key(group_key: tuple) -> tuple:
        # strip the batching=False uniquifier so the EMA still accumulates
        return group_key[:3] if len(group_key) > 3 else group_key

    def _evaluate(self, gk: tuple, members: List[_Pending], now: float):
        """(due, reason, launch_at, edf_sort_key) for one forming cohort.

        Per-member launch points: a deadline'd member must launch once its
        remaining slack shrinks to ``slack_factor ×`` the cohort key's
        measured launch cost (any later and the result lands past the
        deadline); a window-bound member launches when its batching window
        elapses (waiting is bounded by policy, not by a completion
        estimate).  The cohort launches at the earliest member's point.
        """
        cost = self._cost_s.get(
            self._cost_key(gk), self.config.launch_cost_prior_ms / 1e3
        )
        slack_lead = self.config.slack_factor * cost

        def launch_point(p: _Pending) -> float:
            if p.deadline is not None:
                return p.deadline - slack_lead
            return p.submitted_at + self._window_s

        urgent = min(members, key=launch_point)
        launch_at = launch_point(urgent)
        sort_key = (
            min(p.effective_deadline for p in members),
            min(p.priority for p in members),
            members[0].seq,
        )
        if not self.config.batching:
            return True, "immediate", launch_at, sort_key
        if len(members) >= self._svc.config.max_requests_per_launch:
            return True, "fill", launch_at, sort_key
        if now >= launch_at:
            reason = "slack" if urgent.deadline is not None else "window"
            return True, reason, launch_at, sort_key
        return False, "", launch_at, sort_key

    def _pick(self, now: float, due_only: bool = True):
        """Best launchable cohort under EDF (+priority, +FIFO), or None."""
        best = None
        for gk, members in self._forming.items():
            due, reason, _launch_at, sort_key = self._evaluate(gk, members, now)
            if due_only and not due:
                continue
            if best is None or sort_key < best[0]:
                best = (sort_key, gk, reason if due else "flush")
        return best

    def _next_launch_at(self, now: float) -> Optional[float]:
        ats = [
            self._evaluate(gk, members, now)[2]
            for gk, members in self._forming.items()
        ]
        return min(ats) if ats else None

    def _pop(self, gk: tuple, reason: str):
        """Remove a forming cohort and pack it at the batch path's geometry."""
        members = self._forming.pop(gk)
        self._backlog_walkers -= sum(p.req.num_walkers for p in members)
        reqs = tuple(p.req for p in members)
        if self._svc.placement == "memory":
            depth_b, width_b = gk[1], gk[2]
        else:
            cfg = self._svc.config
            depth_b = _pow2_bucket(max(r.depth for r in reqs), cfg.min_depth_bucket)
            width_b = max(r.num_walkers for r in reqs)
        cohort = Cohort(key=gk[0], requests=reqs, depth=depth_b, width=width_b)
        return cohort, members, reason

    # -- execution ---------------------------------------------------------

    def _execute(self, cohort: Cohort, members: List[_Pending], reason: str) -> None:
        """One cohort launch + per-request delivery and accounting."""
        out: Dict[int, RequestResult] = {}
        error: Optional[Exception] = None
        with self._launch_lock:
            t0 = self._clock()
            try:
                self._svc._run_cohort(cohort, out)
            except Exception as e:  # noqa: BLE001 - delivered via futures
                error = e
            t1 = self._clock()
        launch_ms = (t1 - t0) * 1e3
        stats = self._svc.stats
        deliveries = []
        with self._lock:
            stats.stream_launches += 1
            if error is None:
                ck = self._cost_key(
                    self._group_key(
                        cohort.requests[0].spec, cohort.depth, cohort.width
                    )
                )
                a = self.config.launch_cost_alpha
                old = self._cost_s.get(ck)
                measured = t1 - t0
                self._cost_s[ck] = (
                    measured if old is None else a * measured + (1 - a) * old
                )
            for p in members:
                rid = p.req.request_id
                result = out.get(rid)
                met = None
                if p.deadline is not None:
                    met = t1 <= p.deadline
                    if not met:
                        stats.stream_deadline_misses += 1
                lat = RequestLatency(
                    request_id=rid, tier=int(p.priority),
                    queue_ms=(t0 - p.submitted_at) * 1e3,
                    launch_ms=launch_ms,
                    total_ms=(t1 - p.submitted_at) * 1e3,
                    reason=reason, deadline_met=met,
                )
                stats.stream_latencies.append(lat)
                exc = None
                if result is None:
                    stats.stream_failed_requests += 1
                    exc = DrainError(
                        f"request {rid}: cohort launch failed "
                        f"({type(error).__name__ if error else 'missing result'}"
                        f": {error}); {len(out)}/{len(members)} cohort members "
                        f"completed before the failure",
                        dict(out),
                    )
                    exc.__cause__ = error
                deliveries.append((p.future, result, exc, lat))
        for fut, result, exc, lat in deliveries:
            fut._finish(result, exc, lat)

    def _launch_next(self, due_only: bool = True) -> bool:
        with self._lock:
            pick = self._pick(self._clock(), due_only=due_only)
            if pick is None:
                return False
            _, gk, reason = pick
            cohort, members, reason = self._pop(gk, reason)
        self._execute(cohort, members, reason)
        return True

    def poll(self) -> int:
        """Synchronously launch every currently-due cohort (EDF order);
        returns the number of launches.  The ``start=False`` driving mode —
        with an injected clock this makes the policy fully deterministic."""
        n = 0
        while self._launch_next(due_only=True):
            n += 1
        return n

    def flush(self) -> int:
        """Launch everything pending, due or not; returns launch count."""
        n = 0
        while self._launch_next(due_only=False):
            n += 1
        return n

    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._closed:
                    now = self._clock()
                    pick = self._pick(now, due_only=True)
                    if pick is not None:
                        break
                    nxt = self._next_launch_at(now)
                    if nxt is None:
                        self._wake.wait()
                    else:
                        # cap the sleep: launch-cost EMAs can move the due
                        # time earlier while we sleep
                        self._wake.wait(min(max(nxt - now, 1e-4), 0.05))
                if self._closed:
                    return  # close() flushes the backlog synchronously
                _, gk, reason = pick
                cohort, members, reason = self._pop(gk, reason)
            self._execute(cohort, members, reason)


def percentile(samples, q: float) -> float:
    """Latency percentile (``q`` in [0, 100]) over ``samples``; NaN on empty
    input."""
    if not len(samples):
        return float("nan")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))
