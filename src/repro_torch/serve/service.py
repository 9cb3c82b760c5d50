"""Batched multi-instance sampling service.

C-SAW's out-of-memory design rests on batched multi-instance sampling —
packing many concurrent sampling instances into one device pass (paper
§V-C).  This module lifts that idea to *independent user requests*, as
``repro.serve.service``: a :class:`SamplingService` accepts many concurrent,
heterogeneous requests (seed sets, walk lengths, specs), fuses the
compatible ones into shared launches, and unpacks per-request results.

The pipeline per :meth:`SamplingService.drain`:

1. :class:`~repro_torch.serve.queue.RequestQueue` groups pending requests
   into padding-bucket **cohorts** keyed on the lowered transition program.
2. Each cohort's seed sets are packed into one ``(R, W)`` matrix (one row a
   request, ``-1``-padded to the width bucket) with the requests' stacked
   ``uint32[2]`` keys, and run through ``engine.random_walk_segments``: one
   batch whose row ``r`` equals the standalone ``random_walk(graph,
   padded_seeds_r, key_r, depth=bucket)`` bit for bit.
3. A service holding *partitioned* graph storage routes the cohort to the
   §V frontier-queue drain (``oom_random_walk``), and one holding a graph
   and a :class:`~repro_torch.shard.ShardMesh` with ``placement="sharded"``
   to the owner-routed mesh drain (``shard.sharded_random_walk``): all
   member requests merge into one flat instance axis with per-instance
   ``depth_limits``.
4. Results come to the host (``.cpu().numpy()``, which is also where the
   launch's device work ends) and are sliced per request: row padding off,
   depth bucket cut to the request's own walk length.

``ServiceConfig(fuse=False)`` (one launch per request, same padding)
returns bit-identical responses.

Against ``repro.serve.service``: ``backend=`` becomes ``device=`` (``cuda``
unless the caller passes ``"cpu"``; on the sharded placement the mesh's
first device), resolved once and passed to every engine call; there is no
``method=``, since ``repro``'s walk body never reads it and the port's
engines take none; ``mesh=`` takes a ``ShardMesh`` and there is no
``shard_axis=`` (the mesh has one axis).  Every request's walks, and the
service's stats, equal ``repro``'s under the same keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import transition as tp
from repro_torch.core.api import SamplingSpec
from repro_torch.core.engine import flat_method_plan, random_walk, random_walk_segments
from repro_torch.core.oom import oom_random_walk, prewarm_plans
from repro_torch.core.rng import PRNGKey, fold_in, key_from_array, split
from repro_torch.graph.csr import CSRGraph, resolve_device
from repro_torch.graph.partition import RangePartition
from repro_torch.kernels import _build
from repro_torch.shard.mesh import ShardMesh
from repro_torch.shard.walk import sharded_random_walk
from repro_torch.serve.queue import (
    AdmissionError,
    Cohort,
    RequestQueue,
    SamplingRequest,
    ServiceConfig,
    _pow2_bucket,
)


class DrainError(RuntimeError):
    """A cohort launch failed mid-drain.

    No request is lost: the failing cohort's and all not-yet-served
    requests are re-queued (same ids — ``drain()`` again to retry), and
    results of cohorts that completed before the failure are on
    ``completed``.
    """

    def __init__(self, message: str, completed: "Dict[int, RequestResult]"):
        super().__init__(message)
        self.completed = completed


class RequestResult(NamedTuple):
    """Per-request response: exactly the requested geometry, padding gone."""

    request_id: int
    walks: np.ndarray  # (n, depth+1) int32, -1 after termination
    lengths: np.ndarray  # (n,) realized lengths (# vertices)
    sampled_edges: int  # total edges this request sampled


class RequestLatency(NamedTuple):
    """One streamed request's life-cycle timing (``serve.stream``).

    ``queue_ms`` is submission → launch start, ``launch_ms`` the request's
    cohort launch wall time (results on the host), ``total_ms`` submission
    → result delivery.  ``deadline_met`` is ``None`` for requests submitted
    without a deadline.
    """

    request_id: int
    tier: int  # Priority value (lower = more urgent)
    queue_ms: float
    launch_ms: float
    total_ms: float
    reason: str  # what launched the cohort: fill / slack / window / flush / immediate
    deadline_met: Optional[bool]


@dataclasses.dataclass
class ServiceStats:
    """Serving counters since construction (the same fields as ``repro``'s)."""

    requests_served: int = 0
    walkers_served: int = 0
    launches: int = 0  # fused in-memory launches
    oom_launches: int = 0  # partition-scheduler passes
    sharded_launches: int = 0  # device-mesh frontier-exchange drains
    padded_walker_slots: int = 0  # launched slots minus real walkers
    plans_prewarmed: int = 0  # explicit prewarm() selection-plan builds
    #: placements prewarm() has warmed
    prewarmed_placements: tuple = ()
    # --- streaming (serve.stream) ---------------------------------------
    stream_requests: int = 0  # admitted through StreamingSamplingService
    stream_launches: int = 0  # cohort launches the scheduling loop issued
    stream_failed_requests: int = 0  # futures completed with an error
    stream_deadline_misses: int = 0  # deadline'd requests delivered late
    stream_quota_rejections: int = 0  # tenant token-bucket AdmissionErrors
    #: per-request RequestLatency entries, in delivery order
    stream_latencies: list = dataclasses.field(default_factory=list)


def _slice_result(req: SamplingRequest, walks: np.ndarray) -> RequestResult:
    """Cut one request's rows out of a launch: drop row padding, truncate the
    depth bucket to the request's own walk length, recompute the per-request
    summary the standalone engine would have reported."""
    w = walks[: req.num_walkers, : req.depth + 1]
    lengths = (w >= 0).sum(axis=1).astype(np.int32)
    sampled = int(np.maximum(lengths - 1, 0).sum())
    return RequestResult(req.request_id, w, lengths, sampled)


class SamplingService:
    """Fuses concurrent sampling requests into shared launches.

    Construct with EITHER an in-memory ``graph`` (requests run through the
    fused ``random_walk_segments`` path) OR host-resident ``partitions`` +
    ``total_vertices`` (requests run through the §V out-of-memory
    frontier-queue drain) OR a ``graph`` plus a ``mesh``
    (:class:`~repro_torch.shard.ShardMesh`) and ``placement="sharded"``
    (the graph is range-sharded over the mesh and cohorts run through the
    owner-routed drain, ``shard.sharded_random_walk``).  ``submit()`` admits a request (raising
    :class:`~repro_torch.serve.queue.AdmissionError` over capacity) and
    returns a request id; ``drain()`` serves everything pending and returns
    ``{request_id: RequestResult}``.

    On the in-memory path each request gets its own key (derived from the
    service key and the request id unless passed explicitly), so its result
    does not depend on which other requests share its launch.  OOM-routed
    and shard-routed cohorts merge all member requests into one flat
    instance axis under one launch-level key: results are deterministic for
    a fixed submission set but not composition-independent, and per-request
    ``key=`` values are unused there.

    Every launch runs on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``, the mesh's first device on the sharded placement; without a
    card ``cuda`` raises), resolved once here: a bare
    ``cuda`` is pinned to the current card, and each launch runs with that
    card current, so a launch from another thread (the streaming
    scheduler's) lands on the same card.
    """

    def __init__(
        self,
        graph: Optional[CSRGraph] = None,
        *,
        partitions: Optional[List[RangePartition]] = None,
        total_vertices: Optional[int] = None,
        max_degree: Optional[int] = None,
        device=None,
        config: Optional[ServiceConfig] = None,
        key=None,
        oom_memory_capacity: int = 2,
        oom_num_streams: int = 2,
        oom_chunk: int = 1024,
        mesh: Optional[ShardMesh] = None,
        placement: Optional[str] = None,
    ):
        if (graph is None) == (partitions is None):
            raise ValueError(
                "pass exactly one of graph= (in-memory / sharded) or "
                "partitions= (out-of-memory)"
            )
        if placement is None:
            placement = "oom" if partitions is not None else (
                "sharded" if mesh is not None else "memory"
            )
        if placement not in ("memory", "oom", "sharded"):
            raise ValueError(f"unknown placement {placement!r}")
        if placement == "sharded" and (graph is None or mesh is None):
            raise ValueError('placement="sharded" needs graph= and mesh=')
        if placement != "sharded" and mesh is not None:
            # a mesh the service would never use: the caller configured one
            # execution path and would get another
            raise ValueError(
                f'mesh= is only meaningful with placement="sharded", '
                f"got placement={placement!r}"
            )
        if placement == "sharded" and not isinstance(mesh, ShardMesh):
            raise TypeError(f"mesh= takes a ShardMesh, got {type(mesh).__name__}")
        if placement == "oom" and partitions is None:
            raise ValueError('placement="oom" needs partitions=')
        if placement == "memory" and graph is None:
            raise ValueError('placement="memory" needs graph=')
        if device is None:
            device = mesh.devices[0] if placement == "sharded" else "cuda"
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.placement = placement
        self.mesh = mesh
        self.graph = graph.to(dev) if graph is not None else None
        self.partitions = partitions
        if graph is not None:
            self.num_vertices = graph.num_vertices
            self.max_degree = int(max_degree or graph.max_degree())
        else:
            if total_vertices is None:
                raise ValueError("partitions= needs total_vertices=")
            self.num_vertices = int(total_vertices)
            if max_degree is None:
                max_degree = max(
                    (int(np.diff(p.indptr).max()) for p in partitions if p.num_vertices),
                    default=1,
                )
            self.max_degree = int(max_degree)
        self.config = config or ServiceConfig()
        self._queue = RequestQueue(self.config)
        base = key_from_array(key) if key is not None else PRNGKey(0)
        # disjoint streams: per-request keys fold request ids into _key,
        # OOM partition-scheduler passes fold launch counters into _oom_key
        self._key, self._oom_key = split(base)
        self._next_id = 0
        self._oom_launch = 0
        self._oom_kwargs = dict(
            memory_capacity=oom_memory_capacity,
            num_streams=oom_num_streams,
            chunk=oom_chunk,
        )
        self.stats = ServiceStats()

    def _on_device(self):
        """The service's card made current for one launch (a no-op on the
        CPU): torch's current device is per thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- intake ------------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, seeds, *, depth: int, spec: SamplingSpec, key=None) -> int:
        """Admit one request; returns its id (the ``drain()`` result key).

        ``seeds``: (n,) start vertices in ``[0, num_vertices)``; ``depth``:
        walk length in steps; ``spec``: the request's sampling algorithm;
        ``key``: the request's ``uint32[2]`` key (in-memory serving only —
        the OOM drain keys per launch, not per request).  Raises
        :class:`~repro_torch.serve.queue.AdmissionError` on malformed or
        over-capacity requests — here, not at drain time.
        """
        req = self._make_request(seeds, depth=depth, spec=spec, key=key)
        self._queue.submit(req)  # may raise — then the id is NOT consumed
        self._next_id += 1
        return req.request_id

    def _make_request(self, seeds, *, depth: int, spec: SamplingSpec,
                      key=None) -> SamplingRequest:
        """Validate seeds and build the next :class:`SamplingRequest` —
        shared by batch ``submit`` and the streaming front door, so both
        allocate ids and per-request keys from the same sequence.  Does NOT
        consume the id: callers bump ``_next_id`` only after their own
        admission checks pass."""
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy()
        seeds = np.asarray(seeds)
        if seeds.ndim == 1 and seeds.size and (
            seeds.min() < 0 or seeds.max() >= self.num_vertices
        ):
            raise AdmissionError(
                f"seeds outside [0, num_vertices={self.num_vertices}): "
                f"min={seeds.min()} max={seeds.max()}"
            )
        rid = self._next_id
        return SamplingRequest(
            request_id=rid,
            # always copy: the queue holds the array past this call, and a
            # caller mutating its buffer would bypass the range check above
            seeds=np.array(seeds, dtype=np.int32),
            depth=int(depth),
            spec=spec,
            key=key_from_array(key) if key is not None else fold_in(self._key, rid),
        )

    def prewarm(self, spec: SamplingSpec, *, depth: Optional[int] = None,
                width: Optional[int] = None, requests: int = 1) -> tuple:
        """Warm ``spec``'s serving path NOW, so no live request pays it.

        1. **Kernels**: on the card, build and load the CUDA kernels (they
           build at first use).
        2. **Selection plan** (flat-bias specs): on the memory placement the
           adaptive method plan and its alias / rejection tables, cached per
           (graph, bias fn) in ``core.methods``; on the OOM placement every
           partition's host plan and tables (``core.oom.prewarm_plans``), which
           the drain would otherwise build at each partition's first
           residency (seconds a partition at R-MAT scale 21).
           The sharded placement reuses the memory placement's full-graph
           plan, which the sharded drain slices per shard.
        3. **Warm launch** (every placement): when ``depth`` is given, one
           throwaway launch at the padded geometry a request of ``(width,
           depth)`` would occupy (``requests`` sizes the fused request
           axis), through the placement's engine.

        The warm launch uses a fixed throwaway key and moves neither the
        service's stats nor its request-id and launch-key sequences, so
        prewarming never changes what any later request samples.  Returns
        the memory or sharded placement's per-cohort method plan (empty when
        there is nothing to plan, and on the OOM placement, as ``repro``).
        """
        if self.device.type == "cuda":
            _build.load()
        program = tp.lower(spec)
        methods: tuple = ()
        with self._on_device():
            if self.placement == "oom":
                prewarm_plans(self.partitions, self.num_vertices, spec, device=self.device)
            elif program.mode == "flat":
                methods, _tables = flat_method_plan(self.graph, program, self.max_degree)
                self.stats.plans_prewarmed += 1
        if depth is not None:
            self._prewarm_launch(spec, depth=depth, width=width, requests=requests)
        if self.placement not in self.stats.prewarmed_placements:
            self.stats.prewarmed_placements += (self.placement,)
        return methods

    def _prewarm_launch(self, spec: SamplingSpec, *, depth: int, width: Optional[int],
                        requests: int) -> None:
        """One throwaway launch at the bucketed geometry, placement-routed.

        Seeds are vertex 0 plus ``-1`` padding (an all-padding launch would
        end before the OOM or sharded drain ever steps); the key is a
        constant, and no service stats or counters move.
        """
        cfg = self.config
        depth_b = _pow2_bucket(int(depth), cfg.min_depth_bucket)
        width_b = _pow2_bucket(int(width or 1), cfg.min_walker_bucket)
        key = PRNGKey(0)
        with self._on_device():
            if self.placement == "memory":
                r_pad = _pow2_bucket(max(int(requests), 1), 1)
                seeds = np.full((r_pad, width_b), -1, np.int32)
                seeds[:, 0] = 0
                keys = np.stack([key] * r_pad)
                random_walk_segments(
                    self.graph, seeds, keys, depth=depth_b, spec=spec,
                    max_degree=self.max_degree, device=self.device,
                ).walks.cpu()
                return
            # OOM / sharded: cohorts pack one flat instance axis
            # (128-multiple, mirroring _pack_flat) with per-instance depth
            # limits
            i_pad = _pow2_bucket(width_b * max(int(requests), 1), 128)
            seeds = np.full((i_pad,), -1, np.int32)
            seeds[0] = 0
            limits = np.zeros((i_pad,), np.int32)
            limits[0] = depth_b
            if self.placement == "oom":
                oom_random_walk(
                    self.partitions, self.num_vertices, seeds, key,
                    depth=depth_b, spec=spec, max_degree=self.max_degree,
                    depth_limits=limits, device=self.device, **self._oom_kwargs,
                )
            else:
                sharded_random_walk(
                    self.mesh, self.graph, seeds, key, depth=depth_b, spec=spec,
                    max_degree=self.max_degree, depth_limits=limits,
                ).walks.cpu()

    # -- serving -----------------------------------------------------------

    def drain(self) -> Dict[int, RequestResult]:
        """Serve every pending request; returns ``{request_id: result}``.

        If a cohort launch fails, its requests and every not-yet-served
        cohort's are re-queued and a :class:`DrainError` carrying the
        already-completed results is raised — no admitted request is ever
        silently dropped.
        """
        out: Dict[int, RequestResult] = {}
        cohorts = self._queue.take_cohorts(bucket_by_shape=self.placement == "memory")
        for i, cohort in enumerate(cohorts):
            try:
                self._run_cohort(cohort, out)
            except Exception as e:
                # _run_sequential may have partially filled `out` for this
                # cohort; don't serve those twice on retry
                for c in cohorts[i:]:
                    for req in c.requests:
                        if req.request_id not in out:
                            self._queue.submit(req)  # fits: was admitted before
                raise DrainError(
                    f"cohort launch failed ({type(e).__name__}: {e}); "
                    f"unserved requests re-queued, {len(out)} completed "
                    f"results on .completed",
                    out,
                ) from e
        return out

    def _run_cohort(self, cohort: Cohort, out: Dict[int, RequestResult]) -> None:
        """Launch one cohort through this service's placement (the single
        dispatch point ``drain()`` and the streaming scheduler share) and
        account it.  Returns with the results on the host.  On failure,
        ``out`` holds whatever the launch delivered before raising (only the
        sequential path delivers partially)."""
        with self._on_device():
            if self.placement == "oom":
                self._run_oom(cohort, out)
            elif self.placement == "sharded":
                self._run_sharded(cohort, out)
            elif self.config.fuse:
                self._run_fused(cohort, out)
            else:
                self._run_sequential(cohort, out)
        self.stats.requests_served += len(cohort.requests)
        self.stats.walkers_served += cohort.num_walkers

    def _pack(self, cohort: Cohort) -> tuple:
        """Pad cohort members into the launch geometry: ``(R_pad, W)`` seeds
        (rows beyond ``R`` are all--1 ghosts so the request axis is also
        bucketed) and ``(R_pad, 2)`` stacked key words."""
        reqs = cohort.requests
        r_pad = _pow2_bucket(len(reqs), 1)
        seeds = np.full((r_pad, cohort.width), -1, np.int32)
        for i, req in enumerate(reqs):
            seeds[i, : req.num_walkers] = req.seeds
        keys = np.stack([r.key for r in reqs] + [PRNGKey(0)] * (r_pad - len(reqs)))
        return seeds, keys, r_pad

    def _run_fused(self, cohort: Cohort, out: Dict[int, RequestResult]) -> None:
        seeds, keys, r_pad = self._pack(cohort)
        res = random_walk_segments(
            self.graph, seeds, keys, depth=cohort.depth,
            spec=cohort.requests[0].spec, max_degree=self.max_degree,
            device=self.device,
        )
        walks = res.walks.cpu().numpy()
        for i, req in enumerate(cohort.requests):
            out[req.request_id] = _slice_result(req, walks[i])
        self.stats.launches += 1
        self.stats.padded_walker_slots += r_pad * cohort.width - cohort.num_walkers

    def _run_sequential(self, cohort: Cohort, out: Dict[int, RequestResult]) -> None:
        """One launch per request, same padded geometry as the fused path —
        the bit-identical baseline."""
        for req in cohort.requests:
            row = np.full((cohort.width,), -1, np.int32)
            row[: req.num_walkers] = req.seeds
            res = random_walk(
                self.graph, row, req.key, depth=cohort.depth, spec=req.spec,
                max_degree=self.max_degree, device=self.device,
            )
            out[req.request_id] = _slice_result(req, res.walks.cpu().numpy())
            self.stats.launches += 1
            self.stats.padded_walker_slots += cohort.width - req.num_walkers

    def _pack_flat(self, cohort: Cohort) -> tuple:
        """Merge a cohort's requests into one flat instance axis: ``-1``-
        padded seeds and per-instance ``depth_limits`` (a power-of-two
        instance count, as ``repro``), plus ``(request, row offset)`` spans
        for unpacking and the launch-level key (one per
        partition-scheduling pass)."""
        total = cohort.num_walkers
        i_pad = _pow2_bucket(total, 128)
        seeds = np.full((i_pad,), -1, np.int32)
        limits = np.zeros((i_pad,), np.int32)
        spans = []
        at = 0
        for req in cohort.requests:
            n = req.num_walkers
            seeds[at : at + n] = req.seeds
            limits[at : at + n] = req.depth
            spans.append((req, at))
            at += n
        self._oom_launch += 1
        key = fold_in(self._oom_key, self._oom_launch)
        return seeds, limits, spans, key, i_pad - total

    @staticmethod
    def _unpack_flat(spans, walks: np.ndarray, out: Dict[int, RequestResult]) -> None:
        for req, at in spans:
            out[req.request_id] = _slice_result(req, walks[at : at + req.num_walkers])

    def _run_oom(self, cohort: Cohort, out: Dict[int, RequestResult]) -> None:
        """Route one cohort through the §V frontier-queue drain: member
        requests merge into one flat instance axis (per-instance
        ``depth_limits`` let mixed walk lengths share the partition
        schedule)."""
        seeds, limits, spans, key, ghost = self._pack_flat(cohort)
        walks, _stats = oom_random_walk(
            self.partitions, self.num_vertices, seeds, key,
            depth=cohort.depth, spec=cohort.requests[0].spec,
            max_degree=self.max_degree, depth_limits=limits,
            device=self.device, **self._oom_kwargs,
        )
        self._unpack_flat(spans, walks, out)
        self.stats.oom_launches += 1
        self.stats.padded_walker_slots += ghost

    def _run_sharded(self, cohort: Cohort, out: Dict[int, RequestResult]) -> None:
        """Route one cohort through the owner-routed mesh drain
        (``shard.sharded_random_walk``): the OOM path's flat-instance-axis
        packing and launch-key contract."""
        seeds, limits, spans, key, ghost = self._pack_flat(cohort)
        res = sharded_random_walk(
            self.mesh, self.graph, seeds, key,
            depth=cohort.depth, spec=cohort.requests[0].spec,
            max_degree=self.max_degree, depth_limits=limits,
        )
        self._unpack_flat(spans, res.walks.cpu().numpy(), out)
        self.stats.sharded_launches += 1
        self.stats.padded_walker_slots += ghost
