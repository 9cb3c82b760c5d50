"""Out-of-memory sampling: workload-aware partition scheduling (paper §V).

The scheduler of ``repro.core.oom``, on the card.  The graph lives on the
host in contiguous vertex-range partitions, and at most ``memory_capacity``
of them are resident on the device at a time:

  1. count the active frontier entries of each partition (Fig. 8 step 1);
  2. ship the partitions with the most work first (step 2), through a
     double-buffered :class:`TransferEngine`: while one partition drains,
     the next scheduled one is copied from pinned host memory on a side
     CUDA stream;
  3. sample a resident partition until its queue drains, pushing each
     successor into its owning partition's queue;
  4. repeat until no partition has active entries (step 3).

The frontier is device-resident (``core.frontier``): one fixed-capacity
queue per partition.  A drain call (:func:`_drain`) runs ``n_chunks``
chunks, each a pop, one walk step for every popped entry through the
in-memory engine's transitions over the partition's local CSR
(``engine.walk_flat_transition``, ``walk_window_transition``,
``walk_gather_transition``), a scatter into the walks and one push of the
survivors.  No chunk reads anything back to the host; the host reads the
call's counters once after it, as the reference does.

Batched multi-instance sampling (§V-C) merges every instance's entries into
one queue per partition; ``batched=False`` pops one instance's entries per
chunk (the Fig. 13 baseline).  Workload balancing (§V-B) gives co-resident
partitions entry budgets in proportion to their queues, and the entries of
each chunk are recorded for the Fig. 14 imbalance metric.

Counted RNG as the reference: drain call ``c`` (from 1) runs under
``fold_in(key, c)`` and its chunk ``t`` under ``fold_in(·, t)``, whether
or not an earlier chunk had work; a popped walker draws at its slot in the
chunk, and every transition sees depth 0.  Walks and :class:`OOMStats` equal
``repro.core.oom.oom_random_walk(..., backend="reference")``'s bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backend as bk
from repro_torch.core import frontier
from repro_torch.core import methods as mt
from repro_torch.core import select as sel
from repro_torch.core import transition as tp
from repro_torch.core.api import SamplingSpec
from repro_torch.core.engine import (
    walk_flat_transition,
    walk_gather_transition,
    walk_window_transition,
)
from repro_torch.core.rng import fold_in, key_from_array
from repro_torch.graph.csr import resolve_device
from repro_torch.graph.partition import (
    DevicePartition,
    PartitionMap,
    RangePartition,
    device_partition,
    pid_of_device,
)

#: the widest chunk a drain pops: queues rarely hold a full ``chunk`` of
#: entries per partition, so narrower, denser steps serve the same budget
POP_WIDTH = 256


@dataclasses.dataclass
class OOMStats:
    """Counters of the paper's out-of-memory evaluation."""

    partition_transfers: int = 0
    bytes_transferred: int = 0
    kernel_launches: int = 0
    entries_per_kernel: Optional[List[int]] = None
    sampled_edges: int = 0
    frontier_dropped: int = 0

    def __post_init__(self):
        if self.entries_per_kernel is None:
            self.entries_per_kernel = []

    def kernel_time_std(self) -> float:
        """Std of the per-chunk workload (entry counts): the Fig. 14 proxy."""
        if not self.entries_per_kernel:
            return 0.0
        return float(np.std(np.asarray(self.entries_per_kernel, dtype=np.float64)))


class ResidentPartition(NamedTuple):
    """A partition on the device, with what its walks read beside the CSR."""

    dev: DevicePartition
    flat_bias: Optional[torch.Tensor]  # (E_P,) CSR-order bias, flat mode only
    tables: mt.MethodTables = mt.EMPTY_TABLES  # the plan's tables, local layout
    ready: Optional[torch.cuda.Event] = None  # its transfer's end, on the card


class TransferEngine:
    """Double-buffered host-to-device partition transfers with an LRU of
    ``capacity`` resident partitions (the paper's "device memory holds k
    partitions" constraint, Fig. 8)."""

    def __init__(self, partitions: List[RangePartition],
                 materialize: Callable[[RangePartition], ResidentPartition], capacity: int):
        self.partitions = partitions
        self.capacity = max(1, capacity)
        self._materialize = materialize
        self._resident: dict[int, ResidentPartition] = {}
        self._lru: list[int] = []
        self.stats_transfers = 0
        self.stats_bytes = 0

    def fetch(self, pid: int) -> ResidentPartition:
        """Partition ``pid`` on the device, transferred if it is not
        resident; the current stream waits for its transfer."""
        res = self._get(pid)
        if res.ready is not None:
            torch.cuda.current_stream().wait_event(res.ready)
        return res

    def _get(self, pid: int) -> ResidentPartition:
        if pid in self._resident:
            self._lru.remove(pid)
            self._lru.append(pid)
            return self._resident[pid]
        if len(self._resident) >= self.capacity:
            del self._resident[self._lru.pop(0)]
        res = self._materialize(self.partitions[pid])
        self.stats_transfers += 1
        # what ships: the padded local CSR and the aligned global ids
        self.stats_bytes += res.dev.nbytes
        self._resident[pid] = res
        self._lru.append(pid)
        return res

    def prefetch(self, pid: int) -> None:
        """Start the next scheduled partition's transfer while the current
        one drains (the copy runs on a side stream); a no-op when the
        capacity cannot hold both."""
        if self.capacity < 2 or pid in self._resident:
            return
        self._get(pid)
        # keep the draining partition most recent, so back-to-back
        # prefetches never evict it
        if len(self._lru) >= 2:
            self._lru[-1], self._lru[-2] = self._lru[-2], self._lru[-1]


def _plan(counts: torch.Tensor, *, workload_aware: bool, balance: bool, num_streams: int,
          chunk: int):
    """The scheduling decisions from the frontier counts ``(P,)``:
    ``(order, budgets)``, the partition visit order (most loaded first
    under workload-aware scheduling, ties to the lower id; fixed
    round-robin otherwise) and each visited partition's entry budget (in
    proportion to its queue under balancing, at least ``chunk``), zero for
    partitions outside this round's ``num_streams`` active set.  f32 and
    int32 arithmetic, as the reference's."""
    num_parts = counts.shape[0]
    counts = counts.to(torch.int32)
    if workload_aware:
        order = torch.argsort(-counts, stable=True)
    else:
        order = torch.arange(num_parts, device=counts.device)
    oc = counts[order]
    act = oc > 0
    rank = torch.cumsum(act.to(torch.int32), 0) - 1
    is_active = act & (rank < num_streams)
    total_active = torch.where(is_active, oc, 0).sum(dtype=torch.int32)
    if balance:
        frac = oc.to(torch.float32) / torch.clamp(total_active, min=1).to(torch.float32)
        budgets = torch.clamp(torch.ceil(frac * (num_streams * chunk)).to(torch.int32), min=chunk)
    else:
        budgets = torch.full((num_parts,), chunk * num_streams, dtype=torch.int32,
                             device=counts.device)
    return order, torch.where(is_active, budgets, 0)


def _drain(part: ResidentPartition, queues: frontier.FrontierQueues, walks: torch.Tensor,
           limits: torch.Tensor, key: np.ndarray, pid: int, budget: int, *,
           spec: SamplingSpec, program: tp.TransitionProgram, max_degree: int,
           flat_max_degree: int, chunk: int, n_chunks: int, batched: bool, buckets: tuple,
           use_chunked: bool, range_size: int, methods: tuple):
    """Drain up to ``budget`` entries of queue ``pid``: ``n_chunks`` chunks,
    each a pop, one walk step for its entries, a scatter of the steps into
    ``walks`` and one push of the survivors to their owners' queues.

    ``walks`` is the flat ``(I·(depth+1) + 1,)`` buffer whose last element
    takes the writes of dead entries; ``limits`` the per-instance walk
    lengths ``(I,)``.  A chunk with nothing to pop (a drained queue, a
    spent budget) pops nothing and changes nothing, as the reference's
    skipped chunk, so every chunk runs and none reads the device back.
    ``queues`` and ``walks`` are updated in place.  Returns the device
    tensors ``(sampled, entries (n_chunks,), remaining)``.
    """
    dev = part.dev
    num_parts = queues.num_partitions
    num_inst = limits.shape[0]
    cols = (walks.shape[0] - 1) // max(num_inst, 1)
    mode = program.mode
    zero = torch.zeros((), dtype=torch.int32, device=walks.device)
    sampled, left = zero, torch.full((), budget, dtype=torch.int32, device=walks.device)
    entries = []
    for t in range(n_chunks):
        (v, inst, d, prev), taken, _ = frontier.pop_chunk(
            queues, pid, chunk, limit=left, match_head_instance=not batched)
        safe_inst = torch.clamp(inst, min=0).long()
        # teleport-to-home epilogues read the walk's seed off column 0
        home = walks[safe_inst * cols] if program.carries_home else None
        kstep = fold_in(key, t)
        if mode == "flat":
            nxt = walk_flat_transition(
                kstep, dev.graph, dev.indices_global, part.flat_bias, v, prev, 0, spec, program,
                buckets=buckets, use_chunked=use_chunked, methods=methods, tables=part.tables,
                row_of=dev.localize, home=home,
            )
        elif mode == "window":
            nxt = walk_window_transition(
                kstep, dev.graph, dev.indices_global, v, prev, 0, spec, program,
                buckets=buckets, use_chunked=use_chunked, max_degree=flat_max_degree,
                row_of=dev.localize, home=home,
            )
        else:
            nxt = walk_gather_transition(kstep, dev.graph, v, prev, 0, spec, program,
                                         max_degree=max_degree, home=home, partition=dev)
        ok = (nxt >= 0) & (inst >= 0)
        walks.scatter_(0, torch.where(ok, safe_inst * cols + d.long() + 1, num_inst * cols), nxt)
        sampled = sampled + ok.sum(dtype=torch.int32)
        cont = ok & (d + 1 < limits[safe_inst])
        npid = pid_of_device(nxt, range_size, num_parts)
        frontier.push_many(queues, npid, nxt, inst, d + 1, v, cont)
        left = left - taken
        entries.append(taken)
    return sampled, torch.stack(entries), queues.count[pid]


def oom_random_walk(
    partitions: List[RangePartition],
    total_vertices: int,
    seeds,
    key,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
    memory_capacity: int = 2,
    num_streams: int = 2,
    chunk: int = 1024,
    batched: bool = True,
    workload_aware: bool = True,
    balance: bool = True,
    depth_limits: Optional[np.ndarray] = None,
    queue_capacity: Optional[int] = None,
    strict: bool = False,
    device="cuda",
) -> tuple[np.ndarray, OOMStats]:
    """Out-of-memory random walk over host-resident partitions.

    Returns ``(walks (I, depth+1) numpy, stats)``.  The flags are the
    paper's ablations: ``batched`` (§V-C), ``workload_aware`` (§V-B
    scheduling), ``balance`` (proportional entry budgets) and
    ``num_streams`` (partitions served per round).  ``depth_limits``
    (``(I,)``, values in ``[0, depth]``) stops each instance at its own
    length; seeds may be -1 (padding: all--1 rows).  ``queue_capacity``
    overrides the per-partition queue capacity (by default every instance
    fits, so nothing is dropped); dropped entries are counted in
    ``stats.frontier_dropped``, and ``strict=True`` raises instead.

    Flat programs plan one selection method per degree cohort over all
    partitions at once (a host pre-pass over the partition-local biases),
    from the true maximum degree, and build each partition's tables once
    (memoized by pid).  Runs on ``device`` — ``cuda`` unless the caller
    passes ``"cpu"``.
    """
    dev = resolve_device(device)
    key = key_from_array(key)
    num_parts = len(partitions)
    seeds_np = np.asarray(seeds)
    num_inst = len(seeds_np)
    pm = PartitionMap.create(total_vertices, num_parts)
    program = tp.lower(spec)
    mode = program.mode
    flat_md, buckets, use_chunked = _bucket_plan(partitions, mode)

    seeds32 = torch.as_tensor(seeds_np.astype(np.int32)).to(dev)
    cols = depth + 1
    walks = torch.full((num_inst * cols + 1,), -1, dtype=torch.int32, device=dev)
    walks[:-1].view(num_inst, cols)[:, 0] = seeds32
    stats = OOMStats()
    if depth < 1 or num_inst == 0:
        return walks[:-1].view(num_inst, cols).cpu().numpy(), stats
    if depth_limits is None:
        limits = torch.full((num_inst,), depth, dtype=torch.int32, device=dev)
    else:
        limits_np = np.asarray(depth_limits, dtype=np.int32)
        if limits_np.shape != (num_inst,):
            raise ValueError(
                f"depth_limits shape {limits_np.shape} != (num_instances,) = ({num_inst},)")
        if limits_np.size and (limits_np.min() < 0 or limits_np.max() > depth):
            raise ValueError(f"depth_limits must lie in [0, depth={depth}], got "
                             f"[{limits_np.min()}, {limits_np.max()}]")
        limits = torch.from_numpy(limits_np).to(dev)

    cap = (int(queue_capacity) if queue_capacity is not None
           else -(-max(chunk, num_inst) // 128) * 128)
    if cap < 1:
        raise ValueError(f"queue_capacity must be >= 1, got {cap}")
    queues = frontier.make_queues(num_parts, cap, device=dev)
    frontier.push_many(
        queues, pm.pid_of_device(torch.clamp(seeds32, min=0)), seeds32,
        torch.arange(num_inst, dtype=torch.int32, device=dev),
        torch.zeros(num_inst, dtype=torch.int32, device=dev),
        torch.full((num_inst,), -1, dtype=torch.int32, device=dev),
        (seeds32 >= 0) & (limits > 0),
    )

    pad_v, pad_e = _padded_shape(partitions, total_vertices)
    methods = _plan_methods(partitions, program, buckets, use_chunked, pad_v, pad_e, dev)
    n_cohorts = len(buckets) + (1 if use_chunked else 0)
    run_methods = methods or ("its",) * n_cohorts
    tables_memo: dict[int, mt.MethodTables] = {}
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def derived(part: RangePartition, dpart: DevicePartition):
        """The flat bias and the plan's tables of a partition on the device
        (the tables built once a call, from the host cache)."""
        if mode != "flat":
            return None, mt.EMPTY_TABLES
        tables = mt.EMPTY_TABLES
        if methods:
            tables = tables_memo.get(part.pid)
            if tables is None:
                plan = _partition_plan(part, program, pad_v, pad_e, dev)
                tables = mt.MethodTables(*(None if t is None else _to_device(t, dev)
                                           for t in plan.tables(methods)))
                tables_memo[part.pid] = tables
        return program.bias.fn(dpart.graph), tables

    def materialize(part: RangePartition) -> ResidentPartition:
        arrays = part.local_arrays(pad_v, pad_e)
        if side is None:
            dpart = device_partition(*(torch.from_numpy(a) for a in arrays),
                                     part.vertex_lo, part.vertex_hi)
            return ResidentPartition(dpart, *derived(part, dpart))
        # staged in pinned memory and copied on the side stream, so the copy
        # overlaps the drain queued before it; the bias and tables follow on
        # the same stream.  Every tensor made there is marked as used by the
        # compute stream, so the caching allocator keeps it until the
        # compute stream's work on it is done.
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            dpart = device_partition(*(_to_device(a, dev) for a in arrays),
                                     part.vertex_lo, part.vertex_hi)
            fb, tables = derived(part, dpart)
            ready = torch.cuda.Event()
            ready.record(side)
        for t in (dpart.graph.indptr, dpart.graph.indices, dpart.graph.weights,
                  dpart.indices_global, fb, *tables):
            if t is not None:
                t.record_stream(compute)
        return ResidentPartition(dpart, fb, tables, ready)

    engine = TransferEngine(partitions, materialize, memory_capacity)
    width = min(chunk, POP_WIDTH)
    drain_kw = dict(
        spec=spec, program=program, max_degree=max_degree, flat_max_degree=flat_md,
        chunk=width, n_chunks=-(-num_streams * chunk // width), batched=batched,
        buckets=buckets, use_chunked=use_chunked, range_size=pm.range_size,
        methods=run_methods,
    )

    call_idx = 0
    while True:
        counts = queues.count.cpu()
        if int(counts.sum()) == 0:
            break
        order, budgets = _plan(counts, workload_aware=workload_aware, balance=balance,
                               num_streams=num_streams, chunk=chunk)
        active = [(int(p), int(b)) for p, b in zip(order.tolist(), budgets.tolist()) if b > 0]
        for i, (pid, budget) in enumerate(active):
            part = engine.fetch(pid)
            processed = 0
            prefetched = False
            # workload-aware sampling holds the partition until its queue
            # is empty; the baseline releases it after one budget of entries
            while True:
                call_idx += 1
                left = budget if workload_aware else budget - processed
                sampled, entries, remaining = _drain(
                    part, queues, walks, limits, fold_in(key, call_idx), pid, left, **drain_kw)
                if not prefetched and i + 1 < len(active):
                    # double buffering: the drain above is queued, not
                    # awaited; the next partition's copy overlaps it
                    engine.prefetch(active[i + 1][0])
                    prefetched = True
                got = torch.cat([entries, sampled[None], remaining[None]]).tolist()
                entries, sampled, remaining = got[:-2], got[-2], got[-1]
                nonzero = [e for e in entries if e > 0]
                stats.kernel_launches += len(nonzero)
                stats.entries_per_kernel.extend(nonzero)
                stats.sampled_edges += sampled
                processed += sum(entries)
                if remaining == 0 or not nonzero:
                    break
                if not workload_aware and processed >= budget:
                    break

    stats.partition_transfers = engine.stats_transfers
    stats.bytes_transferred = engine.stats_bytes
    stats.frontier_dropped = int(queues.dropped)
    if strict and stats.frontier_dropped:
        raise RuntimeError(
            f"frontier queues dropped {stats.frontier_dropped} walker entries to capacity "
            f"overflow (queue_capacity={cap}, {num_parts} partitions, {num_inst} instances): "
            f"their walks are silently truncated — raise queue_capacity or run with "
            f"strict=False to accept the counted loss")
    return walks[:-1].view(num_inst, cols).cpu().numpy(), stats


#: host plan state by (partition, bias fn, padded shape), most recent last
_PLAN_CACHE: "OrderedDict[tuple, _PartitionPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 32


class _PartitionPlan:
    """One partition's host plan state under one flat bias: the clipped f64
    partition-local bias (non-resident neighbors read degree 0 off the
    phantom row, as the drain samples them), its row statistics, and the
    tables built from it.  Cached across calls (:data:`_PLAN_CACHE`), so
    repeated walks over the same partitions read the biases back and build
    the alias tables once; within a call the reference builds them once too.
    """

    def __init__(self, indptr: np.ndarray, fb_np: np.ndarray):
        self.indptr, self.fb_np = indptr, fb_np
        self.deg = np.diff(indptr).astype(np.int64)
        self.stats = mt.row_stats(indptr, fb_np, self.deg)
        self._host: dict = {}

    def tables(self, methods: tuple) -> tuple:
        """The host ``(prob, alias, row_max)`` the plan needs, None elsewhere."""
        if "alias" in methods and "prob" not in self._host:
            self._host["prob"], self._host["alias"] = sel.build_alias(self.indptr, self.fb_np)
        if "rejection" in methods and "row_max" not in self._host:
            self._host["row_max"] = sel.build_row_max(self.indptr, self.fb_np)
        return (self._host.get("prob") if "alias" in methods else None,
                self._host.get("alias") if "alias" in methods else None,
                self._host.get("row_max") if "rejection" in methods else None)


def _partition_plan(part: RangePartition, program, pad_v: int, pad_e: int, dev) -> _PartitionPlan:
    key = (part.uid, program.bias.fn, pad_v, pad_e)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        pdev = part.to_local_device_csr(pad_vertices=pad_v, pad_edges=pad_e, device=dev)
        fb = program.bias.fn(pdev.graph)
        plan = _PartitionPlan(pdev.graph.indptr.cpu().numpy(),
                              np.maximum(fb.cpu().numpy().astype(np.float64), 0.0))
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    return plan


def _plan_methods(partitions, program, buckets, use_chunked, pad_v, pad_e, dev) -> tuple:
    """One selection method per degree cohort over all partitions, for a
    flat program; empty for an all-ITS plan.  Under ``method="auto"`` the
    row statistics of every partition's local bias are planned together
    (one plan for every partition)."""
    if program.mode != "flat" or program.method == "its":
        return ()
    n_cohorts = len(buckets) + (1 if use_chunked else 0)
    if program.method in ("alias", "rejection"):
        methods = (program.method,) * n_cohorts
    else:
        plans = [_partition_plan(p, program, pad_v, pad_e, dev) for p in partitions]
        deg_all = np.concatenate([p.deg for p in plans])
        stats = tuple(np.concatenate(c) for c in zip(*(p.stats for p in plans)))
        methods = mt.plan_methods(deg_all, stats, buckets=buckets, use_chunked=use_chunked)
    return () if mt.is_trivial(methods) else methods


def _bucket_plan(partitions: List[RangePartition], mode: str) -> tuple:
    """``(flat_md, buckets, use_chunked)`` of a walk over ``partitions``:
    the bucketed paths plan from the true max row degree ``flat_md`` (an
    understated ``max_degree`` would leave hubs in no cohort)."""
    flat_md = 1
    if mode != "opaque":
        for p in partitions:
            if p.num_vertices:
                flat_md = max(flat_md, int(np.diff(p.indptr).max()))
    if mode == "flat":
        return (flat_md, *bk.walk_bucket_plan(flat_md, exact=True))
    if mode == "window":
        return (flat_md, *bk.walk_bucket_plan_window(flat_md))
    return flat_md, (), False


def _padded_shape(partitions: List[RangePartition], total_vertices: int) -> tuple:
    """``(pad_v, pad_e)``: every partition padded to one shape, as the
    reference's shared trace."""
    return (PartitionMap.create(total_vertices, len(partitions)).range_size,
            max(p.num_edges for p in partitions))


def prewarm_plans(partitions: List[RangePartition], total_vertices: int, spec: SamplingSpec,
                  *, device="cuda") -> tuple:
    """Build now what :func:`oom_random_walk` builds at each partition's
    first residency under a flat ``spec``: every partition's host plan state
    and the host tables of the plan's methods, cached across calls
    (:data:`_PLAN_CACHE`), so a later walk pays none of it.  What any walk
    samples is unchanged.  Returns the plan's methods (empty when there is
    nothing to build: an all-ITS plan, a window or opaque spec)."""
    program = tp.lower(spec)
    if program.mode != "flat":
        return ()
    dev = resolve_device(device)
    _, buckets, use_chunked = _bucket_plan(partitions, "flat")
    pad_v, pad_e = _padded_shape(partitions, total_vertices)
    methods = _plan_methods(partitions, program, buckets, use_chunked, pad_v, pad_e, dev)
    for part in partitions if methods else ():
        _partition_plan(part, program, pad_v, pad_e, dev).tables(methods)
    return methods


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``: staged in pinned memory and copied on the
    current stream without waiting, on the card."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
