"""Adaptive selection runtime: per-bucket method planning.

The cost model of ``repro.core.methods``, unchanged.  C-SAW's selection is
ITS, an O(degree) cumsum per draw.  For a static flat bias, alias tables
(``select.build_alias``) amortize an O(E) build into O(1) draws, and
near-uniform biases accept a rejection-sampled candidate in about one round
without any table.  The plan is computed host-side (float64 numpy) from
concrete bucket statistics: one method per degree bucket plus one for the
chunked huge-degree tail when present.

Cost model, per cohort (``TransitionProgram.method == "auto"``):

  - empty cohort                                 → ``"its"``
  - any zero-bias edge in the cohort             → ``"alias"``
  - mean row uniformity ``mean/max >= 0.75``     → ``"rejection"``
  - otherwise                                    → ``"alias"``

Tables and envelopes are cached per ``(graph, bias_fn)`` in a small
strong-ref LRU, keyed on the graph's ``uid`` (which ``CSRGraph.to`` keeps),
so a graph moved between devices builds its tables once; the tensors are
kept per device.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import select as sel

#: Auto-pick rejection only when the mean row uniformity (row mean bias over
#: row max bias) of a cohort is at least this — acceptance rate >= 0.75.
REJECTION_UNIFORMITY = 0.75

#: Bounded plan/table cache: (graph.uid, bias_fn) -> _PlanEntry.
_PLAN_CACHE: "OrderedDict[tuple, _PlanEntry]" = OrderedDict()
_PLAN_CACHE_MAX = 8


class MethodTables(NamedTuple):
    """Prebuilt per-method tensors; ``None`` for methods the plan never uses."""

    prob: Optional[torch.Tensor] = None  # (E,) f32 alias acceptance thresholds
    alias: Optional[torch.Tensor] = None  # (E,) int32 row-local alias redirects
    row_max: Optional[torch.Tensor] = None  # (V,) f32 rejection envelopes


EMPTY_TABLES = MethodTables()


def is_trivial(methods: tuple) -> bool:
    """An all-ITS plan — no tables needed."""
    return all(m == "its" for m in methods)


class _PlanEntry:
    """Cached per-(graph, bias) state: host stats + lazily built tables."""

    def __init__(self, uid, bias_fn, bias_np, deg):
        self._pins = (uid, bias_fn)
        self.bias_np = bias_np  # (E,) float64, clipped at 0
        self.deg = deg  # (V,) int64
        self._row_stats = None
        self._host = {}  # name -> numpy table
        self._device = {}  # (name, device) -> tensor
        self.plans: dict = {}

    def row_stats(self, indptr):
        if self._row_stats is None:
            self._row_stats = row_stats(indptr, self.bias_np, self.deg)
        return self._row_stats

    def _table(self, name, device) -> torch.Tensor:
        t = self._device.get((name, device))
        if t is None:
            t = torch.as_tensor(self._host[name]).to(device)
            self._device[(name, device)] = t
        return t

    def tables(self, methods, indptr, device) -> MethodTables:
        prob = alias = row_max = None
        if any(m == "alias" for m in methods):
            if "prob" not in self._host:
                self._host["prob"], self._host["alias"] = sel.build_alias(indptr, self.bias_np)
            prob, alias = self._table("prob", device), self._table("alias", device)
        if any(m == "rejection" for m in methods):
            if "row_max" not in self._host:
                self._host["row_max"] = sel.build_row_max(indptr, self.bias_np)
            row_max = self._table("row_max", device)
        return MethodTables(prob=prob, alias=alias, row_max=row_max)


def row_stats(indptr, bias_np, deg=None):
    """Per-row ``(mean, max, min)`` of a clipped CSR-order bias (host f64).

    Rows of degree 0 report all-zero stats and are excluded by the cost
    model's liveness mask.
    """
    deg = np.diff(np.asarray(indptr)).astype(np.int64) if deg is None else deg
    e = bias_np.shape[0]
    if e == 0:
        z = np.zeros(deg.shape[0])
        return (z, z, z)
    starts = np.minimum(np.asarray(indptr)[:-1], e - 1)
    rmax = np.where(deg > 0, np.maximum.reduceat(bias_np, starts), 0.0)
    rmin = np.where(deg > 0, np.minimum.reduceat(bias_np, starts), 0.0)
    rsum = np.where(deg > 0, np.add.reduceat(bias_np, starts), 0.0)
    return rsum / np.maximum(deg, 1), rmax, rmin


def plan_methods(
    deg,
    row_stats,
    *,
    buckets: tuple,
    use_chunked: bool,
    override: Optional[str] = None,
) -> tuple:
    """The cost model: one method per degree cohort (host numpy, float64)."""
    n = len(buckets) + (1 if use_chunked else 0)
    if override in ("its", "alias", "rejection"):
        return (override,) * n
    rmean, rmax, rmin = row_stats
    methods = []
    for i, seg in enumerate(buckets):
        lo = 0 if i == 0 else buckets[i - 1]
        absorb = i == len(buckets) - 1 and not use_chunked
        rows = (deg > lo) & ((deg <= seg) | absorb)
        methods.append(_pick(rows, rmean, rmax, rmin))
    if use_chunked:
        rows = deg > buckets[-1]
        methods.append(_pick(rows, rmean, rmax, rmin))
    return tuple(methods)


def _pick(rows, rmean, rmax, rmin) -> str:
    live = rows & (rmax > 0.0)
    if not live.any():
        return "its"
    if (rmin[live] <= 0.0).any():
        return "alias"
    uniformity = float(np.mean(rmean[live] / rmax[live]))
    return "rejection" if uniformity >= REJECTION_UNIFORMITY else "alias"


def plan_for_graph(
    graph,
    bias_fn,
    flat_bias=None,
    *,
    buckets: tuple,
    use_chunked: bool,
    override: Optional[str] = None,
) -> tuple:
    """Plan methods for (graph, flat-bias fn) and build/reuse its tables.

    Returns ``(methods, MethodTables)`` with the tables on the graph's
    device.  ``flat_bias`` optionally supplies the already-evaluated
    ``(E,)`` bias; otherwise ``bias_fn(graph)`` is evaluated.
    ``override="its"`` short-circuits: no stats, no tables.
    """
    n = len(buckets) + (1 if use_chunked else 0)
    if override == "its":
        return ("its",) * n, EMPTY_TABLES
    key = (graph.uid, bias_fn)
    entry = _PLAN_CACHE.get(key)
    indptr = graph.indptr.cpu().numpy()
    if entry is None:
        fb = bias_fn(graph) if flat_bias is None else flat_bias
        bias_np = np.maximum(fb.cpu().numpy().astype(np.float64), 0.0)
        deg = np.diff(indptr).astype(np.int64)
        entry = _PlanEntry(graph.uid, bias_fn, bias_np, deg)
        _PLAN_CACHE[key] = entry
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    plan_key = (tuple(buckets), bool(use_chunked), override)
    methods = entry.plans.get(plan_key)
    if methods is None:
        methods = plan_methods(
            entry.deg,
            entry.row_stats(indptr),
            buckets=tuple(buckets),
            use_chunked=use_chunked,
            override=override,
        )
        entry.plans[plan_key] = methods
    if is_trivial(methods):
        return methods, EMPTY_TABLES
    return methods, entry.tables(methods, indptr, graph.device)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def describe_plan(methods: tuple, buckets: tuple, use_chunked: bool) -> dict:
    """JSON-friendly per-cohort view of a plan."""
    out = {}
    for i, seg in enumerate(buckets):
        lo = 0 if i == 0 else buckets[i - 1]
        out[f"deg({lo},{seg}]"] = methods[i]
    if use_chunked:
        out[f"deg>{buckets[-1]}"] = methods[len(buckets)]
    return out
