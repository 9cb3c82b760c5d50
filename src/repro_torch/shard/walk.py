"""Owner-routed sharded random walk over a :class:`ShardMesh` (paper §V-D).

The semantics of ``repro.shard.walk``.  Each shard of the mesh holds one
contiguous vertex-range partition as a compact local-id CSR, plus a small
region of replicated *hub* rows, and a frontier queue of the walkers
currently at its vertices (``shard.exchange.ShardQueue``).  A drain round:

1. flushes the deferred emigrants: per-destination compaction into fixed
   ``(D, slots)`` buffers, one ``all_to_all``, overflow deferred to the next
   round (never dropped), received walkers pushed into the local queue;
2. runs ``sub_rounds`` local steps, each popping the queue (every popped
   walker's vertex is resident or a hub, so its whole row is local),
   stepping through the same degree-bucketed dispatch as the single-device
   engine (``core.backend``: the ``reject_step``, ``alias_step``,
   ``walk_step`` and ``walk_step_window`` kernels on the card), and pushing
   survivors back into the local queue (resident or hub rows) or the
   deferred buffer (cold rows);
3. a ``psum`` of the live and deferred counts, read on the host, ends the
   drain and skips empty exchanges, where JAX's ``lax.cond`` skipped them.

The shards step in lockstep, one process driving them all, as JAX's single
``shard_map`` does: ``ShardMesh.on("cuda:0", 4)`` runs four shards on one
card; each shard's tensors live on its own device.  Rounds run in blocks of
``rounds_per_block`` as JAX's compiled scan does, so ``stats["blocks"]``
equals ``repro``'s.

**Bit-identical parity** with single-device ``engine.random_walk``, for
every non-opaque transition program, rests on what ``repro`` pins:

- *RNG*: each entry draws under the walk's key at its own depth, at its own
  instance (``rng.EntryKeys``: a device table of ``fold_in(key, d)`` for
  every depth, the step suffixes derived once a call by ``derive_keys``),
  never at its slot in a shard's batch, so a batch may mix depths;
- *selection arithmetic*: shards keep ``edge_align = max(buckets)`` lead
  padding and hub rows their global ``start % seg`` offset, so the pick
  kernels' windows and scans see the full graph's bits;
- *flat biases*: evaluated once on the full graph and sliced per shard, and
  the method plan is ``engine.flat_method_plan`` on the full graph (the
  in-memory engine's cache entry), its tables sliced the same way;
- *prev-dependent window biases* (node2vec): the previous vertex's neighbor
  row is carried with the walker (``-2``-padded, as wide as the graph's true
  max degree); membership is a binary search over its sorted live prefix;
- *non-resident degrees* (``needs_deg_u`` window biases, MH-accept): a
  replicated per-edge lane ``deg_tgt[e] = deg(indices[e])``.

Programs with opaque hooks fall back to :func:`replicated_psum_walk`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as bk
from repro_torch.core import methods as mt
from repro_torch.core import transition as tp
from repro_torch.core.api import EdgeCtx, SamplingSpec
from repro_torch.core.engine import WalkResult, _degree, _edge_ctx, flat_method_plan
from repro_torch.core.rng import EntryKeys, fold_in, key_from_array
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import (
    PartitionMap,
    hub_edge_layout,
    hybrid_host_csr,
    localize_hybrid,
    partition_by_vertex_range,
    pid_of_device,
    place_hub_edges,
    select_hubs,
)
from repro_torch.shard import exchange as ex
from repro_torch.shard.mesh import ShardMesh

#: safety valve on the host drain loop (each block makes progress as long as
#: exchange_slots >= 1)
_MAX_BLOCKS = 4096

#: sorts after every vertex id in a carried neighbor row
_ROW_END = torch.iinfo(torch.int32).max


def _carried_window_bias(program, v, prev, d, deg_v, prow, deg_tgt):
    """The window-bias hook closed over carried walker state, as
    ``engine._window_bias_fn`` builds it over the full graph (``deg_v``:
    the walkers' row degrees).

    Membership in N(prev) is a binary search of each candidate over the
    carried ``(B, prow_w)`` row of ``prev`` (sorted ids, then ``-2``
    padding): the booleans of ``repro``'s dense compare.  ``needs_deg_u``
    hooks read the replicated target-degree lane at the window's edge
    positions ``eidx``.
    """
    wb = program.bias
    e_hi = deg_tgt.shape[0] - 1
    keys = None
    if wb.needs_prev_neighbors:
        keys = torch.where(prow >= 0, prow, _ROW_END).contiguous()

    def bias_of(rows, u, w, mask, eidx=None):
        if wb.needs_deg_u:
            du = torch.where(mask, deg_tgt[torch.clamp(eidx, 0, e_hi)], 0)
        else:  # declared unused: reads as zeros
            du = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        ipn = None
        if wb.needs_prev_neighbors:
            kr = keys[rows]
            uq = u.to(kr.dtype).contiguous()
            pos = torch.clamp(torch.searchsorted(kr, uq), max=kr.shape[1] - 1)
            ipn = ((torch.gather(kr, 1, pos) == uq) & mask & (prev[rows] >= 0)[:, None]
                   & (u >= 0))
        ctx = EdgeCtx(v=v[rows], u=u, weight=w, deg_v=deg_v[rows], deg_u=du, prev=prev[rows],
                      is_prev_neighbor=ipn, depth=d[rows][:, None])
        return wb.fn(ctx)

    return bias_of


def _selected_deg(iglob, deg_tgt, st, dg, u, steps: int):
    """deg(u) of the SELECTED neighbor off the replicated degree lane: a
    binary search for ``u`` in the current row's sorted global ids
    ``iglob[st : st + dg]`` (``2**steps`` must reach the max row degree);
    dead walkers read 1."""
    e_hi = iglob.shape[0] - 1
    st, dg = st.long(), dg.long()
    lo = torch.zeros_like(dg)
    hi = dg.clone()
    for _ in range(steps):
        open_ = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = iglob[torch.clamp(st + mid, 0, e_hi)] < u
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    pos = torch.clamp(st + lo, 0, e_hi)
    found = (lo < dg) & (iglob[pos] == u) & (u >= 0)
    return torch.where(found, deg_tgt[torch.clamp(pos, 0, deg_tgt.shape[0] - 1)], 1)


# ---------------------------------------------------------------------------
# The shards' layout (host build, cached) and their device state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Layout:
    """The sharded graph: every shard's hybrid CSR, lanes and tables on its
    device, and the sizes the drain needs."""

    shards: list  # per shard: dict of device tensors
    range_size: int
    num_hubs: int
    hub_replicated_edges: int


_LAYOUT_CACHE: "OrderedDict[tuple, _Layout]" = OrderedDict()
#: layouts kept (each holds a copy of the graph across the mesh)
_LAYOUT_CACHE_MAX = 2


def clear_layout_cache() -> None:
    _LAYOUT_CACHE.clear()


def _build_layout(mesh: ShardMesh, graph: CSRGraph, program, methods, tables_full, hb: int,
                  seg_big: int, lanes: tuple) -> _Layout:
    """Range-partition ``graph`` over the mesh, replicate the hubs, slice
    the full-graph per-edge lanes (bias, alias tables, target degrees) and
    envelopes into every shard's layout, and place each shard on its device.
    ``lanes`` names the optional lanes: ``"bias"`` (flat), ``"deg_tgt"``."""
    num_devices = mesh.size
    indptr_np = graph.indptr.cpu().numpy()
    indices_np = graph.indices.cpu().numpy()
    weights_np = graph.weights.cpu().numpy()
    pm = PartitionMap.create(graph.num_vertices, num_devices)
    parts = partition_by_vertex_range(graph, num_devices)
    hubs_np = select_hubs(indptr_np, hb, seg_big)
    num_hubs = int(hubs_np.shape[0])

    pad_v = pm.range_size
    pad_e_local = max((p.edge_lo % seg_big) + p.num_edges for p in parts)
    hub_lo = -(-pad_e_local // seg_big) * seg_big
    hub_starts, hub_end = hub_edge_layout(indptr_np, hubs_np, hub_lo, seg_big)
    pad_e = max(pad_e_local, hub_end)
    phantom = pad_v + 2 * num_hubs

    def edge_lane(full, p):
        lane = np.zeros(pad_e, full.dtype)
        lead = p.edge_lo % seg_big
        lane[lead: lead + p.num_edges] = full[p.edge_lo: p.edge_lo + p.num_edges]
        if num_hubs:
            lane = place_hub_edges(lane, full, indptr_np, hubs_np, hub_starts)
        return lane

    flat_full = (np.asarray(program.bias.fn(graph).cpu().numpy(), dtype=np.float32)
                 if "bias" in lanes else None)
    dt_full = (np.diff(indptr_np).astype(np.int32)[indices_np] if "deg_tgt" in lanes else None)
    prob_full = alias_full = rm_full = None
    if tables_full.prob is not None:
        prob_full = tables_full.prob.cpu().numpy()
        alias_full = tables_full.alias.cpu().numpy()
    if tables_full.row_max is not None:
        rm_full = tables_full.row_max.cpu().numpy()

    shards = []
    for p, dev in zip(parts, mesh.devices):
        indptr, iloc, iglob, wts = hybrid_host_csr(
            p, pad_v, pad_e, seg_big, hubs_np, hub_starts, indptr_np, indices_np, weights_np)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        sh = dict(device=dev, vertex_lo=p.vertex_lo, indptr=put(indptr), iloc=put(iloc),
                  iglob=put(iglob), wts=put(wts))
        sh["bias"] = put(edge_lane(flat_full, p)) if flat_full is not None else sh["wts"]
        prob = alias = row_max = None
        if prob_full is not None:
            prob, alias = put(edge_lane(prob_full, p)), put(edge_lane(alias_full, p))
        if rm_full is not None:
            rm = np.zeros(phantom + 1, np.float32)
            rm[: p.num_vertices] = rm_full[p.vertex_lo: p.vertex_hi]
            if num_hubs:
                rm[pad_v + 1 + 2 * np.arange(num_hubs)] = rm_full[hubs_np]
            row_max = put(rm)
        sh["tables"] = mt.MethodTables(prob=prob, alias=alias, row_max=row_max)
        sh["deg_tgt"] = (put(edge_lane(dt_full, p)) if dt_full is not None
                         else torch.zeros(1, dtype=torch.int32, device=dev))
        sh["hubs"] = put((hubs_np if num_hubs else np.full(1, -1, np.int64)).astype(np.int32))
        shards.append(sh)
    replicated = int(np.sum(np.diff(indptr_np)[hubs_np])) if num_hubs else 0
    return _Layout(shards, pm.range_size, num_hubs, replicated)


def _layout(mesh, graph, program, methods, tables_full, hb, seg_big, lanes) -> _Layout:
    """The cached layout of ``graph`` over ``mesh`` (keyed on the graph's
    ``uid``, the devices, the hub budget, the window width, the flat bias
    and the plan)."""
    bias_fn = program.bias.fn if "bias" in lanes else None
    key = (graph.uid, mesh.devices, hb, seg_big, lanes, bias_fn, methods)
    if key not in _LAYOUT_CACHE:
        _LAYOUT_CACHE[key] = _build_layout(mesh, graph, program, methods, tables_full, hb,
                                           seg_big, lanes)
        while len(_LAYOUT_CACHE) > _LAYOUT_CACHE_MAX:
            _LAYOUT_CACHE.popitem(last=False)
    _LAYOUT_CACHE.move_to_end(key)
    return _LAYOUT_CACHE[key]


# ---------------------------------------------------------------------------
# The drain
# ---------------------------------------------------------------------------


def _sub_step(sh, st, *, program, spec, mode, methods, buckets, use_chunked, range_size,
              num_hubs, num_inst, depth, needs_prev, prow_w, use_mh, mh_steps, keys):
    """One local step of one shard: pop, select, epilogue, record, push."""
    q, defer = st["q"], st["defer"]
    cap = q.capacity
    entries, _, _ = ex.queue_pop(q, cap, limit=cap - defer.count)
    v, inst, d, prev = entries[:4]
    prow = entries[4] if needs_prev else None
    valid = inst >= 0
    phantom = range_size + 2 * num_hubs
    rowid = lambda x: localize_hybrid(x, sh["vertex_lo"], range_size, sh["hubs"],  # noqa: E731
                                      num_hubs)
    curq = torch.where(valid, rowid(v), -1)
    indptr, iglob = sh["indptr"], sh["iglob"]
    start = indptr[torch.clamp(curq, min=0).long()].long()
    deg_v = _degree(CSRGraph(indptr=indptr, indices=sh["iloc"], weights=sh["wts"]), curq)
    ek = keys.with_entries(d, inst)

    if mode == "flat":
        u = bk.walk_step_adaptive(
            fold_in(ek, 1), indptr, iglob, sh["bias"], curq, buckets=buckets,
            use_chunked=use_chunked, methods=methods, tables=sh["tables"])
    else:
        bias_of = _carried_window_bias(program, v, prev, d, deg_v, prow, sh["deg_tgt"])
        u = bk.walk_step_bucketed_window(
            fold_in(ek, 1), indptr, iglob, sh["wts"], curq, bias_of, buckets=buckets,
            use_chunked=use_chunked)

    if isinstance(program.epilogue, tp.IdentityEpilogue):
        nxt = u
    else:
        deg_u = (_selected_deg(iglob, sh["deg_tgt"], start, deg_v, u, mh_steps) if use_mh
                 else torch.zeros_like(u))
        ctx = EdgeCtx(v=v, u=u[:, None], weight=torch.ones(u.shape + (1,), device=u.device),
                      deg_v=deg_v, deg_u=deg_u[:, None], prev=prev, is_prev_neighbor=None,
                      depth=d)
        home = st["seeds"][torch.clamp(inst, min=0).long()] if program.carries_home else None
        nxt = tp.apply_epilogue(fold_in(ek, 2), program, spec, ctx, u, home)
    nxt = torch.where(u >= 0, nxt, -1).to(torch.int32)

    ok = valid & (nxt >= 0)
    # an entry that writes nothing writes its own slot past the walks, so no
    # two writes meet
    flat = torch.where(ok, inst.long() * (depth + 1) + d.long() + 1,
                       num_inst * (depth + 1) + torch.arange(cap, device=v.device))
    st["walks"].index_copy_(0, flat, nxt)
    cont = ok & (d + 1 < st["limits"][torch.clamp(inst, min=0).long()])

    new_entry = [nxt, inst, d + 1, v]
    if needs_prev:
        # the next step's membership test needs N(v): gather v's row here,
        # on the one shard that holds it, and carry it along
        offs = torch.arange(prow_w, device=v.device)
        rmask = (offs[None, :] < deg_v[:, None]) & valid[:, None]
        new_entry.append(torch.where(rmask, iglob[torch.where(rmask, start[:, None] + offs, 0)],
                                     -2))
    stay_local = rowid(nxt) != phantom
    ex.queue_push(q, tuple(new_entry), cont & stay_local)
    ex.queue_push(defer, tuple(new_entry), cont & ~stay_local)
    st["stats"][1] += (valid & (curq > range_size)).sum()
    st["stats"][2] += valid.sum()


def _exchange(mesh, layout, states, slots):
    """Flush every shard's deferred emigrants through one ``all_to_all``."""
    num_dest = mesh.size
    routed = []
    for st in states:
        defer = st["defer"]
        cap = defer.capacity
        dmask = torch.arange(cap, device=defer.count.device) < defer.count
        dest = pid_of_device(defer.fields[0], layout.range_size, num_dest)
        routed.append(ex.route_by_owner(defer.fields, dest, dmask, num_dest, slots))
    recv = ex.all_to_all_fields([r[0] for r in routed], mesh)
    for st, (_, sent, leftover, left_count), rb in zip(states, routed, recv):
        rflat = tuple(r.reshape((num_dest * slots,) + tuple(r.shape[2:])) for r in rb)
        ex.queue_push(st["q"], rflat, rflat[1] >= 0)
        defer = st["defer"]
        for f, lf in zip(defer.fields, leftover):
            f.copy_(lf)
        defer.count.copy_(left_count)
        st["stats"][0] += sent.sum()


def sharded_random_walk(
    mesh: ShardMesh,
    graph: CSRGraph,
    seeds,
    key,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
    depth_limits: Optional[np.ndarray] = None,
    exchange_slots: Optional[int] = None,
    queue_capacity: Optional[int] = None,
    rounds_per_block: Optional[int] = None,
    hub_bytes: Optional[int] = None,
    sub_rounds: int = 1,
) -> WalkResult:
    """Random walk over a range-sharded graph: owners step, emigrants route.

    Each shard of ``mesh`` holds one vertex-range shard of ``graph`` plus
    the replicated hub region, and walkers migrate to the shard that owns
    their vertex only when it is neither resident nor a hub.  For every
    non-opaque transition program the result equals single-device
    ``engine.random_walk(graph, seeds, key, ...)`` bit for bit (for window
    programs ``max_degree`` must be the true max degree, as the engine's
    window plan takes it).  Programs with opaque hooks fall back to
    :func:`replicated_psum_walk`.

    ``depth_limits`` (optional ``(W,)`` in ``[0, depth]``) stops instance
    ``i`` after its own number of steps; ``-1`` seeds are padding.
    ``exchange_slots`` bounds a destination's send buffer a round (the rest
    defer); the queues hold the whole walker population by default
    (``queue_capacity``).  ``rounds_per_block`` sizes a block of rounds
    (``depth + 1`` by default); blocks run while any shard holds live
    walkers.  ``hub_bytes`` budgets each shard's replicated hub region
    (default about half a shard's edge footprint; 0 disables hubs).
    ``sub_rounds`` local steps run between two exchanges.

    ``key`` is a ``uint32[2]`` key.  Returns a ``WalkResult`` on the mesh's
    first device whose ``stats`` holds the exchange traffic, the hub and
    resident hop split, the layout's hub footprint and the block count, as
    ``repro``'s.
    """
    program = tp.lower(spec)
    mode = program.mode
    owner_ok = mode != "opaque" and not isinstance(program.epilogue, tp.OpaqueEpilogue)
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    seeds_np = np.asarray(seeds, dtype=np.int32)
    num_inst = int(seeds_np.shape[0])
    key = key_from_array(key)
    home = mesh.devices[0]
    if depth_limits is None:
        limits_np = np.full((num_inst,), depth, np.int32)
    else:
        limits_np = np.asarray(depth_limits, dtype=np.int32)
        if limits_np.shape != (num_inst,):
            raise ValueError(f"depth_limits shape {limits_np.shape} != ({num_inst},)")
        if limits_np.size and (limits_np.min() < 0 or limits_np.max() > depth):
            raise ValueError(f"depth_limits must lie in [0, depth={depth}], got "
                             f"[{limits_np.min()}, {limits_np.max()}]")

    def result(walks, stats=None):
        lengths = (walks >= 0).sum(dim=-1, dtype=torch.int32)
        return WalkResult(walks, lengths, torch.clamp(lengths - 1, min=0).sum(), stats)

    if not owner_ok:
        walks = replicated_psum_walk(mesh, graph, seeds_np, key, depth=depth, spec=spec,
                                     max_degree=max_degree)
        lim = torch.from_numpy(limits_np).to(home)
        walks = torch.where(torch.arange(depth + 1, device=home)[None, :] <= lim[:, None],
                            walks, -1)
        return result(walks)
    if depth < 1 or num_inst == 0:
        walks = torch.full((num_inst, depth + 1), -1, dtype=torch.int32, device=home)
        if num_inst:
            walks[:, 0] = torch.from_numpy(seeds_np).to(home)
        return result(walks)

    num_devices = mesh.size
    if mode == "flat":
        buckets, use_chunked = bk.walk_bucket_plan(max_degree)
    else:
        buckets, use_chunked = bk.walk_bucket_plan_window(max_degree)
    seg_big = max(buckets)
    needs_prev = mode == "window" and program.bias.needs_prev_neighbors
    use_mh = isinstance(program.epilogue, tp.MHAcceptEpilogue)
    needs_degu = mode == "window" and program.bias.needs_deg_u
    degs = graph.indptr[1:] - graph.indptr[:-1]
    true_max_deg = int(degs.max()) if degs.numel() else 0
    prow_w = true_max_deg if needs_prev else 0
    needs_prev = prow_w > 0
    mh_steps = min(32, max(1, true_max_deg.bit_length())) if use_mh else 1

    if num_devices > 1:
        # default: about half a shard's replicated-lane footprint
        hb = ((4 * 7 * graph.num_edges) // (2 * num_devices) if hub_bytes is None
              else int(hub_bytes))
    else:
        hb = 0  # one shard: everything is resident

    methods: tuple = ()
    tables_full = mt.EMPTY_TABLES
    if mode == "flat":
        # the in-memory engine's plan and tables (same cache entry), so the
        # method of every cohort, and every drawn bit, match
        methods, tables_full = flat_method_plan(graph, program, max_degree)
    lanes = (("bias",) if mode == "flat" else ()) + (("deg_tgt",) if use_mh or needs_degu
                                                     else ())
    layout = _layout(mesh, graph, program, methods, tables_full, hb, seg_big, lanes)
    num_hubs = layout.num_hubs

    cap = num_inst if queue_capacity is None else int(queue_capacity)
    if cap < 1:
        raise ValueError(f"queue_capacity must be >= 1, got {cap}")
    slots = cap if exchange_slots is None else int(exchange_slots)
    if slots < 1:
        raise ValueError(f"exchange_slots must be >= 1, got {slots}")
    slots = min(slots, cap)
    widths = (0, 0, 0, 0) + ((prow_w,) if needs_prev else ())

    # -- initial queues: every live seed starts at its owner ----------------
    live0 = (seeds_np >= 0) & (limits_np > 0)
    owners = PartitionMap.create(graph.num_vertices, num_devices).pid_of(np.maximum(seeds_np, 0))
    depth_keys = np.stack([fold_in(key, d) for d in range(depth)]).view(np.int32)
    per_device: dict = {}
    states = []
    for dv, dev in enumerate(mesh.devices):
        idxs = np.nonzero(live0 & (owners == dv))[0].astype(np.int32)
        k = len(idxs)
        if k > cap:
            raise ValueError(f"queue_capacity={cap} cannot hold the {k} seeds owned by shard "
                             f"{dv}; raise queue_capacity (default: num instances)")
        if dev not in per_device:  # what shards on one device share
            seeds_d = torch.from_numpy(seeds_np).to(dev)
            empty = torch.empty(0, dtype=torch.int32, device=dev)
            per_device[dev] = (seeds_d, torch.from_numpy(limits_np).to(dev),
                               EntryKeys(torch.from_numpy(depth_keys.copy()).to(dev), empty,
                                         empty))
        seeds_d, limits_d, keys = per_device[dev]
        q, defer = ex.make_queue(cap, widths, device=dev), ex.make_queue(cap, widths, device=dev)
        for f in q.fields[4:] + defer.fields[4:]:
            f.fill_(-2)  # carried rows are -2-padded
        idx_d = torch.from_numpy(idxs).to(dev)
        q.fields[0][:k] = seeds_d[idx_d.long()]
        q.fields[1][:k] = idx_d
        q.fields[2][:k] = 0
        q.count.fill_(k)
        # the walks, then a slot for each batch entry that writes nothing
        walks = torch.full((num_inst * (depth + 1) + cap,), -1, dtype=torch.int32, device=dev)
        walks[: num_inst * (depth + 1): depth + 1] = seeds_d
        states.append(dict(
            q=q, defer=defer, walks=walks,
            seeds=seeds_d, limits=limits_d, stats=torch.zeros(3, dtype=torch.int64, device=dev),
            keys=keys,
        ))

    sub = max(int(sub_rounds), 1)
    rounds = max(int(rounds_per_block) if rounds_per_block else depth + 1, 1)
    step = dict(program=program, spec=spec, mode=mode, methods=methods, buckets=buckets,
                use_chunked=use_chunked, range_size=layout.range_size, num_hubs=num_hubs,
                num_inst=num_inst, depth=depth, needs_prev=needs_prev, prow_w=prow_w,
                use_mh=use_mh, mh_steps=mh_steps)

    def live_counts():
        tot = mesh.psum([torch.stack([st["q"].count + st["defer"].count, st["defer"].count])
                         for st in states])[0]
        return tot.tolist()

    blocks = 0
    while True:
        blocks += 1
        done = False
        for _ in range(rounds):
            live, deferred = live_counts()
            if live == 0:
                done = True  # the block's remaining rounds would be skipped
                break
            if deferred > 0:
                _exchange(mesh, layout, states, slots)
            for _ in range(sub):
                for sh, st in zip(layout.shards, states):
                    _sub_step(sh, st, keys=st["keys"], **step)
        if done or live_counts()[0] == 0:
            break
        if blocks >= _MAX_BLOCKS:
            raise RuntimeError(f"sharded drain made no global progress after {blocks} blocks "
                               f"— exchange_slots={slots} too small?")
    dropped = int(sum(int(st["q"].dropped) for st in states))
    if dropped:
        raise RuntimeError(f"sharded frontier queues dropped {dropped} walkers — "
                           f"queue_capacity={cap} is below the live walker population")
    walks = mesh.pmax([st["walks"] for st in states])[0]
    walks = walks[: num_inst * (depth + 1)].view(num_inst, depth + 1)
    acc = sum(st["stats"].to(home) for st in states).tolist()
    entry_bytes = ex.entry_nbytes(widths)
    stats = {
        "num_devices": num_devices,
        "exchanged_entries": int(acc[0]),
        "exchange_bytes": int(acc[0]) * entry_bytes,
        "entry_bytes": entry_bytes,
        "hub_hops": int(acc[1]),
        "resident_hops": int(acc[2] - acc[1]),
        "num_hubs": num_hubs,
        "hub_replicated_edges": layout.hub_replicated_edges,
        "sub_rounds": sub,
        "blocks": blocks,
    }
    return result(walks, stats)


# ---------------------------------------------------------------------------
# Replicated-state fallback (opaque-hook programs only)
# ---------------------------------------------------------------------------


def shard_graph_for_mesh(graph: CSRGraph, num_devices: int):
    """Range-partition a CSR into per-shard CSRs over the full vertex space.

    Returns host numpy ``(indptr (D, V+1), indices (D, Emax), weights (D,
    Emax))``: shard ``p``'s rows of unowned vertices are empty (so global
    ids index directly), its edge arrays padded to the largest partition.
    Only :func:`replicated_psum_walk` uses this layout.
    """
    parts = partition_by_vertex_range(graph, num_devices)
    v = graph.num_vertices
    emax = max(p.num_edges for p in parts)
    indptrs, indices, weights = [], [], []
    for p in parts:
        full = np.zeros(v + 1, np.int32)
        full[p.vertex_lo + 1: p.vertex_hi + 1] = p.indptr[1:]
        full[p.vertex_hi + 1:] = p.indptr[-1]
        indptrs.append(full)
        indices.append(np.pad(p.indices, (0, emax - p.num_edges)).astype(np.int32))
        weights.append(np.pad(p.weights, (0, emax - p.num_edges)).astype(np.float32))
    return np.stack(indptrs), np.stack(indices), np.stack(weights)


def replicated_psum_walk(
    mesh: ShardMesh,
    graph: CSRGraph,
    seeds,
    key,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
) -> torch.Tensor:
    """Walk over a sharded graph: owners advance, ``psum`` merges.

    Returns walks ``(I, depth+1)`` on the mesh's first device.  Each step,
    every shard builds the dense context of the walkers at the vertices it
    owns (the others read a dummy row), evaluates the spec's hooks, picks by
    ITS (``its_select`` with K = 1 on the card) under ``fold_in(fold_in(key,
    step), 1)``, applies the epilogue under ``fold_in(·, 2)``, and one
    integer ``psum`` replicates the advanced state.  The opaque-program
    fallback of :func:`sharded_random_walk`, as ``repro``'s: it draws its
    own RNG pattern, not the single-device engine's.
    """
    ndev = mesh.size
    program = tp.lower(spec)
    key = key_from_array(key)
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    seeds_np = np.asarray(seeds, dtype=np.int32)
    ip, ind, wt = shard_graph_for_mesh(graph, ndev)
    bounds = PartitionMap.create(graph.num_vertices, ndev).bounds
    shards = []
    for p, dev in enumerate(mesh.devices):
        local = CSRGraph(torch.from_numpy(ip[p]).to(dev), torch.from_numpy(ind[p]).to(dev),
                         torch.from_numpy(wt[p]).to(dev))
        seeds_d = torch.from_numpy(seeds_np).to(dev)
        shards.append(dict(local=local, lo=int(bounds[p]), hi=int(bounds[p + 1]), cur=seeds_d,
                           prev=torch.full_like(seeds_d, -1),
                           home=seeds_d if program.carries_home else None))
    path = [torch.from_numpy(seeds_np).to(mesh.devices[0])]
    for it in range(depth):
        kstep = fold_in(key, it)
        contribs, deads = [], []
        for sh in shards:
            cur, lo, hi = sh["cur"], sh["lo"], sh["hi"]
            own = (cur >= lo) & (cur < hi)
            safe = torch.where(own, cur, lo)
            ctx, mask = _edge_ctx(sh["local"], safe, sh["prev"], it, max_degree,
                                  spec.needs_prev_neighbors)
            biases = torch.where(mask, spec.edge_bias(ctx), 0.0)
            idx = bk.select_with_replacement(fold_in(kstep, 1), biases, mask, 1)
            u = torch.gather(ctx.u, 1, idx.long())[:, 0]
            alive = own & (cur >= 0) & mask.any(dim=-1)
            u = torch.where(alive, tp.apply_epilogue(fold_in(kstep, 2), program, spec, ctx, u,
                                                     sh["home"]), -1)
            contribs.append(torch.where(own, torch.where(alive, u, -1), 0).to(torch.int32))
            deads.append(torch.where(own, (~alive).to(torch.int32), 0))
        nxts, dead = mesh.psum(contribs), mesh.psum(deads)
        for sh, nxt, dd in zip(shards, nxts, dead):
            nxt = torch.where((dd > 0) | (sh["cur"] < 0), -1, nxt)
            sh["prev"], sh["cur"] = sh["cur"], nxt
        path.append(shards[0]["cur"])
    return torch.stack(path, dim=1)
