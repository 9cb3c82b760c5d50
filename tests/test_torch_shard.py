"""The port's sharded engine (``repro_torch.shard``) on the CPU.

Held against ``repro`` on the same numpy inputs, exact everywhere (vertex
ids, counts):

- the exchange layer (queue push and pop with a payload lane, the pop
  limit, overflow counted, owner routing with deferral, conservation)
  against ``repro.shard.exchange``, in process (those functions need no
  mesh), and the mesh collectives against their definitions;
- the hub layout (``select_hubs``, ``hub_edge_layout``,
  ``hybrid_host_csr``, ``place_hub_edges``, ``localize_hybrid``) against
  ``repro.graph.partition``;
- ``sharded_random_walk`` over ``ShardMesh.on("cpu", D)``, D in {1, 2, 4,
  8}, against ``repro``'s single-device ``random_walk(backend=
  "reference")``, element for element, for every non-opaque program family
  and the drain's options (depth limits and -1 seeds, no hubs, mixed-depth
  batches from sub-rounds and small exchanges, a star graph's hot owner);
- in one child process on a forced 8-device JAX mesh: the port against
  ``repro``'s own ``sharded_random_walk`` (walks and every ``stats`` key),
  ``replicated_psum_walk``, ``instance_parallel_walk``, and the sharded
  ``SamplingService`` and ``StreamingSamplingService``;
- the sharded service's contracts in process: prewarm invisibility,
  heterogeneous cohorts, streaming.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from conftest import MULTIDEVICE_HEADER, run_multidevice_child  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core.api import SamplingSpec as JSamplingSpec  # noqa: E402
from repro.core.engine import random_walk as j_random_walk  # noqa: E402
from repro.core.transition import TransitionProgram as JTransitionProgram  # noqa: E402
from repro.core.transition import WindowBias as JWindowBias  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import partition as jpart  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro.graph import rmat_graph as j_rmat_graph  # noqa: E402
from repro.shard import exchange as jex  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.api import SamplingSpec  # noqa: E402
from repro_torch.core.transition import TransitionProgram, WindowBias  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402
from repro_torch.graph import partition as tpart  # noqa: E402
from repro_torch.serve import SamplingService, StreamingSamplingService  # noqa: E402
from repro_torch.shard import ShardMesh, sharded_random_walk  # noqa: E402
from repro_torch.shard import exchange as tex  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _child_run():
    """The forced 8-device child (the end of this file), started with the
    module's first test so that it runs beside the in-process ones."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_multidevice_child, CHILD, 600)


KEY = jax.random.PRNGKey(11)
KEY_WORDS = np.asarray(jax.random.key_data(KEY))
DEPTH = 6


def _port(g):
    return csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _graph(name):
    """``(repro graph, port graph)`` of the named test graph."""
    if name == "powerlaw":
        g = j_powerlaw_graph(300, seed=3, weighted=True)
    elif name == "rmat":
        g = j_rmat_graph(9, edge_factor=8, seed=5, weighted=True)
    else:  # a star: every hop into or out of vertex 0, one hot owner
        spokes = np.arange(1, 257, dtype=np.int64)
        g = j_csr_from_edges(257, np.zeros_like(spokes), spokes, symmetrize=True)
    return g, _port(g)


# ---------------------------------------------------------------------------
# The exchange layer
# ---------------------------------------------------------------------------


def _jq(q):
    return [np.asarray(f) for f in q.fields] + [int(q.count), int(q.dropped)]


def _tq(q):
    return [f.numpy() for f in q.fields] + [int(q.count), int(q.dropped)]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("cap,pushes,pops", [
    (16, [(10, 0.6), (12, 0.9)], [(5, None), (16, 3), (8, 0)]),
    (8, [(20, 1.0)], [(8, None)]),  # overflow counted
    (32, [(6, 0.5), (6, 0.5), (30, 0.7)], [(3, None), (32, None)]),
])
def test_queue_push_pop_match_repro(cap, pushes, pops):
    """Pushes with a payload lane, pops with and without a limit: fields,
    counts and dropped equal ``repro``'s after every operation."""
    rng = np.random.default_rng(cap)
    widths = (0, 0, 3)
    jq, tq = jex.make_queue(cap, widths), tex.make_queue(cap, widths)
    _assert_same(_jq(jq), _tq(tq))
    ops = [("push", p) for p in pushes] + [("pop", p) for p in pops]
    for kind, arg in ops:
        if kind == "push":
            n, p = arg
            ents = (rng.integers(0, 100, n).astype(np.int32), np.arange(n, dtype=np.int32),
                    rng.integers(0, 9, (n, 3)).astype(np.int32))
            valid = rng.random(n) < p
            jq = jex.queue_push(jq, tuple(jnp.asarray(e) for e in ents), jnp.asarray(valid))
            tq = tex.queue_push(tq, tuple(torch.from_numpy(e) for e in ents),
                                torch.from_numpy(valid))
        else:
            n, lim = arg
            je, jt, jq = jex.queue_pop(jq, n, None if lim is None else jnp.int32(lim))
            te, tt, tq = tex.queue_pop(tq, n, lim)
            _assert_same([np.asarray(x) for x in je] + [int(jt)],
                         [x.numpy() for x in te] + [int(tt)])
        _assert_same(_jq(jq), _tq(tq))


@pytest.mark.parametrize("slots", [1, 3, 64])
def test_route_by_owner_matches_repro(slots):
    """Send buffers, counts, the deferred leftover and its count equal
    ``repro``'s; every valid entry is sent or deferred exactly once."""
    rng = np.random.default_rng(slots)
    n, nd = 64, 4
    ents = (rng.integers(0, 1000, n).astype(np.int32), np.arange(n, dtype=np.int32),
            rng.integers(-2, 50, (n, 5)).astype(np.int32))
    dest = rng.integers(0, nd, n).astype(np.int32)
    dest[:20] = 2  # one hot destination
    valid = rng.random(n) < 0.8
    js, jsent, jl, jlc = jex.route_by_owner(tuple(jnp.asarray(e) for e in ents),
                                            jnp.asarray(dest), jnp.asarray(valid), nd, slots)
    ts, tsent, tl, tlc = tex.route_by_owner(tuple(torch.from_numpy(e) for e in ents),
                                            torch.from_numpy(dest), torch.from_numpy(valid),
                                            nd, slots)
    _assert_same([np.asarray(x) for x in js] + [np.asarray(jsent), int(jlc)],
                 [x.numpy() for x in ts] + [tsent.numpy(), int(tlc)])
    _assert_same([np.asarray(x) for x in jl], [x.numpy() for x in tl])
    got = np.concatenate([ts[1].numpy().reshape(-1), tl[1].numpy()])
    assert sorted(got[got >= 0].tolist()) == np.nonzero(valid)[0].tolist()


def test_entry_nbytes_matches_repro():
    for widths in [(0, 0, 0, 0), (0, 0, 0, 0, 17), (3,)]:
        assert tex.entry_nbytes(widths) == jex.entry_nbytes(widths)


def test_mesh_collectives_match_their_definitions():
    """``all_to_all``: row p of shard d's result is shard p's row d;
    ``psum`` / ``pmax`` reduce over the shards and replicate the result."""
    mesh = ShardMesh.on("cpu", 3)
    rng = np.random.default_rng(0)
    bufs = [torch.from_numpy(rng.integers(0, 99, (3, 4, 2)).astype(np.int32)) for _ in range(3)]
    out = mesh.all_to_all(bufs)
    for d in range(3):
        for p in range(3):
            assert torch.equal(out[d][p], bufs[p][d])
    fields = tex.all_to_all_fields([(b, b + 1) for b in bufs], mesh)
    assert all(torch.equal(f[1], o + 1) for f, o in zip(fields, out))
    xs = [torch.tensor([1, 5]), torch.tensor([4, 2]), torch.tensor([0, 9])]
    assert all(t.tolist() == [5, 16] for t in mesh.psum(xs))
    assert all(t.tolist() == [4, 9] for t in mesh.pmax(xs))
    with pytest.raises(ValueError):
        ShardMesh([])


# ---------------------------------------------------------------------------
# The hub layout
# ---------------------------------------------------------------------------

HUB_CASES = [(hb, seg) for hb in (0, 5_000, 40_000, 10**7) for seg in (128, 512)]


@pytest.mark.parametrize("hb,seg", HUB_CASES)
def test_hub_selection_and_layout_match_repro(hb, seg):
    g, _ = _graph("powerlaw")
    ip = np.asarray(g.indptr)
    jh, th = jpart.select_hubs(ip, hb, seg), tpart.select_hubs(ip, hb, seg)
    np.testing.assert_array_equal(jh, th)
    assert jh.dtype == th.dtype
    (js, je), (ts, te) = jpart.hub_edge_layout(ip, jh, 1000, seg), tpart.hub_edge_layout(
        ip, th, 1000, seg)
    np.testing.assert_array_equal(js, ts)
    assert je == te


@pytest.mark.parametrize("hb,seg", HUB_CASES)
def test_hybrid_csr_and_lanes_match_repro(hb, seg):
    g, tg = _graph("powerlaw")
    ip, ind, w = np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights)
    hubs = jpart.select_hubs(ip, hb, seg)
    starts, end = jpart.hub_edge_layout(ip, hubs, 1000, seg)
    lane = np.random.default_rng(1).random(ind.shape[0]).astype(np.float32)
    for jp, tp in zip(jpart.partition_by_vertex_range(g, 4), tpart.partition_by_vertex_range(tg, 4)):
        want = jpart.hybrid_host_csr(jp, 75, 900, seg, hubs, starts, ip, ind, w)
        got = tpart.hybrid_host_csr(tp, 75, 900, seg, hubs, starts, ip, ind, w)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        base = np.zeros(max(900, end), np.float32)
        np.testing.assert_array_equal(jpart.place_hub_edges(base, lane, ip, hubs, starts),
                                      tpart.place_hub_edges(base, lane, ip, hubs, starts))


@pytest.mark.parametrize("num_hubs", [0, 1, 10, 40])
def test_localize_hybrid_matches_repro(num_hubs):
    g, _ = _graph("powerlaw")
    deg = np.diff(np.asarray(g.indptr))
    hubs = np.sort(np.argsort(-deg, kind="stable")[:num_hubs]).astype(np.int32)
    hubs_arg = hubs if num_hubs else np.full(1, -1, np.int32)
    x = np.arange(-1, 300, dtype=np.int32)
    want = jpart.localize_hybrid(jnp.asarray(x), 75, 75, jnp.asarray(hubs_arg), num_hubs)
    got = tpart.localize_hybrid(torch.from_numpy(x), 75, 75, torch.from_numpy(hubs_arg), num_hubs)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# The sharded walk against the single-device reference walk
# ---------------------------------------------------------------------------


def _degu_specs():
    """A ``needs_deg_u`` window bias in each package."""
    jwb = JWindowBias(lambda ctx: ctx.weight / jnp.maximum(ctx.deg_u, 1), needs_deg_u=True)
    twb = WindowBias(lambda ctx: ctx.weight / torch.clamp(ctx.deg_u, min=1), needs_deg_u=True)
    return (JSamplingSpec(name="degu_window", transition=JTransitionProgram(bias=jwb)),
            SamplingSpec(name="degu_window", transition=TransitionProgram(bias=twb)))


def _forced(m):
    return (dataclasses.replace(jalg.weighted_random_walk(), selection_method=m),
            dataclasses.replace(alg.weighted_random_walk(), selection_method=m))


#: name -> (graph, spec factory, sharded-walk options, limits and -1 seeds)
WALK_CASES = {
    "deepwalk": ("powerlaw", lambda: (jalg.deepwalk(), alg.deepwalk()), {}, False),
    "alias": ("powerlaw", lambda: _forced("alias"), {}, False),
    "rejection": ("powerlaw", lambda: _forced("rejection"), {}, False),
    "its": ("rmat", lambda: _forced("its"), {}, False),
    "node2vec": ("powerlaw", lambda: (jalg.node2vec(), alg.node2vec()), {}, False),
    "degu_window": ("powerlaw", _degu_specs, {}, False),
    "mhrw": ("powerlaw", lambda: (jalg.metropolis_hastings_walk(),
                                  alg.metropolis_hastings_walk()), {}, False),
    "jump": ("powerlaw", lambda: (jalg.random_walk_with_jump(0.15, 300),
                                  alg.random_walk_with_jump(0.15, 300)), {}, False),
    "restart_home": ("powerlaw", lambda: (jalg.random_walk_with_restart(0.15),
                                          alg.random_walk_with_restart(0.15)), {}, False),
    "limits": ("powerlaw", lambda: (jalg.deepwalk(), alg.deepwalk()), {}, True),
    "no_hubs": ("rmat", lambda: (jalg.deepwalk(), alg.deepwalk()), {"hub_bytes": 0}, False),
    "mixed_slots1": ("rmat", lambda: _forced("alias"),
                     {"sub_rounds": 2, "exchange_slots": 1}, False),
    "mixed_slots3": ("powerlaw", lambda: (jalg.node2vec(), alg.node2vec()),
                     {"sub_rounds": 2, "exchange_slots": 3}, False),
    "star": ("star", lambda: (jalg.deepwalk(), alg.deepwalk()),
             {"hub_bytes": 0, "exchange_slots": 2}, False),
}


def _seeds_and_limits(n, v, limited):
    seeds = (np.arange(n) * 7 % v).astype(np.int32)
    limits = None
    if limited:
        rng = np.random.default_rng(2)
        seeds[::9] = -1
        limits = rng.integers(0, DEPTH + 1, n).astype(np.int32)
    return seeds, limits


@functools.lru_cache(maxsize=None)
def _reference(case):
    """``repro``'s single-device walks of a case (each case's JAX trace once)."""
    gname, make, _, limited = WALK_CASES[case]
    g, _ = _graph(gname)
    jspec, _ = make()
    seeds, limits = _seeds_and_limits(64, g.num_vertices, limited)
    walks = np.asarray(j_random_walk(g, jnp.asarray(seeds), KEY, depth=DEPTH, spec=jspec,
                                     max_degree=int(g.max_degree()),
                                     backend="reference").walks)
    if limits is not None:  # the engine has no limits: cut each walk at its own
        walks = np.where(np.arange(DEPTH + 1)[None, :] <= limits[:, None], walks, -1)
    return walks


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_sharded_walk_equals_single_device_reference(case, shards):
    gname, make, opts, limited = WALK_CASES[case]
    g, tg = _graph(gname)
    _, spec = make()
    seeds, limits = _seeds_and_limits(64, g.num_vertices, limited)
    res = sharded_random_walk(ShardMesh.on("cpu", shards), tg, seeds, KEY_WORDS, depth=DEPTH,
                              spec=spec, max_degree=int(g.max_degree()), depth_limits=limits,
                              **opts)
    np.testing.assert_array_equal(res.walks.numpy(), _reference(case))
    lengths = (res.walks >= 0).sum(dim=1)
    assert torch.equal(res.lengths, lengths.to(res.lengths.dtype))
    assert int(res.sampled_edges) == int(torch.clamp(lengths - 1, min=0).sum())
    st = res.stats
    assert st["num_devices"] == shards and st["exchange_bytes"] == (
        st["exchanged_entries"] * st["entry_bytes"])
    if shards == 1:
        assert st["exchanged_entries"] == 0 and st["num_hubs"] == 0


def test_small_exchanges_defer_and_mix_depths(monkeypatch):
    """With two sub-rounds and one exchange slot, entries defer across
    rounds and the step batches hold several depths: the per-entry keys
    keep the walks equal to the reference all the same."""
    g, tg = _graph("rmat")
    seeds, _ = _seeds_and_limits(64, g.num_vertices, False)
    _, spec = _forced("alias")
    from repro_torch.core import backend as tbk
    seen = []
    real = tbk.walk_step_adaptive

    def spy(key, *args, **kwargs):
        d = key.depth[key.inst >= 0]
        seen.append(int(torch.unique(d).numel()))
        return real(key, *args, **kwargs)

    monkeypatch.setattr(tbk, "walk_step_adaptive", spy)
    res = sharded_random_walk(ShardMesh.on("cpu", 4), tg, seeds, KEY_WORDS, depth=DEPTH,
                              spec=spec, max_degree=int(g.max_degree()), sub_rounds=2,
                              exchange_slots=1)
    np.testing.assert_array_equal(res.walks.numpy(), _reference("mixed_slots1"))
    assert max(seen) > 1
    assert res.stats["blocks"] > 1


# ---------------------------------------------------------------------------
# The sharded service's contracts, in process
# ---------------------------------------------------------------------------


def _drain_one(svc, seeds, depth=6, spec=None):
    rid = svc.submit(seeds, depth=depth, spec=spec or alg.deepwalk())
    return svc.drain()[rid]


def test_sharded_service_placement_and_mesh_checks():
    _, tg = _graph("powerlaw")
    mesh = ShardMesh.on("cpu", 2)
    svc = SamplingService(tg, mesh=mesh)
    assert svc.placement == "sharded" and svc.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs graph= and mesh="):
        SamplingService(tg, placement="sharded", device="cpu")
    with pytest.raises(ValueError, match="only meaningful"):
        SamplingService(tg, mesh=mesh, placement="memory", device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        SamplingService(tg, mesh=object(), placement="sharded", device="cpu")


def test_sharded_prewarm_is_invisible():
    """``test_serve.py::test_sharded_prewarm``'s contract: the warm launch
    reuses the full-graph plan, moves no counter, and the first real drain
    samples as a cold service's does."""
    _, tg = _graph("powerlaw")
    mk = lambda: SamplingService(tg, mesh=ShardMesh.on("cpu", 4), placement="sharded",  # noqa: E731
                                 key=np.asarray(jax.random.key_data(jax.random.PRNGKey(4))))
    cold, warm = mk(), mk()
    warm.prewarm(alg.deepwalk(), depth=6, width=12)
    assert warm.stats.prewarmed_placements == ("sharded",)
    assert warm.stats.plans_prewarmed == 1
    seeds = np.arange(12) * 5
    np.testing.assert_array_equal(_drain_one(warm, seeds).walks, _drain_one(cold, seeds).walks)
    assert warm.stats.sharded_launches == 1 and warm.stats.launches == 0


def test_sharded_service_equals_memory_walks_under_launch_key():
    """A sharded cohort's walks equal a single-device walk of the packed
    launch under the same launch key, sliced per request."""
    g, tg = _graph("powerlaw")
    svc = SamplingService(tg, mesh=ShardMesh.on("cpu", 4), key=KEY_WORDS)
    a = svc.submit(np.arange(10), depth=4, spec=alg.deepwalk())
    b = svc.submit(np.arange(20, 45), depth=7, spec=alg.deepwalk())
    res = svc.drain()
    from repro_torch.core.engine import random_walk
    from repro_torch.core.rng import fold_in, split
    _, oom_key = split(KEY_WORDS)
    seeds = np.full(128, -1, np.int32)
    seeds[:10], seeds[10:35] = np.arange(10), np.arange(20, 45)
    full = random_walk(tg, seeds, fold_in(oom_key, 1), depth=8, spec=alg.deepwalk(),
                       max_degree=int(g.max_degree()), device="cpu").walks.numpy()
    np.testing.assert_array_equal(res[a].walks, full[:10, :5])
    np.testing.assert_array_equal(res[b].walks, full[10:35, :8])
    assert svc.stats.sharded_launches == 1 and svc.stats.padded_walker_slots == 128 - 35


def test_sharded_streaming_serves_one_launch():
    """``test_stream.py::test_sharded_streaming``'s contract."""
    _, tg = _graph("powerlaw")
    clk = [0.0]
    svc = SamplingService(tg, mesh=ShardMesh.on("cpu", 2), placement="sharded")
    stream = StreamingSamplingService(svc, clock=lambda: clk[0], start=False)
    f = stream.submit(np.arange(16), depth=5, spec=alg.deepwalk())
    clk[0] = 1.0
    assert stream.poll() == 1
    assert svc.stats.sharded_launches == 1
    assert f.result(timeout=0).walks.shape == (16, 6)


def test_cuda_mesh_needs_a_card():
    """A CUDA mesh raises without a card (nothing falls back to the CPU),
    and with one pins each shard to a card."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardMesh.on("cuda:0", 4)
    else:
        assert all(d.type == "cuda" and d.index is not None
                   for d in ShardMesh.on("cuda", 4).devices)


# ---------------------------------------------------------------------------
# Against repro's own sharded engine and services, on a forced 8-device mesh
# ---------------------------------------------------------------------------

CHILD = MULTIDEVICE_HEADER + """
import dataclasses
import torch
from repro.core import algorithms as jalg
from repro.core.distributed import instance_parallel_walk as j_ipw
from repro.graph import powerlaw_graph
from repro.serve import SamplingService as JService, StreamingSamplingService as JStream
from repro.shard import replicated_psum_walk as j_rpw, sharded_random_walk as j_srw
from repro_torch.core import algorithms as alg
from repro_torch.core.distributed import instance_parallel_walk, graph_sharded_walk
from repro_torch.graph import csr_from_arrays
from repro_torch.serve import SamplingService, StreamingSamplingService
from repro_torch.shard import ShardMesh, replicated_psum_walk, sharded_random_walk

g = powerlaw_graph(300, seed=3, weighted=True)
tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                     device="cpu")
md = int(g.max_degree())
mesh, tmesh = jax.make_mesh((8,), ("data",)), ShardMesh.on("cpu", 8)
seeds = (np.arange(64) * 7 % 300).astype(np.int32)
key = jax.random.PRNGKey(11)
kw = np.asarray(jax.random.key_data(key))
out = {}

def forced(pkg, m):
    return dataclasses.replace(pkg.weighted_random_walk(), selection_method=m)

walk_cases = [
    ("deepwalk", jalg.deepwalk(), alg.deepwalk(), {}),
    ("alias_mixed", forced(jalg, "alias"), forced(alg, "alias"),
     dict(sub_rounds=2, exchange_slots=3)),
    ("node2vec", jalg.node2vec(), alg.node2vec(), {}),
    ("mhrw_nohubs", jalg.metropolis_hastings_walk(), alg.metropolis_hastings_walk(),
     dict(hub_bytes=0)),
]
for name, js, ts, opts in walk_cases:
    r = j_srw(mesh, g, jnp.asarray(seeds), key, depth=5, spec=js, max_degree=md,
              backend="reference", **opts)
    p = sharded_random_walk(tmesh, tg, seeds, kw, depth=5, spec=ts, max_degree=md, **opts)
    out["walk/" + name] = [bool(np.array_equal(np.asarray(r.walks), p.walks.numpy())),
                           r.stats == p.stats, r.stats["hub_hops"] + r.stats["exchanged_entries"]]

opaque_j = dataclasses.replace(jalg.weighted_random_walk(), transition=None, flat_edge_bias=None)
opaque_t = dataclasses.replace(alg.weighted_random_walk(), transition=None, flat_edge_bias=None)
r = j_rpw(mesh, g, jnp.asarray(seeds), key, depth=5, spec=opaque_j, max_degree=md)
p = replicated_psum_walk(tmesh, tg, seeds, kw, depth=5, spec=opaque_t, max_degree=md)
out["replicated"] = bool(np.array_equal(np.asarray(r), p.numpy()))
# the opaque program's sharded walk is the same fallback
p = graph_sharded_walk(tmesh, tg, seeds, kw, depth=5, spec=opaque_t, max_degree=md)
out["opaque_fallback"] = bool(np.array_equal(np.asarray(r), p.numpy()))

r = j_ipw(mesh, g, jnp.asarray(seeds), key, depth=6, spec=jalg.deepwalk(), max_degree=md)
p = instance_parallel_walk(tmesh, tg, seeds, kw, depth=6, spec=alg.deepwalk(), max_degree=md)
out["instance_parallel"] = [bool(np.array_equal(np.asarray(r.walks), p.walks.numpy())),
                            bool(np.array_equal(np.asarray(r.lengths), p.lengths.numpy())),
                            int(r.sampled_edges) == int(p.sampled_edges)]

def burst(svc, pkg):
    rng = np.random.default_rng(1)
    tickets = {}
    for i in range(8):
        spec = [pkg.deepwalk(), pkg.weighted_random_walk(), pkg.node2vec()][i % 3]
        n, dep = int(rng.integers(8, 49)), int(rng.choice([4, 6, 10]))
        rid = svc.submit(rng.integers(0, 300, n), depth=dep, spec=spec)
        tickets[rid] = (n, dep)
    return tickets, svc.drain()

js = JService(g, mesh=mesh, placement="sharded", backend="reference",
              key=jax.random.PRNGKey(9))
ts = SamplingService(tg, mesh=tmesh, placement="sharded", key=np.asarray(
    jax.random.key_data(jax.random.PRNGKey(9))))
jt, jres = burst(js, jalg)
tt, tres = burst(ts, alg)
ip, ind = np.asarray(g.indptr), np.asarray(g.indices)
geom = edges = equal = True
for rid, (n, dep) in tt.items():
    w = tres[rid].walks
    geom &= w.shape == (n, dep + 1) and bool((tres[rid].lengths >= 1).all())
    equal &= bool(np.array_equal(w, jres[rid].walks))
    equal &= bool(np.array_equal(tres[rid].lengths, jres[rid].lengths))
    for row in w:
        for a, b in zip(row[:-1], row[1:]):
            if a < 0 or b < 0:
                break
            edges &= bool(b in ind[ip[a]:ip[a + 1]])
out["service"] = dict(geom=bool(geom), edges=bool(edges), equal=bool(equal),
                      stats=dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats),
                      launches=ts.stats.sharded_launches)

clk = [0.0]
jstream = JStream(JService(g, mesh=mesh, placement="sharded", backend="reference"),
                  clock=lambda: clk[0], start=False)
tstream = StreamingSamplingService(SamplingService(tg, mesh=tmesh, placement="sharded"),
                                   clock=lambda: clk[0], start=False)
jf = jstream.submit(np.arange(16), depth=5, spec=jalg.deepwalk())
tf = tstream.submit(np.arange(16), depth=5, spec=alg.deepwalk())
clk[0] = 1.0
assert jstream.poll() == 1 and tstream.poll() == 1
out["stream"] = dict(equal=bool(np.array_equal(jf.result(timeout=0).walks,
                                               tf.result(timeout=0).walks)),
                     launches=tstream.stats.sharded_launches)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child(_child_run):
    return _child_run.result()


def test_child_sharded_walk_equals_repro_sharded_walk_and_stats(child):
    walks = {k: v for k, v in child.items() if k.startswith("walk/")}
    assert len(walks) == 4
    for name, (equal, stats_equal, traffic) in walks.items():
        assert equal and stats_equal and traffic > 0, name


def test_child_replicated_psum_and_opaque_fallback_equal_repro(child):
    assert child["replicated"] and child["opaque_fallback"]


def test_child_instance_parallel_walk_equals_repro(child):
    assert all(child["instance_parallel"])


def test_child_sharded_service_cohorts_equal_repro(child):
    svc = child["service"]
    assert svc["geom"] and svc["edges"] and svc["equal"] and svc["stats"]
    assert svc["launches"] >= 1


def test_child_sharded_streaming_equals_repro(child):
    assert child["stream"]["equal"] and child["stream"]["launches"] == 1
