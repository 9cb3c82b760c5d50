"""The port's out-of-memory walk and partitions against ``repro``'s.

``oom_random_walk`` over ``partition_by_vertex_range`` partitions of a small
power-law graph: the walks and every ``OOMStats`` field (transfers, bytes,
launches, entries per chunk, sampled edges, drops) must equal
``repro.core.oom.oom_random_walk(..., backend="reference")`` exactly, for
flat programs (auto, ITS, alias, rejection plans), window (node2vec),
opaque, the MH / jump / restart-to-seed epilogues, the paper's four Fig. 13
ablation configurations, per-instance ``depth_limits``, -1 seeds, queue
overflow (``strict=``) and an understated ``max_degree``.  The partitions'
arrays equal ``repro``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.core.oom import oom_random_walk as j_oom  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro.graph.partition import partition_by_vertex_range as j_partition  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core.oom import oom_random_walk  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402
from repro_torch.graph.partition import (  # noqa: E402
    PartitionMap,
    partition_by_vertex_range,
    partition_of,
)

DEPTH = 5

_SETUPS = {}


def _setup(name="powerlaw"):
    if name not in _SETUPS:
        if name == "powerlaw":
            g = j_powerlaw_graph(512, seed=3, weighted=True)
            seeds = np.random.default_rng(0).integers(0, 512, 96)
        else:  # a hub of degree 700 and its leaves
            hub = 700
            src = np.concatenate([np.zeros(hub, int), np.arange(1, hub + 1)])
            dst = np.concatenate([np.arange(1, hub + 1), np.zeros(hub, int)])
            w = np.random.default_rng(0).uniform(0.1, 2.0, src.shape[0]).astype(np.float32)
            g = j_csr_from_edges(hub + 1, src, dst, w)
            seeds = np.zeros(16, np.int64)  # every walk starts at the hub
        tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                             device="cpu")
        _SETUPS[name] = (g, j_partition(g, 4), partition_by_vertex_range(tg, 4), seeds)
    return _SETUPS[name]


def _spec(pkg, name, nv):
    return {
        "auto": pkg.biased_random_walk,
        "deepwalk": pkg.deepwalk,
        "its": lambda: dataclasses.replace(pkg.weighted_random_walk(), selection_method="its"),
        "alias": lambda: dataclasses.replace(pkg.weighted_random_walk(),
                                             selection_method="alias"),
        "rejection": lambda: dataclasses.replace(pkg.deepwalk(), selection_method="rejection"),
        "node2vec": pkg.node2vec,
        "opaque": lambda: dataclasses.replace(pkg.weighted_random_walk(), transition=None,
                                              flat_edge_bias=None),
        "mhrw": pkg.metropolis_hastings_walk,
        "jump": lambda: pkg.random_walk_with_jump(0.3, nv),
        "restart_home": lambda: pkg.random_walk_with_restart(0.3),
    }[name]()


def _both(name, setup="powerlaw", seeds=None, key=6, **kw):
    g, jparts, tparts, default = _setup(setup)
    seeds = default if seeds is None else seeds
    kw = dict(dict(depth=DEPTH, max_degree=g.max_degree(), memory_capacity=2, chunk=64), **kw)
    jkey = jax.random.PRNGKey(key)
    want = j_oom(jparts, g.num_vertices, seeds, jkey, spec=_spec(jalg, name, g.num_vertices),
                 backend="reference", **kw)
    got = oom_random_walk(tparts, g.num_vertices, seeds, np.asarray(jax.random.key_data(jkey)),
                          spec=_spec(talg, name, g.num_vertices), device="cpu", **kw)
    return want, got


def _assert_equal(want, got):
    (w_want, s_want), (w_got, s_got) = want, got
    np.testing.assert_array_equal(w_got, w_want)
    assert dataclasses.asdict(s_got) == dataclasses.asdict(s_want)
    assert s_got.kernel_time_std() == s_want.kernel_time_std()


@pytest.mark.parametrize("name", ["auto", "deepwalk", "its", "alias", "rejection", "node2vec",
                                  "opaque", "mhrw", "jump", "restart_home"])
def test_walks_and_stats_equal_reference(name):
    want, got = _both(name)
    _assert_equal(want, got)
    assert got[1].sampled_edges > 0 and got[1].kernel_launches > 0


@pytest.mark.parametrize("batched,workload_aware,balance", [
    (False, False, False), (True, False, False), (True, True, False), (True, True, True),
], ids=["base", "BA", "BA+WS", "BA+WS+BAL"])
def test_fig13_ablations_equal_reference(batched, workload_aware, balance):
    want, got = _both("auto", batched=batched, workload_aware=workload_aware, balance=balance,
                      memory_capacity=2, num_streams=2, chunk=32)
    _assert_equal(want, got)


def test_depth_limits_and_padding_seeds():
    _, _, _, seeds = _setup()
    seeds = seeds.copy()
    seeds[[4, 50]] = -1
    limits = np.random.default_rng(1).integers(0, DEPTH + 1, seeds.shape[0])
    want, got = _both("node2vec", seeds=seeds, depth_limits=limits)
    _assert_equal(want, got)
    walks = got[0]
    assert (walks[[4, 50]] == -1).all()
    assert ((walks >= 0).sum(axis=1)[seeds >= 0] <= limits[seeds >= 0] + 1).all()
    with pytest.raises(ValueError, match="depth_limits"):
        _both("auto", depth_limits=np.full(seeds.shape[0], DEPTH + 1))


def test_queue_overflow_counts_drops_and_strict_raises():
    want, got = _both("deepwalk", queue_capacity=8, chunk=32)
    _assert_equal(want, got)
    assert got[1].frontier_dropped > 0
    with pytest.raises(RuntimeError, match="dropped .* capacity overflow"):
        _both("deepwalk", queue_capacity=8, chunk=32, strict=True)
    _, stats = _both("deepwalk", strict=True)[1]  # the default capacity never drops
    assert stats.frontier_dropped == 0


@pytest.mark.parametrize("name", ["its", "node2vec", "auto"])
def test_understated_max_degree_still_walks_hubs(name):
    """The bucketed paths plan from the partitions' true max degree (700),
    not the caller's 256: hub walkers step, through the huge-degree tail."""
    want, got = _both(name, setup="hub", key=4, depth=4, max_degree=256)
    _assert_equal(want, got)
    assert (got[0][:, 1] >= 1).all()


def test_partitions_equal_reference():
    g, jparts, tparts, _ = _setup()
    pm = PartitionMap.create(g.num_vertices, 4)
    pad_e = max(p.num_edges for p in jparts)
    for jp, tp in zip(jparts, tparts):
        assert (jp.pid, jp.vertex_lo, jp.vertex_hi, jp.edge_lo) == (
            tp.pid, tp.vertex_lo, tp.vertex_hi, tp.edge_lo)
        for field in ("indptr", "indices", "weights"):
            a, b = getattr(jp, field), getattr(tp, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        for align in (0, 128):
            jdev = jp.to_local_device_csr(pad_vertices=pm.range_size, pad_edges=pad_e,
                                          edge_align=align)
            tdev = tp.to_local_device_csr(pad_vertices=pm.range_size, pad_edges=pad_e,
                                          edge_align=align, device="cpu")
            for a, b in ((jdev.graph.indptr, tdev.graph.indptr),
                         (jdev.graph.indices, tdev.graph.indices),
                         (jdev.graph.weights, tdev.graph.weights),
                         (jdev.indices_global, tdev.indices_global)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            ids = torch.tensor([-1, tp.vertex_lo, tp.vertex_hi - 1, tp.vertex_hi, 511])
            np.testing.assert_array_equal(tdev.localize(ids).numpy(),
                                          np.asarray(jdev.localize(ids.numpy())))
    v = np.arange(-1, g.num_vertices + 2)
    np.testing.assert_array_equal(partition_of(v, g.num_vertices, 4), pm.pid_of(v))
    np.testing.assert_array_equal(pm.pid_of_device(torch.from_numpy(v)).numpy(),
                                  np.clip(np.floor_divide(v, pm.range_size), 0, 3))
