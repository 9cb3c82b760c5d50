"""The port's transition programs against the JAX reference, end to end.

Node2vec (window bias), MH, jump, restart to a fixed vertex and restart to
the walk's seed (flat bias with declarative epilogues), and opaque walks
(the dense context and the ITS draw): ``walks``, ``lengths`` and
``sampled_edges`` must equal ``repro.core.engine.random_walk(...,
backend="reference")`` exactly, for the same key, on a small power-law graph
and on a star whose hub (degree 600) drives the huge-degree tails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import transition as jtp  # noqa: E402
from repro.core.engine import random_walk as j_random_walk  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import transition as ttp  # noqa: E402
from repro_torch.core.engine import random_walk  # noqa: E402
from repro_torch.core.rng import PRNGKey, key_from_array  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402

DEPTH = 8
P = 0.3  # teleport probability


def _star(hub_degree: int = 600, seed: int = 3):
    """A hub joined to every leaf, leaves on a ring, random weights."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, hub_degree + 1)
    src = np.concatenate([np.zeros(hub_degree, np.int64), leaves])
    dst = np.concatenate([leaves, np.roll(leaves, 1)])
    w = rng.random(src.size).astype(np.float32) + 0.1
    return j_csr_from_edges(hub_degree + 1, src, dst, weights=w, symmetrize=True)


_GRAPHS = {}


def _graph(name):
    if name not in _GRAPHS:
        g = j_powerlaw_graph(256, seed=1, weighted=True) if name == "powerlaw" else _star()
        tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                             device="cpu")
        seeds = np.random.default_rng(0).integers(0, g.num_vertices, 48).astype(np.int32)
        if name == "star":
            seeds[:12] = 0  # start on the hub
        _GRAPHS[name] = (g, tg, seeds)
    return _GRAPHS[name]


def _specs(pkg, num_vertices):
    """The transition-program walks, by name, from ``repro`` or the port."""
    return {
        "node2vec": pkg.node2vec(),
        "node2vec_p3_q07": pkg.node2vec(3.0, 0.7),
        "mhrw": pkg.metropolis_hastings_walk(),
        "rw_jump": pkg.random_walk_with_jump(P, num_vertices),
        "rw_restart": pkg.random_walk_with_restart(P, home=5),
        "rw_restart_home": pkg.random_walk_with_restart(P),
    }


def _both(graph, make, *, max_degree=None, seed=11, seeds=None, depth=DEPTH):
    """``make(pkg, num_vertices)`` builds the spec from either package."""
    g, tg, default_seeds = _graph(graph)
    seeds = default_seeds if seeds is None else seeds
    md = g.max_degree() if max_degree is None else max_degree
    key = jax.random.PRNGKey(seed)
    want = j_random_walk(g, jnp.asarray(seeds), key, depth=depth,
                         spec=make(jalg, g.num_vertices), max_degree=md, backend="reference")
    got = random_walk(tg, seeds, key_from_array(jax.random.key_data(key)), depth=depth,
                      spec=make(talg, g.num_vertices), max_degree=md, device="cpu")
    return want, got


def _assert_equal(want, got):
    np.testing.assert_array_equal(got.walks.numpy(), np.asarray(want.walks))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.sampled_edges) == int(want.sampled_edges)


@pytest.mark.parametrize("graph", ["powerlaw", "star"])
@pytest.mark.parametrize("name", ["node2vec", "node2vec_p3_q07", "mhrw", "rw_jump", "rw_restart",
                                  "rw_restart_home"])
def test_program_walks_equal_reference(graph, name):
    want, got = _both(graph, lambda pkg, nv: _specs(pkg, nv)[name])
    assert got.walks.shape == (48, DEPTH + 1) and got.walks.dtype == torch.int32
    _assert_equal(want, got)
    if graph == "powerlaw":
        assert int(got.lengths.min()) == DEPTH + 1  # nobody silently died


def test_dead_seeds_stay_dead():
    _, _, seeds = _graph("powerlaw")
    seeds = seeds.copy()
    seeds[[3, 20]] = -1
    for name in ("node2vec", "rw_restart_home"):
        want, got = _both("powerlaw", lambda pkg, nv: _specs(pkg, nv)[name], seeds=seeds)
        _assert_equal(want, got)
        assert (got.walks[[3, 20]] == -1).all()


def test_window_understated_max_degree_truncates_like_reference():
    """The window plan trusts the caller's bound: the hub (degree 600)
    is absorbed into the top cohort and truncated, and the prev-membership
    search runs too few halvings for it — exactly as in the reference."""
    g, tg, seeds = _graph("star")
    want, got = _both("star", lambda pkg, nv: pkg.node2vec(), max_degree=256, seed=5)
    _assert_equal(want, got)
    hub_hops = got.walks[:12, 1]
    assert ((hub_hops >= 1) & (hub_hops <= 256)).all()


@pytest.mark.parametrize("graph", ["powerlaw", "star"])
@pytest.mark.parametrize("name", ["weighted", "node2vec", "mhrw", "rw_jump"])
def test_opaque_walks_equal_reference(graph, name):
    """Specs lowered from their hooks alone: the dense context, the user's
    edge-bias hook and (for MH and jump) the raw ``update`` hook."""

    def make(pkg, nv):
        if name == "weighted":
            return dataclasses.replace(pkg.weighted_random_walk(), transition=None,
                                       flat_edge_bias=None)
        if name == "node2vec":
            return dataclasses.replace(pkg.node2vec(), transition=None)
        return dataclasses.replace(_specs(pkg, nv)[name], transition=None, flat_edge_bias=None)

    want, got = _both(graph, make, depth=6)
    assert ttp.lower(make(talg, 1000)).mode == "opaque"
    _assert_equal(want, got)


def test_legacy_update_hook_on_the_flat_path():
    """A flat bias with a raw ``update`` hook lowers to the flat path with an
    opaque epilogue (the hook sees the D = 1 context)."""

    def make(pkg, nv):
        return dataclasses.replace(_specs(pkg, nv)["rw_jump"], transition=None)

    prog = ttp.lower(make(talg, 257))
    assert prog.mode == "flat" and isinstance(prog.epilogue, ttp.OpaqueEpilogue)
    want, got = _both("powerlaw", make)
    _assert_equal(want, got)


def test_opaque_blocks_give_the_same_walks(monkeypatch):
    """The dense context runs in blocks of walkers; block edges change no
    walker's pick."""
    from repro_torch.core import engine

    _, tg, seeds = _graph("star")
    spec = dataclasses.replace(talg.weighted_random_walk(), transition=None, flat_edge_bias=None)
    whole = random_walk(tg, seeds, PRNGKey(4), depth=4, spec=spec, max_degree=600, device="cpu")
    monkeypatch.setattr(engine, "GATHER_BLOCK", 7)
    blocked = random_walk(tg, seeds, PRNGKey(4), depth=4, spec=spec, max_degree=600,
                          device="cpu")
    np.testing.assert_array_equal(blocked.walks.numpy(), whole.walks.numpy())


def test_window_row_blocks_give_the_same_walks(monkeypatch):
    """Window cohorts and chunked tails evaluate the hook in blocks of rows;
    block edges change no walker's pick."""
    from repro_torch.core import select

    _, tg, seeds = _graph("star")
    whole = random_walk(tg, seeds, PRNGKey(6), depth=4, spec=talg.node2vec(), max_degree=600,
                        device="cpu")
    monkeypatch.setattr(select, "ROW_BLOCK", 5)
    blocked = random_walk(tg, seeds, PRNGKey(6), depth=4, spec=talg.node2vec(), max_degree=600,
                          device="cpu")
    np.testing.assert_array_equal(blocked.walks.numpy(), whole.walks.numpy())


def test_restart_home_returns_to_seed():
    _, tg, seeds = _graph("powerlaw")
    res = random_walk(tg, seeds, PRNGKey(2), depth=4, spec=talg.random_walk_with_restart(1.0),
                      max_degree=14, device="cpu")
    walks = res.walks.numpy()
    np.testing.assert_array_equal(walks[:, 1:], np.repeat(seeds[:, None], 4, axis=1))


# ---------------------------------------------------------------------------
# lowering and the IR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["flat", "flat_prev", "opaque", "update", "declared", "override"])
def test_lower_legacy_inference_matches_reference(case):
    from repro.core import api as japi

    def make(api, alg):  # a spec without a declared program, from the hooks
        flat = alg.deepwalk().flat_edge_bias
        return {
            "flat": api.SamplingSpec(flat_edge_bias=flat),
            "flat_prev": api.SamplingSpec(flat_edge_bias=flat, needs_prev_neighbors=True),
            "opaque": api.SamplingSpec(edge_bias=api.weight_edge_bias),
            "update": api.SamplingSpec(flat_edge_bias=flat,
                                       update=alg.metropolis_hastings_walk().update),
            "declared": alg.node2vec(),
            "override": dataclasses.replace(alg.deepwalk(), selection_method="alias"),
        }[case]

    want, got = jtp.lower(make(japi, jalg)), ttp.lower(make(tapi, talg))
    assert got.mode == want.mode
    assert got.method == want.method
    assert type(got.epilogue).__name__ == type(want.epilogue).__name__
    assert type(got.bias).__name__ == type(want.bias).__name__
    assert got.carries_home == want.carries_home


def test_teleport_checks_and_home_carry():
    with pytest.raises(ValueError, match="num_vertices"):
        ttp.TeleportEpilogue(0.1, "uniform")
    with pytest.raises(ValueError, match="vertex"):
        ttp.TeleportEpilogue(0.1, "fixed")
    assert ttp.lower(talg.random_walk_with_restart(0.2)).carries_home
    assert not ttp.lower(talg.random_walk_with_restart(0.2, home=3)).carries_home
    with pytest.raises(ValueError, match="method"):
        ttp.TransitionProgram(bias=ttp.OpaqueBias(), method="fastest")
    with pytest.raises(NotImplementedError, match="home carry"):
        talg.random_walk_with_restart(0.2).update(PRNGKey(0), None, torch.zeros(2, dtype=torch.int32))


def test_algorithm_registry():
    assert set(talg.ALGORITHMS) == set(jalg.ALGORITHMS) | {"rw_jump", "rw_restart"}
    for name in jalg.ALGORITHMS:
        assert talg.ALGORITHMS[name]().name == jalg.ALGORITHMS[name]().name
