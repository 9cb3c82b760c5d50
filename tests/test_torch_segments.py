"""The port's ``random_walk_segments`` against the JAX reference.

R requests of W walkers run as one batch, each row under its own key.  Row
``r`` must equal ``repro.core.engine.random_walk(graph, seeds[r], keys[r],
..., backend="reference")`` exactly — walks, lengths and sampled edges —
in every mode (flat rejection, ITS and alias, window, opaque) and epilogue
(MH, jump, restart to the walk's seed), with rows padded with -1, a row all
-1, and R = 1; on a small power-law graph and on a star whose hub (degree
600) drives the huge-degree tails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.core.engine import random_walk as j_random_walk  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import transition as ttp  # noqa: E402
from repro_torch.core.engine import random_walk, random_walk_segments  # noqa: E402
from repro_torch.core.rng import RowKeys, fold_in, uniform, uniform_at  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.threefry import derive_keys  # noqa: E402

DEPTH = 4
ROWS, WIDTH = 3, 24
P = 0.3  # teleport probability


def _star(hub_degree: int = 600, seed: int = 3):
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, hub_degree + 1)
    src = np.concatenate([np.zeros(hub_degree, np.int64), leaves])
    dst = np.concatenate([leaves, np.roll(leaves, 1)])
    w = rng.random(src.size).astype(np.float32) + 0.1
    return j_csr_from_edges(hub_degree + 1, src, dst, weights=w, symmetrize=True)


_GRAPHS = {}


def _graph(name):
    if name not in _GRAPHS:
        g = j_powerlaw_graph(512, seed=3, weighted=True) if name == "powerlaw" else _star()
        tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                             device="cpu")
        seeds = np.random.default_rng(0).integers(0, g.num_vertices, (ROWS, WIDTH))
        seeds = seeds.astype(np.int32)
        seeds[1, 13:] = -1  # a request of 13 walkers, padded
        seeds[2, 5] = -1
        if name == "star":
            seeds[:, :6] = 0  # start on the hub
        _GRAPHS[name] = (g, tg, seeds)
    return _GRAPHS[name]


def _spec(pkg, name, nv):
    opaque = dict(transition=None, flat_edge_bias=None)
    return {
        "deepwalk": lambda: dataclasses.replace(pkg.deepwalk(), selection_method="rejection"),
        "its": lambda: dataclasses.replace(pkg.weighted_random_walk(), selection_method="its"),
        "alias": lambda: dataclasses.replace(pkg.weighted_random_walk(),
                                             selection_method="alias"),
        "auto": pkg.biased_random_walk,
        "node2vec": pkg.node2vec,
        "opaque": lambda: dataclasses.replace(pkg.weighted_random_walk(), **opaque),
        "mhrw": pkg.metropolis_hastings_walk,
        "jump": lambda: pkg.random_walk_with_jump(P, nv),
        "restart_home": lambda: pkg.random_walk_with_restart(P),
    }[name]()


def _keys(rows, seed=5):
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(seed), jnp.arange(rows))
    return keys, np.asarray(jax.random.key_data(keys))


def _check(graph, name, seeds=None, depth=DEPTH):
    g, tg, default = _graph(graph)
    seeds = default if seeds is None else seeds
    rows = seeds.shape[0]
    md = g.max_degree()
    jkeys, words = _keys(rows)
    got = random_walk_segments(tg, seeds, words, depth=depth,
                               spec=_spec(talg, name, g.num_vertices), max_degree=md,
                               device="cpu")
    assert got.walks.shape == (rows, seeds.shape[1], depth + 1)
    assert got.lengths.shape == seeds.shape and got.sampled_edges.shape == (rows,)
    jspec = _spec(jalg, name, g.num_vertices)
    for r in range(rows):
        want = j_random_walk(g, jnp.asarray(seeds[r]), jkeys[r], depth=depth, spec=jspec,
                             max_degree=md, backend="reference")
        np.testing.assert_array_equal(got.walks[r].numpy(), np.asarray(want.walks),
                                      err_msg=f"{graph}/{name} row {r}")
        np.testing.assert_array_equal(got.lengths[r].numpy(), np.asarray(want.lengths))
        assert int(got.sampled_edges[r]) == int(want.sampled_edges)
    return got


@pytest.mark.parametrize("name", ["deepwalk", "its", "alias", "auto", "node2vec", "opaque",
                                  "mhrw", "jump", "restart_home"])
def test_rows_equal_standalone_reference_walks(name):
    got = _check("powerlaw", name)
    assert (got.walks[1, 13:] == -1).all() and (got.walks[2, 5] == -1).all()


@pytest.mark.parametrize("name", ["deepwalk", "its", "alias", "node2vec"])
def test_rows_equal_standalone_reference_walks_on_hub_tails(name):
    """The star's hub (degree 600) takes the huge-degree tail: the ITS
    tail's uniforms (``uniform_at``), the alias tail's and the window
    tail's, each under its walker's row key."""
    got = _check("star", name)
    assert (got.walks[:, :6, 1] >= 1).all()


def test_single_row_and_an_empty_row():
    _, _, seeds = _graph("powerlaw")
    _check("powerlaw", "deepwalk", seeds=seeds[:1])
    empty = seeds.copy()
    empty[0] = -1
    got = _check("powerlaw", "mhrw", seeds=empty)
    assert (got.walks[0] == -1).all() and int(got.sampled_edges[0]) == 0


def test_rows_equal_the_ports_standalone_walks():
    """Row ``r`` also equals the port's own ``random_walk`` under key ``r``,
    and the batch launches no kernel on the CPU."""
    g, tg, seeds = _graph("powerlaw")
    _, words = _keys(ROWS)
    spec = talg.node2vec()
    kernels.reset_launch_counts()
    got = random_walk_segments(tg, seeds, words, depth=DEPTH, spec=spec,
                               max_degree=g.max_degree(), device="cpu")
    assert all(v == 0 for v in kernels.launch_counts().values())
    for r in range(ROWS):
        solo = random_walk(tg, seeds[r], words[r], depth=DEPTH, spec=spec,
                           max_degree=g.max_degree(), device="cpu")
        assert torch.equal(got.walks[r], solo.walks)


def test_row_keys_derive_and_draw_as_jax():
    """``derive_keys`` equals ``jax.random.fold_in`` along each path, and
    the draws under ``RowKeys`` equal each row's own draw: uniforms of any
    trailing shape, the uniforms of chosen walkers, the rejection budget."""
    jkeys, words = _keys(4, seed=9)
    base = torch.from_numpy(words.view(np.int32).copy())
    paths = [(), (3,), (3, 1, 2), (7, 1, 2, 15), (0,) * 8]
    table = derive_keys(base, paths).numpy().view(np.uint32)
    for r in range(4):
        for p, path in enumerate(paths):
            k = jkeys[r]
            for d in path:
                k = jax.random.fold_in(k, d)
            np.testing.assert_array_equal(table[r, p], np.asarray(jax.random.key_data(k)))
    rk = fold_in(fold_in(RowKeys(base, 6), 3), 1)
    u = uniform(rk, (24, 2))
    walkers = torch.tensor([0, 5, 6, 17, 23])
    at = uniform_at(rk, walkers)
    rej = ref.rejection_randoms(fold_in(rk, 2), (24,))
    for r in range(4):
        k = jax.random.fold_in(jax.random.fold_in(jkeys[r], 3), 1)
        np.testing.assert_array_equal(u[6 * r:6 * r + 6].numpy(),
                                      np.asarray(jax.random.uniform(k, (6, 2))))
        one = np.asarray(jax.random.uniform(k, (6,)))
        mine = walkers[(walkers // 6) == r]
        np.testing.assert_array_equal(at[(walkers // 6) == r].numpy(), one[mine.numpy() % 6])
        kb = jax.random.fold_in(k, 2)
        for t in range(2 * ref.REJECT_ITERS):
            want = np.asarray(jax.random.uniform(jax.random.fold_in(kb, t), (6,)))
            np.testing.assert_array_equal(rej[6 * r:6 * r + 6, t // 2, t % 2].numpy(), want)


def test_keys_must_cover_the_batch():
    _, tg, seeds = _graph("powerlaw")
    with pytest.raises(ValueError):
        random_walk_segments(tg, seeds[0], np.zeros((1, 2), np.uint32), depth=1,
                             spec=talg.deepwalk(), max_degree=8, device="cpu")
    rk = RowKeys(torch.zeros((2, 2), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        uniform(rk, (5,))
    assert ttp.lower(talg.deepwalk()).mode == "flat"
