"""The port's flat-bias ``random_walk`` against the JAX reference, end to end.

``walks``, ``lengths`` and ``sampled_edges`` must equal
``repro.core.engine.random_walk(..., backend="reference")`` exactly, for the
same key, for every flat spec and selection method, on a small power-law
graph and on a star whose hub (degree 600) drives every huge-degree tail.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import algorithms as jalg  # noqa: E402
from repro.core.engine import random_walk as j_random_walk  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core.engine import random_walk  # noqa: E402
from repro_torch.core.rng import PRNGKey, key_from_array  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
DEPTH = 6


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
        seeds[20] = -1  # dead on arrival
        if name == "star":
            seeds[:12] = 0  # start on the hub
        _GRAPHS[name] = (g, tg, seeds)
    return _GRAPHS[name]


def _both(graph, spec_name, method, *, max_degree=None, seed=11):
    g, tg, seeds = _graph(graph)
    md = g.max_degree() if max_degree is None else max_degree
    jspec = dataclasses.replace(getattr(jalg, spec_name)(), selection_method=method)
    tspec = dataclasses.replace(getattr(talg, spec_name)(), selection_method=method)
    key = jax.random.PRNGKey(seed)
    want = j_random_walk(g, jnp.asarray(seeds), key, depth=DEPTH, spec=jspec, max_degree=md,
                         backend="reference")
    got = random_walk(tg, seeds, key_from_array(jax.random.key_data(key)), depth=DEPTH,
                      spec=tspec, max_degree=md, device="cpu")
    return want, got


@pytest.mark.parametrize("graph", ["powerlaw", "star"])
@pytest.mark.parametrize("method", ["its", "alias", "rejection", None])
@pytest.mark.parametrize("spec", ["deepwalk", "weighted_random_walk", "biased_random_walk"])
def test_walks_equal_reference(graph, spec, method):
    want, got = _both(graph, spec, method)
    assert got.walks.shape == (48, DEPTH + 1) and got.walks.dtype == torch.int32
    np.testing.assert_array_equal(got.walks.numpy(), np.asarray(want.walks))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.sampled_edges) == int(want.sampled_edges)
    assert (got.walks[20] == -1).all()


@pytest.mark.parametrize("method", ["its", "alias", "rejection"])
def test_understated_max_degree_truncates_like_reference(method):
    """The hub (degree 600) is absorbed into the top bucket and truncated."""
    want, got = _both("star", "weighted_random_walk", method, max_degree=100, seed=5)
    np.testing.assert_array_equal(got.walks.numpy(), np.asarray(want.walks))


def test_cpu_walk_launches_no_kernel():
    kernels.reset_launch_counts()
    _, tg, seeds = _graph("star")
    random_walk(tg, seeds, PRNGKey(0), depth=3, spec=talg.deepwalk(), max_degree=600, device="cpu")
    assert kernels.launch_counts() == {"walk_step": 0, "reject_step": 0, "alias_step": 0}


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, seeds = _graph("powerlaw")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_walk(tg, seeds, PRNGKey(0), depth=2, spec=talg.deepwalk(), max_degree=14)
    from repro_torch.graph import powerlaw_graph

    with pytest.raises(RuntimeError, match="device='cpu'"):
        powerlaw_graph(64, seed=0)


def test_window_and_epilogue_programs_name_the_next_slice():
    from repro_torch.core import transition as tp

    for make in (tp.WindowBias, tp.MHAcceptEpilogue, tp.TeleportEpilogue):
        with pytest.raises(NotImplementedError, match="window-bias slice"):
            make()


_ISOLATION_CHILD = """
import json, sys
from repro_torch.core import algorithms as alg
from repro_torch.core.engine import random_walk
from repro_torch.core.rng import PRNGKey
from repro_torch.graph import powerlaw_graph
g = powerlaw_graph(200, seed=3, weighted=True, device="cpu")
res = random_walk(g, list(range(16)), PRNGKey(1), depth=4, spec=alg.weighted_random_walk(),
                  max_degree=g.max_degree(), device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "edges": int(res.sampled_edges)}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _ISOLATION_CHILD], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["edges"] > 0
