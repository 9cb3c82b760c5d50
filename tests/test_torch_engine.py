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

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

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
    assert kernels.launch_counts() == {"walk_step": 0, "reject_step": 0, "alias_step": 0,
                                       "walk_step_window": 0, "its_select": 0,
                                       "derive_keys": 0}


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, seeds = _graph("powerlaw")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_walk(tg, seeds, PRNGKey(0), depth=2, spec=talg.deepwalk(), max_degree=14)
    from repro_torch.graph import powerlaw_graph

    with pytest.raises(RuntimeError, match="device='cpu'"):
        powerlaw_graph(64, seed=0)


_ISOLATION_CHILD = """
import dataclasses, json, sys
from repro_torch.core import algorithms as alg
from repro_torch.core.engine import random_walk, traversal_sample
from repro_torch.core.rng import PRNGKey
from repro_torch.graph import powerlaw_graph
g = powerlaw_graph(200, seed=3, weighted=True, device="cpu")
opaque = dataclasses.replace(alg.weighted_random_walk(), transition=None, flat_edge_bias=None)
walked = 0
for spec in (alg.weighted_random_walk(), alg.node2vec(), alg.metropolis_hastings_walk(), opaque):
    res = random_walk(g, list(range(16)), PRNGKey(1), depth=4, spec=spec,
                      max_degree=g.max_degree(), device="cpu")
    walked += int(res.sampled_edges > 0)
sample = traversal_sample(g, [[0], [5]], PRNGKey(1), depth=2, spec=alg.layer_sampling(),
                          max_degree=g.max_degree(), pool_capacity=16, max_vertices=200,
                          device="cpu")
from repro_torch.core.engine import random_walk_segments
from repro_torch.core.oom import oom_random_walk
from repro_torch.core.rng import fold_in
from repro_torch.graph.partition import partition_by_vertex_range
import numpy as np
keys = np.stack([fold_in(PRNGKey(2), r) for r in range(3)])
fused = random_walk_segments(g, [[0, 1], [2, -1], [3, 4]], keys, depth=3,
                             spec=alg.deepwalk(), max_degree=g.max_degree(), device="cpu")
walks, stats = oom_random_walk(partition_by_vertex_range(g, 4), 200, list(range(16)),
                               PRNGKey(1), depth=3, spec=alg.biased_random_walk(),
                               max_degree=g.max_degree(), device="cpu")
from repro_torch.serve import SamplingService, StreamingSamplingService
svc = SamplingService(g, device="cpu", key=PRNGKey(4))
ids = [svc.submit([i, i + 1, i + 2], depth=3, spec=spec)
       for i, spec in enumerate((alg.deepwalk(), alg.deepwalk(), alg.weighted_random_walk()))]
served = svc.drain()
drained_launches = svc.stats.launches
with StreamingSamplingService(svc) as stream:
    streamed = stream.submit([5, 6], depth=3, spec=alg.deepwalk()).result(timeout=60)
from repro_torch.core.distributed import instance_parallel_walk
from repro_torch.shard import ShardMesh, sharded_random_walk
mesh = ShardMesh.on("cpu", 4)
sharded = sharded_random_walk(mesh, g, list(range(16)), PRNGKey(1), depth=3,
                              spec=alg.deepwalk(), max_degree=g.max_degree())
parallel = instance_parallel_walk(mesh, g, list(range(16)), PRNGKey(1), depth=3,
                                  spec=alg.deepwalk(), max_degree=g.max_degree())
shard_svc = SamplingService(g, mesh=mesh, key=PRNGKey(4))
shard_svc.submit([0, 1], depth=3, spec=alg.deepwalk())
shard_served = len(shard_svc.drain())
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline, build_walk_corpus
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM, loss_fn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import StepMonitor
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_step import make_train_step
lm_cfg = get_smoke_config("internlm2_1_8b")
lm = DecoderLM(lm_cfg, device="cpu")
corpus = build_walk_corpus(g, num_walks=4, walk_length=8, vocab_size=lm_cfg.vocab_size,
                           device="cpu")
lm_step = make_train_step(lm_cfg, OptConfig(), device="cpu")
_, _, lm_metrics = lm_step(lm, opt_init(OptConfig(), dict(lm.named_parameters())), 0,
                           TokenPipeline(lm_cfg.vocab_size, 4, 8, corpus=corpus).next())
import tempfile
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as launch_mesh, train as launch_train
from repro_torch.launch import cost as launch_cost, dryrun as launch_dryrun, shapes as launch_shapes
with tempfile.TemporaryDirectory() as ckpt:
    launched = launch_train.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                                  "--steps", "1", "--batch", "2", "--seq", "8",
                                  "--ckpt-dir", ckpt])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "walked": walked, "sampled": int(sample.num_edges.sum()),
                  "fused": int(fused.sampled_edges.sum()), "oom": stats.sampled_edges,
                  "served": sorted(served) == ids, "launches": drained_launches,
                  "streamed": streamed.sampled_edges,
                  "sharded": int(sharded.sampled_edges), "parallel": int(parallel.sampled_edges),
                  "shard_served": shard_served, "lm_loss": float(lm_metrics["loss"]),
                  "launched": launched["losses"]}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _ISOLATION_CHILD], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["walked"] == 4  # every mode walked
    assert res["sampled"] > 0  # and traversal sampled
    assert res["fused"] > 0 and res["oom"] > 0  # and the segment and out-of-memory walks
    assert res["served"] and res["launches"] == 2  # the service fused its two deepwalks
    assert res["streamed"] > 0  # and the streaming service delivered one
    assert res["sharded"] > 0 and res["parallel"] > 0  # the sharded and instance-parallel walks
    assert res["shard_served"] == 1  # and the sharded service
    assert 0 < res["lm_loss"] < 10  # and the LM harness took a step on a walk corpus
    assert len(res["launched"]) == 1 and 0 < res["launched"][0] < 10  # and the launcher
