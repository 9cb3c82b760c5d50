"""The port's examples against ``repro``'s: ``examples/quickstart_torch.py``
and ``examples/graphsaint_gcn_torch.py`` give ``quickstart.py``'s and
``graphsaint_gcn.py``'s walks, samples and counters bit for bit on the CPU,
and the GCN's losses within f32 rounding."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.core.api import SamplingSpec as JSamplingSpec  # noqa: E402
from repro.core.engine import random_walk as j_random_walk  # noqa: E402
from repro.core.engine import traversal_sample as j_traversal_sample  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
#: the GCN's loss a round and its weights after three rounds, from the same
#: weights: f32 products in another association (measured worst: loss
#: 8.5e-8 relative, weights 1.5e-8 of a scale of 0.39)
GCN_LOSS_RTOL = 1e-5


def example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- quickstart ---------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    """The port's quickstart on the CPU at 256 seeds and 64 pools."""
    return example("quickstart_torch").run("cpu", num_seeds=256, num_pools=64)


@pytest.fixture(scope="module")
def reference_graph():
    g = j_powerlaw_graph(20_000, exponent=2.1, seed=0, weighted=True)
    return g, jax.random.PRNGKey(0), min(g.max_degree(), 512)


@pytest.mark.parametrize("name", ["deepwalk", "biased_rw", "node2vec", "custom_hot"])
def test_quickstart_walks_equal_reference(quickstart, reference_graph, name):
    g, key, md = reference_graph
    seeds = jax.random.randint(key, (256,), 0, g.num_vertices)
    if name == "custom_hot":
        spec = JSamplingSpec(edge_bias=lambda ctx: jnp.square(ctx.weight), name="custom_hot",
                             track_visited=False)
        want = j_random_walk(g, seeds, key, depth=16, spec=spec, max_degree=md)
    else:
        want = j_random_walk(g, seeds, key, depth=32, spec=jalg.ALGORITHMS[name](),
                             max_degree=md)
    got = quickstart[name]
    np.testing.assert_array_equal(got.walks.numpy(), np.asarray(want.walks))
    assert int(got.sampled_edges) == int(want.sampled_edges)


def test_quickstart_neighbor_sampling_equals_reference(quickstart, reference_graph):
    g, key, md = reference_graph
    pools = jax.random.randint(key, (64, 1), 0, g.num_vertices)
    want = j_traversal_sample(g, pools, key, depth=3, spec=jalg.biased_neighbor_sampling(),
                              max_degree=md, pool_capacity=256, max_vertices=g.num_vertices)
    got = quickstart["neighbor"]
    for field in ("edges_src", "edges_dst", "num_edges", "frontier_pool", "iters", "searches"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.iters) > 0


# -- GraphSAINT ----------------------------------------------------------------

@pytest.fixture(scope="module")
def saint():
    return example("graphsaint_gcn_torch"), example("graphsaint_gcn")


def test_sbm_graph_is_reference_s(saint):
    port, ref = saint
    g, labels = port.sbm_graph(device="cpu")
    jg, jlabels = ref.sbm_graph()
    np.testing.assert_array_equal(labels, jlabels)
    for field in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(g, field).numpy(), np.asarray(getattr(jg, field)))
    np.testing.assert_array_equal(port.norm_adj(g), np.asarray(ref.norm_adj(jg)))


def test_graphsaint_rounds_equal_reference(saint):
    """Three rounds from ``repro``'s initial ``w1`` and ``w2``: each round's
    sampled vertex set bit for bit, its loss within f32 rounding, and the
    weights after them."""
    port, ref = saint
    jg, labels = ref.sbm_graph()
    n, k = jg.num_vertices, int(labels.max() + 1)
    # graphsaint_gcn.py's features, as its main() draws them
    rs = np.random.default_rng(1)
    feats = rs.normal(0, 1, (n, 32)).astype(np.float32)
    feats[:, :4] += np.eye(4, dtype=np.float32)[labels] * 1.5
    np.testing.assert_array_equal(port.features(labels), feats)
    x = jnp.asarray(feats)
    y = jnp.asarray(labels)
    adj = ref.norm_adj(jg)
    key = jax.random.PRNGKey(0)
    params = {"w1": jax.random.normal(key, (32, 64)) * 0.1,
              "w2": jax.random.normal(jax.random.fold_in(key, 1), (64, k)) * 0.1}
    spec = jalg.multi_dimensional_random_walk(frontier_size=1)

    def loss_fn(p, mask):
        ce = -jax.nn.log_softmax(ref.gcn_forward(p, adj, x))[jnp.arange(n), y]
        return jnp.sum(ce * mask) / jnp.maximum(mask.sum(), 1)

    got = port.train(port.sbm_graph(device="cpu")[0], labels,
                     {name: np.asarray(w) for name, w in params.items()},
                     rounds=3, device="cpu")
    for r in range(3):
        kkey = jax.random.fold_in(key, r)
        pools = jax.random.randint(kkey, (16, 8), 0, n)
        res = j_traversal_sample(jg, pools, kkey, depth=24, spec=spec,
                                 max_degree=int(jg.max_degree()), pool_capacity=16)
        nodes = np.unique(np.concatenate([np.asarray(res.edges_src).ravel(),
                                          np.asarray(res.edges_dst).ravel()]))
        nodes = nodes[nodes >= 0]
        np.testing.assert_array_equal(got["nodes"][r], nodes)
        mask = np.zeros(n, np.float32)
        mask[nodes] = 1.0
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(mask))
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads)
        np.testing.assert_allclose(got["loss"][r], float(loss), rtol=GCN_LOSS_RTOL)
    for name, w in params.items():
        np.testing.assert_allclose(got["params"][name].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)


def test_examples_raise_without_a_card(monkeypatch, saint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example("quickstart_torch").run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        saint[0].sbm_graph()
    serve = example("serve_batch_torch")
    for argv in ([], ["--lm"], ["--stream"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)
