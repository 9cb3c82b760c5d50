"""``examples/serve_batch_torch.py`` against ``examples/serve_batch.py``'s
services on the CPU: the same burst of requests gives ``repro``'s walks in
the in-memory and out-of-memory modes, the sharded and streaming modes serve
every request, and ``--lm`` decodes ``repro``'s greedy tokens from the same
weights."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro.graph.partition import partition_by_vertex_range as j_partition  # noqa: E402
from repro.models import init_cache, init_params  # noqa: E402
from repro.models.layers import set_activation_mesh  # noqa: E402
from repro.serve import SamplingService as JSamplingService  # noqa: E402
from repro.serve import ServiceConfig as JServiceConfig  # noqa: E402
from repro.train.train_step import make_serve_step  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_batch_torch.py"
REQUESTS = 6


@pytest.fixture(scope="module")
def serve():
    spec = importlib.util.spec_from_file_location("serve_batch_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_graph():
    return j_powerlaw_graph(20_000, exponent=2.1, seed=0, weighted=True)


def reference_burst(svc, num_vertices: int) -> dict:
    """``serve_batch.py``'s burst of mixed requests, submitted to ``svc``."""
    rng = np.random.default_rng(3)
    specs = [jalg.deepwalk(), jalg.weighted_random_walk(), jalg.node2vec()]
    tickets = {}
    for i in range(REQUESTS):
        spec = specs[i % len(specs)]
        n = int(rng.integers(16, 129))
        depth = int(rng.choice([8, 12, 16, 24, 32]))
        seeds = rng.integers(0, num_vertices, n)
        tickets[svc.submit(seeds, depth=depth, spec=spec)] = (spec.name, n, depth)
    return tickets


def assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid].walks, np.asarray(w.walks), err_msg=str(rid))
        np.testing.assert_array_equal(got[rid].lengths, np.asarray(w.lengths))
        assert got[rid].sampled_edges == int(w.sampled_edges)


def test_in_memory_mode_equals_reference(serve, reference_graph):
    svc, got, tickets = serve.run_sampling_service(
        serve.parse_args(["--device", "cpu", "--requests", str(REQUESTS)]))
    jsvc = JSamplingService(reference_graph, backend="reference", config=JServiceConfig())
    assert reference_burst(jsvc, reference_graph.num_vertices) == tickets
    assert_same_results(got, jsvc.drain())
    assert svc.stats.launches == jsvc.stats.launches
    assert svc.stats.padded_walker_slots == jsvc.stats.padded_walker_slots


def test_oom_mode_equals_reference(serve, reference_graph):
    svc, got, _ = serve.run_sampling_service(
        serve.parse_args(["--device", "cpu", "--requests", str(REQUESTS), "--oom"]))
    jsvc = JSamplingService(partitions=j_partition(reference_graph, 8),
                            total_vertices=reference_graph.num_vertices, backend="reference",
                            oom_memory_capacity=2, oom_chunk=256)
    reference_burst(jsvc, reference_graph.num_vertices)
    assert_same_results(got, jsvc.drain())
    assert svc.stats.oom_launches == jsvc.stats.oom_launches == 3


def test_sharded_and_streaming_modes_serve_every_request(serve, reference_graph):
    """Every request of the sharded burst is served with walks along graph
    edges; every streamed request completes without an error."""
    svc, got, tickets = serve.run_sampling_service(
        serve.parse_args(["--device", "cpu", "--requests", str(REQUESTS), "--sharded"]))
    assert sorted(got) == sorted(tickets) and svc.stats.sharded_launches >= 3
    indptr = np.asarray(reference_graph.indptr)
    indices = np.asarray(reference_graph.indices)
    for rid, (_, n, depth) in tickets.items():
        walks = got[rid].walks
        assert walks.shape == (n, depth + 1)
        for a, b in zip(walks[:, :-1].ravel(), walks[:, 1:].ravel()):
            if b >= 0:
                assert b in indices[indptr[a]:indptr[a + 1]]
    futs = serve.main(["--device", "cpu", "--stream", "--requests", "8", "--rate", "200"])
    assert len(futs) == 8 and all(f.exception(timeout=60) is None for f in futs)


def test_lm_mode_decodes_reference_tokens(serve):
    """``--lm`` from ``repro``'s ``init_params(PRNGKey(0))``: the greedy
    continuation of ``serve_batch.py``'s prompts, token for token."""
    args = serve.parse_args(["--device", "cpu", "--lm"])
    cfg = ref_smoke_config(args.arch)
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    max_len = args.prompt_len + args.tokens
    step, _ = make_serve_step(cfg, mesh, batch=args.batch, max_len=max_len)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (args.batch, args.prompt_len), 0,
                                 cfg.vocab_size)
    cache = init_cache(cfg, args.batch, max_len)
    for t in range(args.prompt_len):
        logits, cache = step(params, cache, prompts[:, t:t + 1])
    tok = jax.numpy.argmax(logits[:, -1:], axis=-1).astype(jax.numpy.int32)
    want = [np.asarray(tok)]
    for _ in range(args.tokens - 1):
        logits, cache = step(params, cache, tok)
        tok = jax.numpy.argmax(logits[:, -1:], axis=-1).astype(jax.numpy.int32)
        want.append(np.asarray(tok))
    set_activation_mesh(None)

    from repro_torch.configs import get_smoke_config
    port_cfg = get_smoke_config(args.arch)
    model = DecoderLM(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), port_cfg))
    got = serve.run_lm_demo(args, model=model)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
