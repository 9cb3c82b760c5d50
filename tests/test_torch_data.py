"""The port's data plane against ``repro.data``, bit for bit: the C-SAW walk
corpus (the paper's sampler feeding an LM) and the token pipeline; the
helpers ``graph.degrees`` and ``kernels.ops`` against ``repro``'s; and
``test_data.py``'s corpus contracts on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.data.walk_corpus import build_walk_corpus as ref_build_walk_corpus  # noqa: E402
from repro.graph import degrees as ref_degrees  # noqa: E402
from repro.graph import powerlaw_graph as ref_powerlaw_graph  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import TokenPipeline, build_walk_corpus  # noqa: E402
from repro_torch.graph import csr_from_arrays, degrees, powerlaw_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_init  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402


def _both(n, seed, weighted=False):
    g = ref_powerlaw_graph(n, seed=seed, weighted=weighted)
    return g, csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices),
                              np.asarray(g.weights), device="cpu")


@pytest.mark.parametrize("algorithm,kw,n,walks,length,seed", [
    ("deepwalk", {}, 200, 64, 10, 1),
    ("deepwalk", {}, 300, 33, 16, 7),
    ("node2vec", dict(p=4.0, q=0.25), 128, 16, 8, 0),
    ("node2vec", {}, 256, 40, 12, 3),
])
def test_walk_corpus_equals_reference(algorithm, kw, n, walks, length, seed):
    rg, tg = _both(n, seed=5 + seed, weighted=algorithm == "node2vec")
    want = ref_build_walk_corpus(rg, num_walks=walks, walk_length=length, algorithm=algorithm,
                                 seed=seed, vocab_size=512, **kw)
    got = build_walk_corpus(tg, num_walks=walks, walk_length=length, algorithm=algorithm,
                            seed=seed, vocab_size=512, device="cpu", **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_walk_corpus_max_degree_cut_equals_reference():
    """The example's ``max_degree=min(max_degree, 512)``, here cut below the
    graph's max degree so rows are truncated on both sides alike."""
    rg, tg = _both(2000, seed=2, weighted=True)
    md = min(rg.max_degree(), 128)
    kw = dict(num_walks=64, walk_length=12, seed=1, max_degree=md)
    np.testing.assert_array_equal(build_walk_corpus(tg, device="cpu", **kw),
                                  ref_build_walk_corpus(rg, **kw))


def test_sequences_are_graph_paths():
    g = powerlaw_graph(200, seed=5, device="cpu")
    corpus = build_walk_corpus(g, num_walks=64, walk_length=10, seed=1, device="cpu")
    assert corpus.shape == (64, 11) and (corpus >= 0).all()
    ip, ind = g.indptr.numpy(), g.indices.numpy()
    for row in corpus[:16]:
        for a, b in zip(row[:-1], row[1:]):
            if a != b:  # dead-end padding repeats the last vertex
                assert b in ind[ip[a]:ip[a + 1]]


def test_vocab_bound():
    g = powerlaw_graph(200, seed=5, device="cpu")
    assert build_walk_corpus(g, num_walks=16, walk_length=5, vocab_size=256,
                             device="cpu").max() < 256
    with pytest.raises(ValueError, match="vocabulary"):
        build_walk_corpus(g, num_walks=64, walk_length=5, vocab_size=8, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(seed=3),
    dict(seed=5, host_index=1, host_count=2),
    dict(corpus="walks"),
    dict(corpus="walks", host_index=1, host_count=4),
])
def test_pipeline_equals_reference(kw):
    """Ten batches of the synthetic stream and of a walk corpus (one epoch
    and past it), host shards included, and the state after them."""
    kw = dict(kw)
    if kw.get("corpus") == "walks":
        rg, _ = _both(200, seed=9)
        kw["corpus"] = ref_build_walk_corpus(rg, num_walks=20, walk_length=16, seed=4)
    mine, ref = TokenPipeline(256, 8, 16, **kw), RefPipeline(256, 8, 16, **kw)
    for _ in range(10):
        a, b = mine.next(), ref.next()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict()


@pytest.mark.parametrize("n", [64, 1000])
def test_degrees_equal_reference(n):
    rg, tg = _both(n, seed=1)
    got = degrees(tg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_degrees(rg)))


@pytest.mark.parametrize("shape,k,iters", [((5, 40), 3, 8), ((9, 200), 8, 4), ((3, 7), 7, 2)])
def test_ops_its_select_equals_reference(shape, k, iters):
    """The same key, the same (I, iters, K) uniforms, the same picks."""
    rs = np.random.default_rng(shape[1])
    b = (rs.random(shape) * (rs.random(shape) > 0.3)).astype(np.float32)
    key = jax.random.PRNGKey(k)
    want = ref_ops.its_select(key, jnp.asarray(b), k, iters=iters)
    got = ops.its_select(np.asarray(jax.random.key_data(key)), torch.from_numpy(b), k,
                         iters=iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,max_seg", [(0, 512), (1, 128), (2, 256)])
def test_ops_walk_step_equals_reference(seed, max_seg):
    """One ITS step of every walker (some finished, -1) under one key: the
    reference's kernel wrapper draws ``uniform(key, (W,))`` itself."""
    rg, tg = _both(400, seed=seed, weighted=True)
    assert rg.max_degree() <= max_seg
    rs = np.random.default_rng(seed)
    cur = rs.integers(-1, 400, 300).astype(np.int32)
    key = jax.random.PRNGKey(10 + seed)
    want = ref_ops.walk_step(key, rg, jnp.asarray(cur), max_seg=max_seg)
    got = ops.walk_step(np.asarray(jax.random.key_data(key)), tg, torch.from_numpy(cur),
                        max_seg=max_seg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any() and (got.numpy()[cur < 0] == -1).all()


def test_feeds_lm_training():
    """End-to-end: C-SAW walks -> pipeline -> LM loss drops, as the
    reference test runs it: ``xlstm_350m``'s smoke config (vocabulary 256)
    on a memorizable corpus of 8 fixed walks."""
    g = powerlaw_graph(200, seed=7, device="cpu")
    corpus = build_walk_corpus(g, num_walks=8, walk_length=16, seed=2, vocab_size=256,
                               device="cpu")
    cfg = get_smoke_config("xlstm_350m")
    pipe = TokenPipeline(cfg.vocab_size, 8, 16, corpus=corpus)
    ocfg = OptConfig(kind="adamw", lr=3e-3, warmup_steps=2)
    model = tm.DecoderLM(cfg, device="cpu")
    ostate = opt_init(ocfg, dict(model.named_parameters()))
    step_fn = make_train_step(cfg, ocfg, device="cpu")
    step, losses = 0, []
    for _ in range(30):
        ostate, step, m = step_fn(model, ostate, step, pipe.next())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses
