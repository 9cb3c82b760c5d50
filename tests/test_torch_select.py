"""The port's graph builders, selection tables, flat draws, chunked ITS tail
and method planner against the JAX package, on CPU (exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import backend as jbk  # noqa: E402
from repro.core import methods as jmt  # noqa: E402
from repro.core import select as jsel  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import backend as tbk  # noqa: E402
from repro_torch.core import methods as tmt  # noqa: E402
from repro_torch.core import select as tsel  # noqa: E402
from repro_torch.core.rng import key_from_array  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _port(g):
    return csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                           device="cpu")


def _star(hub_degree: int = 600, seed: int = 3):
    """A hub joined to every leaf, leaves on a ring: every tail runs."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, hub_degree + 1)
    src = np.concatenate([np.zeros(hub_degree, np.int64), leaves])
    dst = np.concatenate([leaves, np.roll(leaves, 1)])
    w = rng.random(src.size).astype(np.float32) + 0.1
    return j_csr_from_edges(hub_degree + 1, src, dst, weights=w, symmetrize=True)


@pytest.mark.parametrize("name,args,kwargs", [
    ("rmat_graph", (9,), dict(edge_factor=8, seed=7, weighted=True)),
    ("powerlaw_graph", (500,), dict(seed=1, weighted=True)),
    ("erdos_renyi_graph", (300, 6.0), dict(seed=2, weighted=False)),
])
def test_generators_give_identical_csr(name, args, kwargs):
    jg = getattr(jgen, name)(*args, **kwargs)
    tg = getattr(tgen, name)(*args, device="cpu", **kwargs)
    for name in ("indptr", "indices", "weights"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tg.max_degree() == jg.max_degree()


@pytest.mark.parametrize("bias", ["weights", "degree", "sparse"])
def test_alias_and_row_max_tables_identical(bias):
    g = jgen.powerlaw_graph(400, seed=5, weighted=True)
    indptr = np.asarray(g.indptr)
    b = np.asarray(g.weights)
    if bias == "degree":
        b = np.diff(indptr)[np.asarray(g.indices)].astype(np.float32)
    elif bias == "sparse":
        b = np.where(np.arange(b.size) % 3 == 0, 0.0, b).astype(np.float32)
    for ref_t, got_t in zip(jsel.build_alias(indptr, b), tsel.build_alias(indptr, b)):
        assert ref_t.dtype == got_t.dtype
        np.testing.assert_array_equal(ref_t, got_t)
    np.testing.assert_array_equal(jsel.build_row_max(indptr, b), tsel.build_row_max(indptr, b))


def _assert_alias_equal(indptr, b):
    for ref_t, got_t in zip(jsel.build_alias(indptr, b), tsel.build_alias(indptr, b)):
        assert ref_t.dtype == got_t.dtype
        assert np.array_equal(ref_t, got_t)


def _csr(rows):
    indptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    return indptr, np.asarray([x for r in rows for x in r], dtype=np.float32)


def test_alias_build_equals_reference_on_drawn_rows():
    """Rows with zeros, small-integer weights that scale to exactly 1.0,
    all-equal rows, empty and zero-total rows, and wide float spreads."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    value = st.one_of(st.sampled_from([0.0, 1.0, 2.0, 3.0]),
                      st.floats(0.0, 1024.0, width=32), st.floats(2.0**-20, 2.0**-10, width=32))
    row = st.one_of(st.lists(value, max_size=40),
                    st.tuples(st.floats(0.0, 5.0, width=32), st.integers(0, 40)).map(
                        lambda t: [t[0]] * t[1]))

    @settings(max_examples=200, deadline=None)
    @given(st.lists(row, min_size=1, max_size=12))
    def check(rows):
        _assert_alias_equal(*_csr(rows))

    check()


def test_alias_build_equals_reference_on_powerlaw_graph():
    g = jgen.powerlaw_graph(256, seed=1, weighted=True)
    _assert_alias_equal(np.asarray(g.indptr), np.asarray(g.weights))


@pytest.mark.parametrize("hub_degree", [2000, 5000])
def test_alias_build_equals_reference_on_skewed_hubs(hub_degree):
    rng = np.random.default_rng(hub_degree)
    w = (rng.pareto(1.2, hub_degree) * (rng.random(hub_degree) > 0.2)).astype(np.float32)
    rows = [w.tolist(), [], [0.0, 0.0], rng.random(7).tolist(), w[::-1].tolist()]
    _assert_alias_equal(*_csr(rows))


@pytest.mark.parametrize("cap", [None, 128])
def test_flat_draws_equal_reference(cap):
    """The uncapped (tail) and capped alias and rejection draws of the
    kernels' plain versions against ``repro``'s flat draws."""
    g = _star()
    indptr, bias = np.asarray(g.indptr), np.asarray(g.weights)
    prob, alias = jsel.build_alias(indptr, bias)
    row_max = jsel.build_row_max(indptr, bias)
    rng = np.random.default_rng(0)
    cur = rng.integers(-1, g.num_vertices, 64).astype(np.int32)
    cur[:8] = 0  # the hub
    safe = np.maximum(cur, 0)
    starts = indptr[safe].astype(np.int32)
    degs = np.where(cur >= 0, indptr[safe + 1] - indptr[safe], 0).astype(np.int32)
    rm = np.where(cur >= 0, row_max[safe], 0).astype(np.float32)
    key = jax.random.PRNGKey(4)
    r = np.asarray(jax.random.uniform(key, (64,)))
    rej = np.asarray(jsel.rejection_randoms(jax.random.fold_in(key, 2), (64,)))
    ja = jsel.alias_draw_flat(jnp.asarray(starts), jnp.asarray(degs), jnp.asarray(prob),
                              jnp.asarray(alias), g.indices, jnp.asarray(r), cap=cap)
    jr = jsel.rejection_draw_flat(jnp.asarray(starts), jnp.asarray(degs), g.weights,
                                  jnp.asarray(rm), g.indices, jnp.asarray(rej), cap=cap)
    t = torch.from_numpy
    ta = ref.alias_step_block_ref(t(starts), t(degs), t(np.array(g.indices)), t(prob), t(alias),
                                  t(r.copy()), seg=cap)
    tr = ref.reject_step_block_ref(t(starts), t(degs), t(np.array(g.indices)), t(bias.copy()),
                                   t(rm), t(rej.copy()), seg=cap)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_row_sum_matches_jnp_sum():
    rng = np.random.default_rng(8)
    x = (rng.random((96, 512)) * rng.choice([1e-2, 1.0, 3e4], (96, 1))).astype(np.float32)
    x[np.arange(512)[None, :] >= rng.integers(1, 513, 96)[:, None]] = 0.0
    ref_sum = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(tsel.row_sum(torch.from_numpy(x)).numpy()), _bits(ref_sum))


@pytest.mark.parametrize("hub_degree", [600, 1100])
def test_walk_transition_chunked_equal(hub_degree):
    g = _star(hub_degree, seed=hub_degree)
    rng = np.random.default_rng(hub_degree)
    cur = np.zeros(48, np.int32)
    cur[24:] = rng.integers(1, g.num_vertices, 24)
    key = jax.random.PRNGKey(hub_degree)
    ref_off = jsel.walk_transition_chunked(key, g.indptr, g.weights, jnp.asarray(cur))
    tg = _port(g)
    got = tsel.walk_transition_chunked(key_from_array(jax.random.key_data(key)), tg.indptr,
                                       tg.weights, torch.from_numpy(cur))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_off))


@pytest.mark.parametrize("max_degree", [14, 200, 600, 5000])
def test_walk_bucket_plan_equal(max_degree):
    assert tbk.walk_bucket_plan(max_degree) == jbk.walk_bucket_plan(max_degree)


@pytest.mark.parametrize("spec", ["deepwalk", "weighted_random_walk", "biased_random_walk"])
@pytest.mark.parametrize("override", [None, "alias", "rejection"])
def test_method_plans_and_tables_equal(spec, override):
    from repro.core import algorithms as jalg

    g = _star()
    tg = _port(g)
    buckets, use_chunked = jbk.walk_bucket_plan(g.max_degree())
    j_methods, j_tables = jmt.plan_for_graph(
        g, getattr(jalg, spec)().transition.bias.fn, buckets=buckets,
        use_chunked=use_chunked, override=override)
    t_methods, t_tables = tmt.plan_for_graph(
        tg, getattr(talg, spec)().transition.bias.fn, buckets=buckets,
        use_chunked=use_chunked, override=override)
    assert t_methods == j_methods
    assert tmt.describe_plan(t_methods, buckets, use_chunked) == jmt.describe_plan(
        j_methods, buckets, use_chunked)
    for name in ("prob", "alias", "row_max"):
        a, b = getattr(j_tables, name), getattr(t_tables, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_plan_cache_follows_graph_across_devices():
    """``CSRGraph.to`` keeps the graph's identity: one plan-cache entry."""
    tmt.clear_plan_cache()
    tg = _port(_star())
    buckets, use_chunked = tbk.walk_bucket_plan(tg.max_degree())
    fn = talg.deepwalk().transition.bias.fn
    tmt.plan_for_graph(tg, fn, buckets=buckets, use_chunked=use_chunked)
    tmt.plan_for_graph(tg.to("cpu"), fn, buckets=buckets, use_chunked=use_chunked)
    assert len(tmt._PLAN_CACHE) == 1
