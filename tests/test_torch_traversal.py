"""The port's traversal sampling against the JAX package: ``traversal_sample``
for every algorithm and selection method, with and without the visited map,
against ``repro``'s reference backend (and, for ``its_brs``, its Pallas
backend in interpret mode); the without-replacement selection methods
against ``repro.core.select``; the pool insertion against the reference's;
and ``its_select``'s plain version at rows wider than 4,096 and at more
than 32 draws against ``its_select_pallas`` in interpret mode.  The CUDA
kernels are held against these plain versions on the card in
``test_torch_cuda.py``.

All comparisons are exact: sampled edges, counts, pools, indices and the
Fig. 11/12 counters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import backend as jbk  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import select as jsel  # noqa: E402
from repro.graph import powerlaw_graph  # noqa: E402
from repro.kernels.its_select import its_select_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import backend as tbk  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import select as tsel  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402

TRAVERSAL = ["neighbor_unbiased", "neighbor_biased", "forest_fire", "layer", "snowball", "mdrw"]
METHODS = ["its_brs", "repeated", "updated", "gumbel"]
V = 400  # max degree 19: every neighbor_size of the zoo fits a row (gumbel's top-k)


@functools.lru_cache(maxsize=None)
def _graphs():
    g = powerlaw_graph(V, seed=3, weighted=True)
    tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                         device="cpu")
    return g, tg, int(np.diff(np.asarray(g.indptr)).max())


def _pools(n: int = 10) -> np.ndarray:
    pools = np.random.default_rng(0).integers(0, V, (n, 2)).astype(np.int32)
    pools[0, 1] = -1  # a pool with one seed
    pools[1, :] = -1  # an empty pool: nothing is ever sampled
    return pools


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _assert_same(want, got):
    for field, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)


def _kw(method, max_vertices, depth):
    return dict(depth=depth, max_degree=_graphs()[2], pool_capacity=24, method=method,
                max_vertices=max_vertices)


@functools.lru_cache(maxsize=None)
def _reference(name, method, max_vertices, backend, depth):
    """``repro``'s sample, computed once for the module's tests."""
    return jeng.traversal_sample(_graphs()[0], jnp.asarray(_pools()), jax.random.PRNGKey(5),
                                 spec=jalg.ALGORITHMS[name](), backend=backend,
                                 **_kw(method, max_vertices, depth))


def _run_both(name, method, max_vertices, backend, depth):
    want = _reference(name, method, max_vertices, backend, depth)
    got = teng.traversal_sample(_graphs()[1], _pools(), _kd(jax.random.PRNGKey(5)),
                                spec=talg.ALGORITHMS[name](), device="cpu",
                                **_kw(method, max_vertices, depth))
    return want, got


# ---------------------------------------------------------------------------
# traversal_sample: every algorithm x method, with and without visited
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_vertices", [0, V])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", TRAVERSAL)
def test_traversal_equals_reference(name, method, max_vertices):
    want, got = _run_both(name, method, max_vertices, "reference", depth=3)
    _assert_same(want, got)
    if name != "mdrw":
        assert int(got.num_edges.sum()) > 0


@pytest.mark.parametrize("max_vertices", [0, V])
@pytest.mark.parametrize("name", TRAVERSAL)
def test_traversal_its_brs_equals_pallas_backend(name, max_vertices):
    want, got = _run_both(name, "its_brs", max_vertices, "pallas", depth=2)
    _assert_same(want, got)


@pytest.mark.parametrize("name", ["neighbor_biased", "layer", "forest_fire"])
def test_traversal_in_blocks_of_one_instance(name, monkeypatch):
    """The dense context in blocks of one instance selects what the whole
    batch selects: each block draws the batch's bits at its rows."""
    monkeypatch.setattr(teng, "TRAVERSAL_ELEMS", 1)
    want, got = _run_both(name, "its_brs", V, "reference", depth=3)
    _assert_same(want, got)


def test_traversal_with_fewer_visited_slots_than_vertices():
    """A visited map narrower than the graph: ids past it read as visited,
    as the reference's out-of-bounds gather fills them."""
    want, got = _run_both("neighbor_unbiased", "its_brs", V // 2, "reference", depth=3)
    _assert_same(want, got)


def test_sampled_edges_are_graph_edges_and_never_repeat():
    g, tg, md = _graphs()
    ip, ind = np.asarray(g.indptr), np.asarray(g.indices)
    edges = {(a, b) for a in range(V) for b in ind[ip[a]:ip[a + 1]]}
    res = teng.traversal_sample(tg, _pools(16), np.array([0, 9], np.uint32), depth=3,
                                spec=talg.unbiased_neighbor_sampling(2, 4), max_degree=md,
                                pool_capacity=64, max_vertices=V, device="cpu")
    src, dst = res.edges_src.numpy(), res.edges_dst.numpy()
    for s_row, d_row in zip(src, dst):
        picked = d_row[d_row >= 0]
        assert len(set(picked.tolist())) == picked.size
        assert all((s, d) in edges for s, d in zip(s_row[d_row >= 0], picked))
    assert kernels.launch_counts()["its_select"] == 0  # CPU tensors: the plain version


def test_traversal_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, md = _graphs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.traversal_sample(tg, _pools(), np.array([0, 1], np.uint32), depth=1,
                              spec=talg.layer_sampling(), max_degree=md, pool_capacity=8)


# ---------------------------------------------------------------------------
# selection without replacement, the pool insertion
# ---------------------------------------------------------------------------


def _select_case(n, p, k, seed):
    rng = np.random.default_rng(seed)
    b = (rng.random((n, p)) * (rng.random((n, p)) > 0.3)).astype(np.float32)
    b[0] = 0.0
    b[1] = 0.0
    b[1, [2, p - 1]] = 1.0
    b[2] = 1.0
    mask = rng.random((n, p)) > 0.1
    return b, mask


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,p,k", [(8, 128, 4), (13, 100, 3), (5, 37, 2), (6, 700, 40)])
def test_select_without_replacement_equals_reference(method, n, p, k):
    b, mask = _select_case(n, p, k, n * p + k)
    key = jax.random.PRNGKey(n * p + k)
    want = jsel.select_without_replacement(key, jnp.asarray(b), jnp.asarray(mask), k,
                                           method=method, max_iters=8)
    got = tsel.select_without_replacement(_kd(key), torch.from_numpy(b),
                                          torch.from_numpy(mask), k, method=method, max_iters=8)
    for field in ("indices", "valid", "iters", "searches"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert not got.fell_back


@pytest.mark.parametrize("n,p,k", [(8, 128, 4), (13, 100, 3), (5, 37, 2), (32, 256, 8)])
def test_backend_its_brs_equals_both_reference_backends(n, p, k):
    """The port's dispatcher (kernel over lane-padded rows, counted budget)
    equals ``repro``'s reference retry loop and its Pallas path, batched
    over two leading dimensions."""
    b, mask = _select_case(n, p, k, 7 * n + p)
    b3, m3 = b.reshape(1, n, p), mask.reshape(1, n, p)
    key = jax.random.PRNGKey(p)
    got = tbk.select_without_replacement(_kd(key), torch.from_numpy(b3), torch.from_numpy(m3), k,
                                         max_iters=8)
    for backend in ("reference", "pallas"):
        want = jbk.select_without_replacement(key, jnp.asarray(b3), jnp.asarray(m3), k,
                                              method="its_brs", backend=backend, max_iters=8)
        for field in ("indices", "valid", "iters", "searches"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)


def test_select_rows_in_blocks_draw_the_batch_bits():
    b, mask = _select_case(12, 100, 5, 3)
    key = np.array([0, 11], np.uint32)
    for method in METHODS:
        whole = tsel.select_without_replacement(key, torch.from_numpy(b), torch.from_numpy(mask),
                                                5, method=method)
        parts = [tsel.select_without_replacement(key, torch.from_numpy(b[s:s + 5]),
                                                 torch.from_numpy(mask[s:s + 5]), 5,
                                                 method=method, offset=s)
                 for s in range(0, 12, 5)]
        for i, field in enumerate(("indices", "valid", "iters", "searches")):
            np.testing.assert_array_equal(torch.cat([q[i] for q in parts]).numpy(),
                                          whole[i].numpy(), err_msg=f"{method} {field}")


def test_retry_randoms_equals_reference():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsel.retry_randoms(key, (4, 3), 5, 7))
    got = tsel.retry_randoms(_kd(key), (4, 3), 5, 7)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("cap,width", [(8, 5), (6, 12), (16, 3)])
def test_insert_into_pool_equals_reference(cap, width):
    rng = np.random.default_rng(cap * width)
    pool = rng.integers(0, 50, (9, cap)).astype(np.int32)
    pool[rng.random(pool.shape) < 0.4] = -1
    new = rng.integers(0, 50, (9, width)).astype(np.int32)
    new[rng.random(new.shape) < 0.3] = -1
    pool[0] = np.arange(cap)  # a full pool: every new vertex overflows
    want = np.asarray(jeng._insert_into_pool(jnp.asarray(pool), jnp.asarray(new)))
    got = teng._insert_into_pool(torch.from_numpy(pool), torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# its_select's plain version past the warp kernel's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("p", [4097, 20_000])
def test_its_select_plain_matches_pallas_on_wide_rows(p, k):
    rng = np.random.default_rng(p + k)
    n, iters = 8, 8
    b = np.zeros((n, p), np.float32)
    for i in range(n):  # few candidates a row: dense collisions
        at = rng.choice(p, size=int(rng.integers(1, 3 * k)), replace=False)
        b[i, at] = rng.random(at.size).astype(np.float32) + 0.01
    b[0] = 0.0
    b[1] = rng.random(p).astype(np.float32)  # every entry a candidate
    r = rng.random((n, iters, k)).astype(np.float32)
    want_idx, want_stats = its_select_pallas(jnp.asarray(b), jnp.asarray(r), interpret=True,
                                             with_stats=True)
    got_idx, got_stats = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))
    assert (np.asarray(want_stats)[:, 0] > 1).any()


def test_its_brs_follows_the_pallas_backend_on_unaligned_wide_rows():
    """``repro``'s reference loop scans a row as it is, its Pallas path the
    row padded to 128 lanes; past 256 entries XLA's blocked scan rounds the
    two totals apart in about a quarter of rows, and a pick now and then.
    The port's its_brs runs the padded path on every device, so on the rows
    where the two JAX backends part it equals the Pallas backend (run here
    on those rows alone, with the batch's counted bits), and its plain loop
    equals the reference (ROADMAP.md queue 3 item 4)."""
    rng = np.random.default_rng(1)
    for p in (300, 700):  # the rows drawn before the P = 1,000 batch
        rng.random((20000, p)), rng.random((20000, p))
    b = (rng.random((20000, 1000)) * (rng.random((20000, 1000)) > 0.2)).astype(np.float32)
    bt, key = torch.from_numpy(b), np.array([0, 3], np.uint32)
    loop = tsel.select_without_replacement(key, bt, None, 8)
    padded = tbk.select_without_replacement(key, bt, None, 8)
    rows = torch.nonzero((loop.indices != padded.indices).any(dim=-1)).squeeze(1).tolist()
    assert rows  # the backends part on some rows of this batch
    assert torch.equal(loop.iters, padded.iters) and torch.equal(loop.searches, padded.searches)
    # repro's Pallas backend on those rows: the lane-padded rows and the
    # rows' share of the batch's counted retry budget
    rands = np.asarray(jsel.retry_randoms(jnp.asarray(key), (20000,), 32, 8))[rows]
    want_idx, want_stats = its_select_pallas(jbk.pad_lanes(jnp.asarray(b[rows])),
                                             jnp.asarray(rands), interpret=True, with_stats=True)
    got = [tbk.select_without_replacement(key, bt[i:i + 1], None, 8, offset=i) for i in rows]
    np.testing.assert_array_equal(torch.cat([r.indices for r in got]).numpy(),
                                  np.asarray(want_idx))
    np.testing.assert_array_equal(torch.cat([r.iters for r in got]).numpy(),
                                  np.asarray(want_stats)[:, 0])
    np.testing.assert_array_equal(torch.cat([r.searches for r in got]).numpy(),
                                  np.asarray(want_stats)[:, 1])
    np.testing.assert_array_equal(padded.indices[rows].numpy(), np.asarray(want_idx))
    last = max(rows) + 1
    want = jbk.select_without_replacement(jnp.asarray(key), jnp.asarray(b[:last]), None, 8,
                                          method="its_brs", backend="reference")
    np.testing.assert_array_equal(loop.indices[:last].numpy(), np.asarray(want.indices))
    assert not np.array_equal(np.asarray(want.indices)[rows], np.asarray(want_idx))


def _dipping_rows():
    """Rows whose every 16-block after the first starts with a zero bias.
    Past 256 entries the scan's right-nested association leaves the start
    of such a block a few ulps below the end of the block before, so the
    CTPS steps down there.  Returns the rows, one step-down ``(row, q)``
    and the CTPS value there."""
    rng = np.random.default_rng(0)
    b = rng.random((64, 512)).astype(np.float32) * np.exp2(rng.uniform(-8, 8, (64, 512)))
    b = b.astype(np.float32)
    b[:, 16::16] = 0.0
    ctps = tsel.build_ctps(torch.from_numpy(b))
    down = torch.nonzero(ctps[:, 1:] < ctps[:, :-1])
    assert len(down)  # the CTPS is not nondecreasing on these rows
    i, q = int(down[0, 0]), int(down[0, 1]) + 1
    return b, i, q, ctps[i, q]


def test_its_search_counts_bounds_where_the_ctps_steps_down():
    """``its_search`` is the count of CTPS entries ``<= r``, also on rows
    where the scan's rounding makes the CTPS step down: at ``r`` equal to
    a stepped-down entry the count and a binary search part."""
    b, i, q, at = _dipping_rows()
    ctps = tsel.build_ctps(torch.from_numpy(b))
    r = torch.stack([ctps[:, q], ctps[:, q - 1], ctps[:, q] * 0.5], dim=-1)
    r[i, 0] = at
    want = jsel.its_search(jsel.build_ctps(jnp.asarray(b)), jnp.asarray(r.numpy()))
    got = tsel.its_search(ctps, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[i, 0]) != int(torch.searchsorted(ctps[i], at.reshape(1), right=True))


def _stepping_case(seed: int, n: int, p: int, k: int, iters: int):
    """Rows whose 16-blocks start with zero biases, and a budget whose first
    round draws sit on the entries where the CTPS steps down (and on the
    entries just before them), where a binary search and the count part."""
    rng = np.random.default_rng(seed)
    b = (rng.random((n, p)) * np.exp2(rng.uniform(-8, 8, (n, p)))).astype(np.float32)
    b[:, 16::16] = 0.0
    b[: n // 4, p // 5: p // 2] = 0.0  # a long run of zeros
    r = rng.random((n, iters, k)).astype(np.float32)
    ctps = tsel.build_ctps(torch.from_numpy(b)).numpy()
    for i in range(n):
        down = np.nonzero(ctps[i, 1:] < ctps[i, :-1])[0]
        at = np.concatenate([ctps[i, down + 1], ctps[i, down]])
        if at.size:
            r[i, 0] = rng.choice(at, k)
    return b, r


@pytest.mark.parametrize("k", [1, 8, 40])
@pytest.mark.parametrize("p", [512, 4097])
def test_its_select_plain_matches_pallas_where_the_ctps_steps_down(p, k):
    b, r = _stepping_case(p + k, 16, p, k, 4)
    want_idx, want_stats = its_select_pallas(jnp.asarray(b), jnp.asarray(r), interpret=True,
                                             with_stats=True)
    got_idx, got_stats = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))
