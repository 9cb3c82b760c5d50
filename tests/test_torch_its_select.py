"""The port's selection and window-step plain versions against the JAX
package: ``its_select`` against ``its_select_pallas`` (interpret mode, with
its ``(iters, searches)`` counters) and ``repro.kernels.ref.its_select_ref``;
``walk_step_window`` against ``walk_step_window_block_ref`` and
``walk_step_window_pallas``; the CTPS, the ITS draw, the chunked window tail
and the window bucket plans against ``repro.core``.  The CUDA kernels are
held against these plain versions on the card in ``test_torch_cuda.py``.

All comparisons are exact: indices, counters and float bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import backend as jbk  # noqa: E402
from repro.core import select as jsel  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.its_select import its_select_pallas  # noqa: E402
from repro.kernels.walk_step import pad_csr_for_kernel, walk_step_window_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import backend as tbk  # noqa: E402
from repro_torch.core import select as tsel  # noqa: E402
from repro_torch.core.rng import key_from_array  # noqa: E402
from repro_torch.graph import csr_from_arrays  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the scan at any width: XLA pads each level to whole 16-blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [14, 37, 600, 1000, 1152])
def test_padded_cumsum_matches_jnp_cumsum(width):
    rng = np.random.default_rng(width)
    x = (rng.random((24, width)) * rng.choice([1e-3, 1.0, 7e3], (24, 1))).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = 0.0
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(_bits(ref.padded_cumsum(_t(x)).numpy()), _bits(want))


# ---------------------------------------------------------------------------
# its_select: K of P without replacement, with the Fig. 11/12 counters
# ---------------------------------------------------------------------------


def _pools(seed: int, n: int, p: int, k: int, iters: int):
    """Pools with zero-bias lanes, empty pools, pools with fewer than K
    candidates and equal biases (many collisions)."""
    rng = np.random.default_rng(seed)
    b = (rng.random((n, p)) * (rng.random((n, p)) > 0.3)).astype(np.float32)
    b[0] = 0.0
    b[1, :] = 0.0
    b[1, [2, p - 1]] = 1.0  # two candidates
    b[2] = 1.0
    b[3, : p // 2] = -1.0  # negative biases are unselectable
    r = rng.random((n, iters, k)).astype(np.float32)
    return b, r


@pytest.mark.parametrize("k,iters", [(1, 1), (4, 8), (8, 12)])
@pytest.mark.parametrize("p", [100, 256])
def test_its_select_plain_matches_pallas_and_oracle(k, iters, p):
    b, r = _pools(p + k, 24, p, k, iters)
    want_idx, want_stats = its_select_pallas(jnp.asarray(b), jnp.asarray(r), interpret=True,
                                             with_stats=True)
    oracle = np.asarray(jref.its_select_ref(jnp.asarray(b), jnp.asarray(r)))
    np.testing.assert_array_equal(np.asarray(want_idx), oracle)
    got_idx, got_stats = kernels.its_select(_t(b), _t(r))
    assert got_idx.dtype == torch.int32 and got_stats.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), oracle)
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))
    # an empty pool fills nothing; a two-candidate pool fills at most two
    assert (got_idx[0] == -1).all()
    if k > 1:
        assert sorted(got_idx[1][got_idx[1] >= 0].tolist()) == [2, p - 1]


def test_its_select_counters_match_the_reference_retry_loop():
    """Stats equal ``select_without_replacement``'s while-loop counters (the
    same counted budget)."""
    b, _ = _pools(5, 16, 128, 6, 1)
    key = jax.random.PRNGKey(3)
    want = jsel.select_without_replacement(key, jnp.asarray(b), None, 6, max_iters=10)
    r = np.asarray(jsel.retry_randoms(key, (16,), 10, 6))
    idx, stats = kernels.its_select(_t(b), _t(r))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(stats[:, 0].numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(stats[:, 1].numpy(), np.asarray(want.searches))


@pytest.mark.parametrize("p", [14, 37, 600])
def test_select_with_replacement_equals_reference(p):
    rng = np.random.default_rng(p)
    b = (rng.random((40, p)) * (rng.random((40, p)) > 0.25)).astype(np.float32)
    mask = rng.random((40, p)) > 0.1
    b[0] = 0.0  # degenerate row: P - 1 like the reference
    key = jax.random.PRNGKey(p)
    want = np.asarray(jsel.select_with_replacement(key, jnp.asarray(b), jnp.asarray(mask), 1))
    tkey = key_from_array(jax.random.key_data(key))
    kernels.reset_launch_counts()
    got = tbk.select_with_replacement(tkey, _t(b), _t(mask), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == p - 1
    assert kernels.launch_counts()["its_select"] == 0  # CPU tensors: the plain version
    # k > 1 draws with replacement by the CTPS search, as the reference
    want3 = np.asarray(jsel.select_with_replacement(key, jnp.asarray(b), jnp.asarray(mask), 3))
    np.testing.assert_array_equal(tbk.select_with_replacement(tkey, _t(b), _t(mask), 3).numpy(),
                                  want3)


def test_build_ctps_bits_equal_reference():
    rng = np.random.default_rng(1)
    b = (rng.random((16, 37)) * 5 - 1).astype(np.float32)
    mask = rng.random((16, 37)) > 0.2
    want = np.asarray(jsel.build_ctps(jnp.asarray(b), jnp.asarray(mask)))
    np.testing.assert_array_equal(_bits(tsel.build_ctps(_t(b), _t(mask)).numpy()), _bits(want))


# ---------------------------------------------------------------------------
# walk_step_window: compact row-aligned bias rows vs the reference's operand
# ---------------------------------------------------------------------------


def _window_case(seed: int, w: int, seg: int):
    rng = np.random.default_rng(seed)
    e = 4 * seg + 64
    indices = rng.integers(0, 1 << 20, e).astype(np.int32)
    degs = rng.integers(0, seg + 1, w).astype(np.int32)
    degs[:2] = [seg, 0]
    starts = rng.integers(0, e - seg, w).astype(np.int32)
    rows = (rng.random((w, seg)) * (rng.random((w, seg)) > 0.2)).astype(np.float32)
    rows[np.arange(seg)[None, :] >= degs[:, None]] = 0.0
    rows[3] = 0.0  # zero-total row
    rand = rng.random(w).astype(np.float32)
    # the reference's (W, 2*seg) operand: row values at offset start % seg
    local = starts % seg
    offs = np.arange(2 * seg)
    inrow = (offs >= local[:, None]) & (offs < (local + degs)[:, None])
    src = np.clip(offs - local[:, None], 0, seg - 1)
    win = np.where(inrow, np.take_along_axis(rows, src, axis=1), 0.0).astype(np.float32)
    return indices, starts, degs, rows, rand, win


@pytest.mark.parametrize("seg", [128, 256, 512])
def test_walk_step_window_plain_matches_oracle(seg):
    indices, starts, degs, rows, rand, win = _window_case(seg, 48, seg)
    inds_p, _ = pad_csr_for_kernel(jnp.asarray(indices), jnp.zeros(indices.shape[0]), seg)
    want = np.asarray(jref.walk_step_window_block_ref(
        jnp.asarray(starts), jnp.asarray(degs), inds_p, jnp.asarray(win), jnp.asarray(rand),
        seg=seg))
    got = kernels.walk_step_window(_t(starts), _t(degs), _t(indices), _t(rows), _t(rand),
                                   max_seg=seg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


@pytest.mark.parametrize("seg", [128, 256])
def test_walk_step_window_plain_matches_pallas(seg):
    indices, starts, degs, rows, rand, win = _window_case(seg + 1, 12, seg)
    inds_p, _ = pad_csr_for_kernel(jnp.asarray(indices), jnp.zeros(indices.shape[0]), seg)
    want = np.asarray(walk_step_window_pallas(
        jnp.asarray(starts), jnp.asarray(degs), inds_p, jnp.asarray(win), jnp.asarray(rand),
        max_seg=seg, interpret=True))
    got = kernels.walk_step_window(_t(starts), _t(degs), _t(indices), _t(rows), _t(rand),
                                   max_seg=seg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_walk_step_window_rejects_misshaped_rows():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bias_rows"):
        kernels.walk_step_window(z, z, z, torch.zeros(4, 256), z.float(), max_seg=128)


# ---------------------------------------------------------------------------
# window plans and the chunked window tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_degree", [14, 100, 219, 300, 600, 25_000])
def test_exact_and_window_bucket_plans_equal(max_degree):
    assert tbk.walk_bucket_plan(max_degree, exact=True) == jbk.walk_bucket_plan(max_degree,
                                                                               exact=True)
    assert tbk.walk_bucket_plan_window(max_degree) == jbk.walk_bucket_plan_window(max_degree)


@pytest.mark.parametrize("hub_degree", [600, 1300])
def test_walk_transition_chunked_window_equal(hub_degree):
    rng = np.random.default_rng(hub_degree)
    leaves = np.arange(1, hub_degree + 1)
    src = np.concatenate([np.zeros(hub_degree, np.int64), leaves])
    dst = np.concatenate([leaves, np.roll(leaves, 1)])
    g = j_csr_from_edges(hub_degree + 1, src, dst, weights=rng.random(src.size) + 0.1,
                         symmetrize=True)
    cur = np.zeros(24, np.int32)
    cur[12:] = rng.integers(1, g.num_vertices, 12)
    prev = rng.integers(-1, g.num_vertices, 24).astype(np.int32)

    def hook(xp, u, w, prev_rows):  # a node2vec-like per-edge bias
        return xp.where(u == prev_rows[:, None], w * 0.5, w * 2.0) + (u % 3 == 0)

    key = jax.random.PRNGKey(hub_degree)
    want = jsel.walk_transition_chunked_window(
        key, g.indptr, g.indices, g.weights, jnp.asarray(cur),
        lambda u, w, m, eidx: hook(jnp, u, w, jnp.asarray(prev)))
    tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                         device="cpu")
    tprev = torch.from_numpy(prev)
    got = tsel.walk_transition_chunked_window(
        key_from_array(jax.random.key_data(key)), tg.indptr, tg.indices, tg.weights,
        torch.from_numpy(cur), lambda rows, u, w, m, eidx: hook(torch, u, w, tprev[rows]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
