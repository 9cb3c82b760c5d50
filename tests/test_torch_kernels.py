"""The port's walk-step kernels: plain versions against the JAX package's
oracles (``repro.kernels.ref``) and Pallas kernels (interpret mode).  The
CUDA kernels are held against these plain versions on the card in
``test_torch_cuda.py``.

All comparisons are exact: the outputs are vertex ids, and the scan
association is reproduced bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import select as jsel  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.alias_select import alias_step_pallas  # noqa: E402
from repro.kernels.walk_step import (  # noqa: E402
    pad_csr_for_kernel,
    reject_step_pallas,
    walk_step_pallas,
)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# blocked_cumsum: XLA-CPU's cumsum association
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [256, 512, 1024])
def test_blocked_cumsum_matches_jnp_cumsum(width):
    rng = np.random.default_rng(width)
    rows = 24
    x = (rng.random((rows, width)) * rng.choice([1e-3, 1.0, 7e3], (rows, 1))).astype(np.float32)
    local = rng.integers(0, width // 2, rows)
    deg = rng.integers(1, width // 2 + 1, rows)
    pos = np.arange(width)
    x = np.where((pos >= local[:, None]) & (pos < (local + deg)[:, None]), x, 0).astype(np.float32)
    ref_cum = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = ref.blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref_cum))


def test_blocked_cumsum_rejects_ragged_width():
    with pytest.raises(ValueError):
        ref.blocked_cumsum(torch.zeros(3, 40))


# ---------------------------------------------------------------------------
# plain versions vs the reference oracles and the Pallas kernels
# ---------------------------------------------------------------------------


def _case(seed: int, w: int = 48):
    """A CSR with degrees 0..700 (dead ends, zero-total rows, zero-bias
    edges, rows above every segment) and W walkers over it, some dead."""
    rng = np.random.default_rng(seed)
    v = 40
    deg = rng.integers(1, 700, v)
    deg[[0, 5]] = 0
    deg[[3, 9]] = [600, 513]
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = rng.integers(0, 1 << 20, e).astype(np.int32)
    bias = (rng.random(e).astype(np.float32) + np.float32(0.05)) * (rng.random(e) > 0.1)
    bias = bias.astype(np.float32)
    bias[indptr[7]:indptr[8]] = 0.0  # zero-total row
    rows = rng.integers(0, v, w)
    alive = rng.random(w) > 0.15
    starts = np.where(alive, indptr[rows], 0).astype(np.int32)
    degs = np.where(alive, deg[rows], 0).astype(np.int32)
    rand = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (w,)), np.float32)
    rej = np.asarray(jsel.rejection_randoms(jax.random.PRNGKey(seed + 1), (w,)))
    prob, alias = jsel.build_alias(indptr, bias)
    row_max = jsel.build_row_max(indptr, bias)[rows] * alive
    return dict(indptr=indptr, indices=indices, bias=bias, starts=starts, degs=degs,
                rand=rand, rej=rej, prob=prob, alias=alias, row_max=row_max.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_step_plain_matches_oracle_and_pallas(seg, seed):
    c = _case(seed)
    degs = np.minimum(c["degs"], seg)  # the scheduler caps ITS rows at seg
    inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
    args = (jnp.asarray(c["starts"]), jnp.asarray(degs), inds_p, bias_p, jnp.asarray(c["rand"]))
    oracle = np.asarray(jref.walk_step_block_ref(*args, seg=seg))
    pallas = np.asarray(walk_step_pallas(*args, max_seg=seg, interpret=True))
    np.testing.assert_array_equal(oracle, pallas)
    got = ref.walk_step_block_ref(_t(c["starts"]), _t(degs), _t(c["indices"]), _t(c["bias"]),
                                  _t(c["rand"]), seg=seg)
    np.testing.assert_array_equal(got.numpy(), oracle)
    # the same on the padded arrays the TPU kernel reads
    got_p = ref.walk_step_block_ref(_t(c["starts"]), _t(degs), _t(np.asarray(inds_p)),
                                    _t(np.asarray(bias_p)), _t(c["rand"]), seg=seg)
    np.testing.assert_array_equal(got_p.numpy(), oracle)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_alias_step_plain_matches_oracle_and_pallas(seg, seed):
    c = _case(seed)
    inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
    alias_p, prob_p = pad_csr_for_kernel(jnp.asarray(c["alias"]), jnp.asarray(c["prob"]), seg)
    st, dg, r = jnp.asarray(c["starts"]), jnp.asarray(c["degs"]), jnp.asarray(c["rand"])
    oracle = np.asarray(jref.alias_step_block_ref(st, dg, inds_p, prob_p, alias_p, r, seg=seg))
    pallas = np.asarray(alias_step_pallas(st, dg, inds_p, prob_p, alias_p, r, max_seg=seg,
                                          interpret=True))
    np.testing.assert_array_equal(oracle, pallas)
    got = kernels.alias_step(_t(c["starts"]), _t(c["degs"]), _t(c["indices"]), _t(c["prob"]),
                             _t(c["alias"]), _t(c["rand"]), max_seg=seg)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_reject_step_plain_matches_oracle_and_pallas(seg, seed):
    c = _case(seed)
    inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
    st, dg = jnp.asarray(c["starts"]), jnp.asarray(c["degs"])
    rm, rej = jnp.asarray(c["row_max"]), jnp.asarray(c["rej"])
    oracle = np.asarray(jref.reject_step_block_ref(st, dg, inds_p, bias_p, rm, rej, seg=seg))
    pallas = np.asarray(reject_step_pallas(st, dg, inds_p, bias_p, rm, rej, max_seg=seg,
                                           interpret=True))
    np.testing.assert_array_equal(oracle, pallas)
    got = kernels.reject_step(_t(c["starts"]), _t(c["degs"]), _t(c["indices"]), _t(c["bias"]),
                              _t(c["row_max"]), _t(c["rej"]), max_seg=seg)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


def test_walk_step_rejects_unsupported_segment():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.walk_step(z, z, z, z.float(), z.float(), max_seg=1024)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no count moves."""
    kernels.reset_launch_counts()
    c = _case(3)
    args = (_t(c["starts"]), _t(np.minimum(c["degs"], 128)), _t(c["indices"]))
    kernels.walk_step(*args, _t(c["bias"]), _t(c["rand"]), max_seg=128)
    kernels.alias_step(*args, _t(c["prob"]), _t(c["alias"]), _t(c["rand"]), max_seg=128)
    kernels.reject_step(*args, _t(c["bias"]), _t(c["row_max"]), _t(c["rej"]), max_seg=128)
    kernels.walk_step_window(*args, torch.zeros(args[0].shape[0], 128), _t(c["rand"]),
                             max_seg=128)
    kernels.its_select(torch.ones(4, 100), torch.zeros(4, 2, 3))
    assert kernels.launch_counts() == {"walk_step": 0, "reject_step": 0, "alias_step": 0,
                                       "walk_step_window": 0, "its_select": 0}
