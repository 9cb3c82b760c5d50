"""The port's walk-step kernels: plain versions against the JAX package's
oracles (``repro.kernels.ref``), Pallas kernels (interpret mode) and the
wrappers around them (``repro.kernels.ops.walk_step``,
``repro.core.backend.walk_step_adaptive``), under the same keys.  The CUDA
kernels are held against these plain versions on the card in
``test_torch_cuda.py``.

All comparisons are exact: the outputs are vertex ids, and the scan
association is reproduced bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import backend as jbk  # noqa: E402
from repro.core import methods as jmt  # noqa: E402
from repro.core import select as jsel  # noqa: E402
from repro.graph.csr import CSRGraph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.alias_select import alias_step_pallas  # noqa: E402
from repro.kernels.walk_step import (  # noqa: E402
    pad_csr_for_kernel,
    reject_step_pallas,
    walk_step_pallas,
)
from repro_torch import kernels  # noqa: E402
from repro_torch.core import backend as tbk  # noqa: E402
from repro_torch.core import methods as tmt  # noqa: E402
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

#: (ladder, tail) of the step kernels' cases: without a tail the last bucket
#: absorbs the rows above it (an understated max_degree: rows reach 700)
LADDERS = [((128,), True), ((128,), False), ((128, 512), True), ((128, 512), False)]
LADDER_IDS = ["128+tail", "128-understated", "128,512+tail", "128,512-understated"]


def _case(seed: int, w: int = 48):
    """A CSR with degrees 0..700 (dead ends, zero-total rows, zero-bias
    edges, rows above every segment) and W walkers over it, some finished
    (``cur = -1``) and some on degree-0 vertices."""
    rng = np.random.default_rng(seed)
    v = 40
    deg = rng.integers(1, 700, v)
    deg[20:30] = rng.integers(1, 129, 10)  # rows in every first bucket
    deg[[0, 5]] = 0
    deg[[3, 7, 9]] = [600, 9, 513]  # 7: the zero-total row, in every first bucket
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = rng.integers(0, 1 << 20, e).astype(np.int32)
    bias = (rng.random(e).astype(np.float32) + np.float32(0.05)) * (rng.random(e) > 0.1)
    bias = bias.astype(np.float32)
    bias[indptr[7]:indptr[8]] = 0.0  # zero-total row
    rows = rng.integers(0, v, w)
    alive = rng.random(w) > 0.15
    rows[-1], alive[-1] = 7, True  # a walker on the zero-total row
    starts = np.where(alive, indptr[rows], 0).astype(np.int32)
    degs = np.where(alive, deg[rows], 0).astype(np.int32)
    rand = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (w,)), np.float32)
    rej = np.asarray(jsel.rejection_randoms(jax.random.PRNGKey(seed + 1), (w,)))
    prob, alias = jsel.build_alias(indptr, bias)
    row_max_v = jsel.build_row_max(indptr, bias)
    row_max = row_max_v[rows] * alive
    return dict(indptr=indptr.astype(np.int32), indices=indices, bias=bias, starts=starts,
                degs=degs, rand=rand, rej=rej, prob=prob, alias=alias,
                row_max=row_max.astype(np.float32), row_max_v=row_max_v,
                cur=np.where(alive, rows, -1).astype(np.int32), deg_v=deg)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cohorts(c, ladder, tail):
    """Each walker's cohort index (-1: none), as the step schedules it."""
    d = np.where(c["cur"] >= 0, c["deg_v"][np.maximum(c["cur"], 0)], 0)
    cohort = np.full(d.shape, -1)
    lo = 0
    for i, seg in enumerate(ladder):
        absorb = i == len(ladder) - 1 and not tail
        cohort = np.where((d > lo) & ((d <= seg) | absorb), i, cohort)
        lo = seg
    if tail:
        cohort = np.where(d > ladder[-1], len(ladder), cohort)
    return cohort, d


def _step_args(c):
    return _t(c["indptr"]), _t(c["indices"]), _t(c["bias"])


def _its_oracle(c, key, ladder, tail):
    """The JAX package's ITS step per cohort, -1 outside the ITS buckets:
    ``kernels.ops.walk_step`` (which draws ``uniform(key, (W,))`` itself)
    under ``fold_in(key, 0)`` where every row of the cohort fits its
    segment, else ``walk_step_pallas`` on the rows capped at it (the
    absorbing bucket of an understated max_degree), as
    ``core.backend.walk_step_adaptive`` runs it."""
    cohort, d = _cohorts(c, ladder, tail)
    k0 = jax.random.fold_in(key, 0)
    rand = jax.random.uniform(k0, c["cur"].shape, dtype=jnp.float32)
    graph = CSRGraph(jnp.asarray(c["indptr"]), jnp.asarray(c["indices"]), jnp.asarray(c["bias"]))
    want = np.full(c["cur"].shape, -1, np.int32)
    for k, seg in enumerate(ladder):
        inb = cohort == k
        if not inb.any():
            continue
        if (d[inb] <= seg).all():
            got = jops.walk_step(k0, graph, jnp.asarray(np.where(inb, c["cur"], -1)), max_seg=seg)
        else:
            inds_p, bias_p = pad_csr_for_kernel(graph.indices, graph.weights, seg)
            st = jnp.asarray(np.where(inb, c["starts"], 0))
            dg = jnp.asarray(np.where(inb, np.minimum(d, seg), 0).astype(np.int32))
            got = walk_step_pallas(st, dg, inds_p, bias_p, rand, max_seg=seg, interpret=True)
        want = np.where(inb, np.asarray(got), want)
    return want, cohort


def _reject_oracle(c, key, ladder, tail):
    """The JAX package's rejection step per cohort, fed
    ``rejection_randoms(fold_in(key, 2))``: ``reject_step_pallas`` in the
    buckets, the flat draw over the whole row in the tail."""
    cohort, d = _cohorts(c, ladder, tail)
    rej = jsel.rejection_randoms(jax.random.fold_in(key, 2), c["cur"].shape)
    rm = jnp.asarray(np.where(c["cur"] >= 0, c["row_max_v"][np.maximum(c["cur"], 0)], 0)
                     .astype(np.float32))
    want = np.full(c["cur"].shape, -1, np.int32)
    for k in range(len(ladder) + tail):
        inb = cohort == k
        st = jnp.asarray(np.where(inb, c["starts"], 0))
        dg = jnp.asarray(np.where(inb, d, 0).astype(np.int32))
        if k < len(ladder):
            seg = ladder[k]
            inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
            got = reject_step_pallas(st, dg, inds_p, bias_p, rm, rej, max_seg=seg, interpret=True)
        else:
            got = jsel.rejection_draw_flat(st, dg, jnp.asarray(c["bias"]), rm,
                                           jnp.asarray(c["indices"]), rej)
        want = np.where(inb, np.asarray(got), want)
    return want, cohort


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_step_plain_matches_oracle_and_pallas(seg, seed):
    """The cohort-level plain version against the oracle and the Pallas
    kernel, and the step over the ladder ending at ``seg`` (with its tail)
    against ``kernels.ops.walk_step``."""
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

    ladder = (128,) if seg == 128 else (128, 512)
    key = jax.random.PRNGKey(seed + 11)
    want, _ = _its_oracle(c, key, ladder, True)
    step = kernels.walk_step(np.asarray(jax.random.key_data(key)), *_step_args(c), _t(c["cur"]),
                             buckets=ladder, use_chunked=True, methods=("its",) * (len(ladder) + 1))
    np.testing.assert_array_equal(step.numpy(), want)


@pytest.mark.parametrize("ladder,tail", LADDERS, ids=LADDER_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_step_matches_jax_walk_step(ladder, tail, seed):
    """Every ladder, with and without a tail: the served cohorts equal the
    JAX package's ITS step under the same key; the tail and the walkers of
    no cohort keep what ``out`` held."""
    c = _case(seed + 20, w=160)
    key = jax.random.PRNGKey(seed)
    want, cohort = _its_oracle(c, key, ladder, tail)
    out = torch.full((c["cur"].shape[0],), -7, dtype=torch.int32)
    got = kernels.walk_step(np.asarray(jax.random.key_data(key)), *_step_args(c), _t(c["cur"]),
                            buckets=ladder, use_chunked=tail,
                            methods=("its",) * (len(ladder) + tail), out=out).numpy()
    served = (cohort >= 0) & (cohort < len(ladder))
    np.testing.assert_array_equal(got[served], want[served])
    assert (got[~served] == -7).all()
    assert (got[served] >= 0).any() and (got[served] == -1).any()
    if not tail:  # the absorbing bucket served rows above its segment
        assert (np.where(c["cur"] >= 0, c["deg_v"][np.maximum(c["cur"], 0)], 0)[served]
                > ladder[-1]).any()


def _alias_oracle(c, key, ladder, tail):
    """The JAX package's alias step: ``core.backend.walk_step_adaptive``
    with every cohort planned as alias, ``alias_step_pallas`` in interpret
    mode in the buckets and the flat draw over the whole row in the tail."""
    cohort, _ = _cohorts(c, ladder, tail)
    indices, bias = jnp.asarray(c["indices"]), jnp.asarray(c["bias"])
    jtables = jmt.MethodTables(prob=jnp.asarray(c["prob"]), alias=jnp.asarray(c["alias"]),
                               row_max=None)
    want = jbk.walk_step_adaptive(
        key, jnp.asarray(c["indptr"]), indices, bias, jbk.pad_walk_csr(indices, bias, ladder),
        jnp.asarray(c["cur"]), buckets=ladder, use_chunked=tail,
        methods=("alias",) * (len(ladder) + tail), tables=jtables, backend="pallas",
        interpret=True)
    return np.asarray(want), cohort


def _alias_step(c, key, ladder, tail, out=None):
    return kernels.alias_step(np.asarray(jax.random.key_data(key)), *_step_args(c)[:2],
                              _t(c["prob"]), _t(c["alias"]), _t(c["cur"]), buckets=ladder,
                              use_chunked=tail, methods=("alias",) * (len(ladder) + tail),
                              out=out)


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_alias_step_plain_matches_oracle_and_pallas(seg, seed):
    """The cohort-level plain version against the oracle and the Pallas
    kernel on given uniforms, and the step over the ladder ending at
    ``seg`` (with its tail) against the JAX package's step."""
    c = _case(seed)
    inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
    alias_p, prob_p = pad_csr_for_kernel(jnp.asarray(c["alias"]), jnp.asarray(c["prob"]), seg)
    st, dg, r = jnp.asarray(c["starts"]), jnp.asarray(c["degs"]), jnp.asarray(c["rand"])
    oracle = np.asarray(jref.alias_step_block_ref(st, dg, inds_p, prob_p, alias_p, r, seg=seg))
    pallas = np.asarray(alias_step_pallas(st, dg, inds_p, prob_p, alias_p, r, max_seg=seg,
                                          interpret=True))
    np.testing.assert_array_equal(oracle, pallas)
    got = ref.alias_step_block_ref(_t(c["starts"]), _t(c["degs"]), _t(c["indices"]),
                                   _t(c["prob"]), _t(c["alias"]), _t(c["rand"]), seg=seg)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()

    ladder = (128,) if seg == 128 else (128, 512)
    key = jax.random.PRNGKey(seed + 11)
    want, _ = _alias_oracle(c, key, ladder, True)
    np.testing.assert_array_equal(_alias_step(c, key, ladder, True).numpy(), want)


@pytest.mark.parametrize("ladder,tail", LADDERS, ids=LADDER_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_alias_step_matches_jax_pallas(ladder, tail, seed):
    """Every ladder, with and without a tail, every cohort planned as
    alias: equal to the JAX package's step under the same key, walker for
    walker.  Finished walkers and walkers on degree-0 vertices belong to no
    cohort: the JAX step gives them -1, and the port's leaves ``out``
    there as it was."""
    c = _case(seed + 50, w=160)
    key = jax.random.PRNGKey(seed + 7)
    want, cohort = _alias_oracle(c, key, ladder, tail)
    np.testing.assert_array_equal(_alias_step(c, key, ladder, tail).numpy(), want)
    out = torch.full((c["cur"].shape[0],), -7, dtype=torch.int32)
    got = _alias_step(c, key, ladder, tail, out=out).numpy()
    served = cohort >= 0
    np.testing.assert_array_equal(got[served], want[served])
    assert (got[~served] == -7).all() and (want[~served] == -1).all()
    assert (got[served] >= 0).any() and (got[served] == -1).any()
    assert (c["cur"] < 0).any() and ((c["cur"] >= 0) & ~served).any()
    if tail:
        assert (cohort == len(ladder)).sum() > 5
    else:  # the absorbing bucket served rows above its segment
        assert (np.where(c["cur"] >= 0, c["deg_v"][np.maximum(c["cur"], 0)], 0)[served]
                > ladder[-1]).any()


@pytest.mark.parametrize("seg", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_reject_step_plain_matches_oracle_and_pallas(seg, seed):
    """The cohort-level plain version against the oracle and the Pallas
    kernel on a given budget, and the step over the ladder ending at
    ``seg`` (with its tail) against ``reject_step_pallas`` fed the
    reference's budget."""
    c = _case(seed)
    inds_p, bias_p = pad_csr_for_kernel(jnp.asarray(c["indices"]), jnp.asarray(c["bias"]), seg)
    st, dg = jnp.asarray(c["starts"]), jnp.asarray(c["degs"])
    rm, rej = jnp.asarray(c["row_max"]), jnp.asarray(c["rej"])
    oracle = np.asarray(jref.reject_step_block_ref(st, dg, inds_p, bias_p, rm, rej, seg=seg))
    pallas = np.asarray(reject_step_pallas(st, dg, inds_p, bias_p, rm, rej, max_seg=seg,
                                           interpret=True))
    np.testing.assert_array_equal(oracle, pallas)
    got = ref.reject_step_block_ref(_t(c["starts"]), _t(c["degs"]), _t(c["indices"]),
                                    _t(c["bias"]), _t(c["row_max"]), _t(c["rej"]), seg=seg)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()

    ladder = (128,) if seg == 128 else (128, 512)
    key = jax.random.PRNGKey(seed + 11)
    want, _ = _reject_oracle(c, key, ladder, True)
    step = kernels.reject_step(np.asarray(jax.random.key_data(key)), *_step_args(c),
                               _t(c["row_max_v"]), _t(c["cur"]), buckets=ladder,
                               use_chunked=True, methods=("rejection",) * (len(ladder) + 1))
    np.testing.assert_array_equal(step.numpy(), want)


@pytest.mark.parametrize("ladder,tail", LADDERS, ids=LADDER_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reject_step_matches_jax_pallas(ladder, tail, seed):
    """Every ladder, with and without a tail, every cohort planned as
    rejection: equal to the JAX package's step under the same key."""
    c = _case(seed + 30, w=160)
    key = jax.random.PRNGKey(seed + 3)
    want, cohort = _reject_oracle(c, key, ladder, tail)
    got = kernels.reject_step(np.asarray(jax.random.key_data(key)), *_step_args(c),
                              _t(c["row_max_v"]), _t(c["cur"]), buckets=ladder, use_chunked=tail,
                              methods=("rejection",) * (len(ladder) + tail)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[cohort >= 0] >= 0).any() and (got[cohort >= 0] == -1).any()


#: mixed plans (ladder, tail, methods): every method beside every other
MIXED = [
    ((128, 512), True, ("its", "rejection", "alias")),
    ((128, 512), True, ("rejection", "alias", "its")),
    ((128, 512), False, ("alias", "its")),
    ((128,), True, ("rejection", "its")),
    ((128,), False, ("rejection",)),
]


@pytest.mark.parametrize("ladder,tail,methods", MIXED,
                         ids=["-".join(m) + ("+tail" if t else "") for _, t, m in MIXED])
def test_walk_step_adaptive_mixed_plans_match_jax(ladder, tail, methods):
    """One step of mixed plans: the port's ``walk_step_adaptive`` (one
    launch per method) equals ``repro``'s with the Pallas kernels in
    interpret mode, walker for walker."""
    c = _case(len(methods) + 40 * tail + len(ladder), w=64)
    key = jax.random.PRNGKey(5)
    bias, indices = jnp.asarray(c["bias"]), jnp.asarray(c["indices"])
    jtables = jmt.MethodTables(prob=jnp.asarray(c["prob"]), alias=jnp.asarray(c["alias"]),
                               row_max=jnp.asarray(c["row_max_v"]))
    want = np.asarray(jbk.walk_step_adaptive(
        key, jnp.asarray(c["indptr"]), indices, bias, jbk.pad_walk_csr(indices, bias, ladder),
        jnp.asarray(c["cur"]), buckets=ladder, use_chunked=tail, methods=methods,
        tables=jtables, backend="pallas", interpret=True))
    tables = tmt.MethodTables(prob=_t(c["prob"]), alias=_t(c["alias"]),
                              row_max=_t(c["row_max_v"]))
    got = tbk.walk_step_adaptive(np.asarray(jax.random.key_data(key)), *_step_args(c)[:2],
                                 _t(c["bias"]), _t(c["cur"]), buckets=ladder, use_chunked=tail,
                                 methods=methods, tables=tables)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 20


def test_walk_step_rejects_unsupported_segment():
    c = _case(2)
    with pytest.raises(ValueError):
        kernels.walk_step(np.zeros(2, np.uint32), *_step_args(c), _t(c["cur"]), buckets=(1024,),
                          use_chunked=False, methods=("its",))


@pytest.mark.parametrize("buckets,use_chunked,methods", [
    ((128, 256, 384, 512, 1024), False, ("rejection",) * 5),  # longer than the kernels take
    ((512, 128), False, ("rejection",) * 2),  # not increasing
    ((128, 512), True, ("rejection",) * 2),  # no method for the tail
    ((128,), False, ("rejection", "rejection")),  # a method for a tail that is not there
])
def test_step_kernels_reject_bad_ladders(buckets, use_chunked, methods):
    c = _case(2)
    key = np.zeros(2, np.uint32)
    with pytest.raises(ValueError):
        kernels.reject_step(key, *_step_args(c), _t(c["row_max_v"]), _t(c["cur"]),
                            buckets=buckets, use_chunked=use_chunked, methods=methods)
    with pytest.raises(ValueError):
        kernels.walk_step(key, *_step_args(c), _t(c["cur"]), buckets=buckets,
                          use_chunked=use_chunked, methods=("its",) * len(methods))
    with pytest.raises(ValueError):
        kernels.alias_step(key, *_step_args(c)[:2], _t(c["prob"]), _t(c["alias"]), _t(c["cur"]),
                           buckets=buckets, use_chunked=use_chunked,
                           methods=("alias",) * len(methods))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no count moves."""
    kernels.reset_launch_counts()
    c = _case(3)
    key = np.asarray([0, 3], np.uint32)
    plan = dict(buckets=(128, 512), use_chunked=True)
    kernels.walk_step(key, *_step_args(c), _t(c["cur"]), methods=("its",) * 3, **plan)
    kernels.reject_step(key, *_step_args(c), _t(c["row_max_v"]), _t(c["cur"]),
                        methods=("rejection",) * 3, **plan)
    kernels.alias_step(key, *_step_args(c)[:2], _t(c["prob"]), _t(c["alias"]), _t(c["cur"]),
                       methods=("alias",) * 3, **plan)
    args = (_t(c["starts"]), _t(np.minimum(c["degs"], 128)), _t(c["indices"]))
    kernels.walk_step_window(*args, torch.zeros(args[0].shape[0], 128), _t(c["rand"]),
                             max_seg=128)
    kernels.its_select(torch.ones(4, 100), torch.zeros(4, 2, 3))
    kernels.derive_keys(torch.zeros((3, 2), dtype=torch.int32), [(1, 2)])
    assert kernels.launch_counts() == {"walk_step": 0, "reject_step": 0, "alias_step": 0,
                                       "walk_step_window": 0, "its_select": 0,
                                       "derive_keys": 0}
