"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Exact
tolerance throughout (vertex ids).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core import select as sel  # noqa: E402
from repro_torch.core.engine import random_walk, random_walk_segments, traversal_sample  # noqa: E402
from repro_torch.core.methods import MethodTables  # noqa: E402
from repro_torch.core.oom import oom_random_walk  # noqa: E402
from repro_torch.core.rng import (  # noqa: E402
    EntryKeys, RowKeys, PRNGKey, fold_in, uniform_at, uniform_many)
from repro_torch.graph import csr_from_edges, partition_by_vertex_range, powerlaw_graph  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.threefry import derive_keys, hash_uniform  # noqa: E402

#: the module behind ``kernels.its_select``, whose private launcher runs
#: either kernel at any shape
its_module = importlib.import_module("repro_torch.kernels.its_select")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _case(seed: int, w: int):
    """CSR rows of degree 0..700 (dead ends, a zero-total row, zero-bias
    edges, rows above every segment, rows in every first bucket) and W
    walkers, some finished."""
    rng = np.random.default_rng(seed)
    v = 40
    deg = rng.integers(1, 700, v)
    deg[20:30] = rng.integers(1, 129, 10)
    deg[[0, 5]] = 0
    deg[[3, 7, 9]] = [600, 9, 513]
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    bias = ((rng.random(e) + 0.05) * (rng.random(e) > 0.1)).astype(np.float32)
    bias[indptr[7]:indptr[8]] = 0.0
    rows = rng.integers(0, v, w)
    alive = rng.random(w) > 0.15
    prob, alias = sel.build_alias(indptr, bias)
    row_max_v = sel.build_row_max(indptr, bias)
    arrays = dict(
        indptr=indptr.astype(np.int32),
        indices=rng.integers(0, 1 << 30, e).astype(np.int32),
        bias=bias,
        prob=prob,
        alias=alias,
        cur=np.where(alive, rows, -1).astype(np.int32),
        starts=np.where(alive, indptr[rows], 0).astype(np.int32),
        degs=np.where(alive, deg[rows], 0).astype(np.int32),
        rand=rng.random(w).astype(np.float32),
        row_max_v=row_max_v,
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


#: (ladder, tail) of the step kernels: without a tail the last bucket
#: absorbs the rows above it (an understated max_degree)
LADDERS = [((128,), True), ((128,), False), ((128, 512), True), ((128, 512), False),
           ((128, 256, 384, 512), True), ((256,), False)]
LADDER_IDS = ["128+tail", "128", "128,512+tail", "128,512", "4-rungs+tail", "256"]


def _step(fn, c, key, ladder, tail, method, out=None):
    if fn is kernels.alias_step:
        tables = (c["prob"], c["alias"])
    else:
        tables = (c["bias"], *((c["row_max_v"],) if fn is kernels.reject_step else ()))
    return fn(key, c["indptr"], c["indices"], *tables, c["cur"], buckets=ladder,
              use_chunked=tail, methods=(method,) * (len(ladder) + tail), out=out)


STEP_KERNELS = [(kernels.reject_step, "rejection"), (kernels.walk_step, "its"),
                (kernels.alias_step, "alias")]


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [128, 512, None])
def test_kernels_match_plain_versions(cuda_device, seg):
    """Each step kernel against its plain version over the ladder ending at
    ``seg`` (None: (128, 512) with its tail)."""
    cpu = _case(4, w=4096)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    kernels.reset_launch_counts()
    ladder, tail = {128: ((128,), False), 512: ((128, 512), False), None: ((128, 512), True)}[seg]
    key = PRNGKey(seg or 1)
    for fn, method in STEP_KERNELS:
        want = _step(fn, cpu, key, ladder, tail, method)
        got = _step(fn, gpu, key, ladder, tail, method)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=fn.__name__)
        assert (want >= 0).any() and (want == -1).any()
    # the plain version run on the card gives the same ids
    want = _step(kernels.walk_step, cpu, key, ladder, tail, "its")
    on_card = ref.walk_step_ref(key, gpu["indptr"], gpu["indices"], gpu["bias"], gpu["cur"],
                                buckets=ladder, use_chunked=tail,
                                methods=("its",) * (len(ladder) + tail))
    np.testing.assert_array_equal(on_card.cpu().numpy(), want.numpy())
    assert kernels.launch_counts() == {"walk_step": 1, "reject_step": 1, "alias_step": 1,
                                       "walk_step_window": 0, "its_select": 0,
                                       "derive_keys": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("ladder,tail", LADDERS, ids=LADDER_IDS)
@pytest.mark.parametrize("w", [4099, 1237, 31])
def test_step_kernels_match_plain_versions(cuda_device, ladder, tail, w):
    """Both step kernels over every ladder, with and without a tail, at W
    not a multiple of 32: one launch each, every served walker equal to
    the plain version, every other entry of ``out`` left as it was."""
    cpu = _case(len(ladder) + 10 * tail + w, w=w)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    key = PRNGKey(w)
    for fn, method in [(kernels.reject_step, "rejection"), (kernels.walk_step, "its")]:
        kernels.reset_launch_counts()
        want = _step(fn, cpu, key, ladder, tail, method, out=torch.full((w,), -5, dtype=torch.int32))
        got = _step(fn, gpu, key, ladder, tail, method,
                    out=torch.full((w,), -5, dtype=torch.int32, device=cuda_device))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=fn.__name__)
        assert kernels.launch_counts()[fn.__name__] == 1
        assert (want == -5).any()  # finished walkers, degree 0, and (ITS) the tail
        if w > 1000:
            assert (want >= 0).any() and (want == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("ladder,tail", LADDERS, ids=LADDER_IDS)
@pytest.mark.parametrize("w", [4099, 1237, 31])
def test_alias_step_matches_plain_version(cuda_device, ladder, tail, w):
    """``alias_step`` over every ladder, with and without a tail, at W not
    a multiple of 32: one launch, every served walker equal to
    ``ref.alias_step_ref``, every other entry of ``out`` left as it was."""
    cpu = _case(len(ladder) + 10 * tail + w + 1, w=w)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    key = PRNGKey(w + 2)
    plan = dict(buckets=ladder, use_chunked=tail, methods=("alias",) * (len(ladder) + tail))
    want = ref.alias_step_ref(key, cpu["indptr"], cpu["indices"], cpu["prob"], cpu["alias"],
                              cpu["cur"], out=torch.full((w,), -5, dtype=torch.int32), **plan)
    kernels.reset_launch_counts()
    got = _step(kernels.alias_step, gpu, key, ladder, tail, "alias",
                out=torch.full((w,), -5, dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert kernels.launch_counts()["alias_step"] == 1
    assert (want == -5).any()  # finished walkers and degree 0
    if w > 1000:
        assert (want >= 0).any() and (want == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [True, False])
def test_alias_step_on_finished_empty_and_dead_rows(cuda_device, tail):
    """Finished walkers (``cur = -1``) and walkers on degree-0 vertices
    belong to no cohort and keep ``out``; walkers on the zero-total row
    (``alias = -1``) are served and give -1."""
    w = 2053
    cpu = _case(31 + tail, w=w)
    pattern = torch.tensor([-1, 0, 5, 7, 3, 9, 21], dtype=torch.int32)  # 0, 5: degree 0; 7: dead
    cpu["cur"] = pattern.repeat(w // pattern.numel() + 1)[:w].contiguous()
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    ladder = (128, 512)
    want = _step(kernels.alias_step, cpu, PRNGKey(6), ladder, tail, "alias",
                 out=torch.full((w,), -5, dtype=torch.int32))
    got = _step(kernels.alias_step, gpu, PRNGKey(6), ladder, tail, "alias",
                out=torch.full((w,), -5, dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    cur = cpu["cur"]
    assert (want[(cur == -1) | (cur == 0) | (cur == 5)] == -5).all()
    assert (want[cur == 7] == -1).all()
    assert (want[(cur == 3) | (cur == 9) | (cur == 21)] >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_walk_step_at_every_bias_alignment(cuda_device, shift):
    """``walk_step`` loads a window block as four 16-byte words when the
    bias is 16-byte aligned and word by word otherwise; both give the plain
    version's picks, on every row, the last rows included (their last
    window block runs past the end of the array)."""
    w = 4099
    cpu = _case(77 + shift, w=w)
    cpu["cur"][:40] = torch.arange(40, dtype=torch.int32)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    e = cpu["bias"].shape[0]
    buf = torch.zeros(e + 4, dtype=torch.float32, device=cuda_device)
    gpu["bias"] = buf[shift:shift + e]
    gpu["bias"].copy_(cpu["bias"])
    assert (gpu["bias"].data_ptr() % 16 == 0) == (shift == 0)
    for ladder, tail in [((128, 512), True), ((128,), False), ((256,), False)]:
        key = PRNGKey(shift + 3 * len(ladder))
        want = _step(kernels.walk_step, cpu, key, ladder, tail, "its")
        got = _step(kernels.walk_step, gpu, key, ladder, tail, "its")
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=str(ladder))


@pytest.mark.cuda
@pytest.mark.parametrize("ladder,tail", [((128, 512), True), ((128,), False)])
def test_walk_step_on_negative_bias(cuda_device, ladder, tail):
    """A row with a negative value takes ``walk_step``'s full second pass
    (the count from block totals holds only for values >= 0); the picks
    equal the plain version's on every row."""
    w = 4099
    cpu = _case(91 + len(ladder), w=w)
    e = cpu["bias"].shape[0]
    flip = torch.from_numpy(np.random.default_rng(5).integers(0, e, e // 20))
    cpu["bias"][flip] = -cpu["bias"][flip]
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    key = PRNGKey(len(ladder))
    want = _step(kernels.walk_step, cpu, key, ladder, tail, "its")
    got = _step(kernels.walk_step, gpu, key, ladder, tail, "its")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("ladder,tail,methods", [
    ((128, 512), True, ("its", "rejection", "alias")),
    ((128, 512), True, ("rejection", "alias", "its")),
    ((128, 512), True, ("alias", "its", "rejection")),
    ((128, 512), False, ("rejection", "its")),
    ((128,), True, ("its", "alias")),
])
def test_mixed_plans_one_launch_per_method(cuda_device, ladder, tail, methods):
    """``walk_step_adaptive`` with every method beside every other: the
    card's step equals the CPU's, with one launch per method."""
    cpu = _case(len(set(methods[:2])) + 7 * tail, w=4096)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}

    def step(c):
        tables = MethodTables(prob=c["prob"], alias=c["alias"], row_max=c["row_max_v"])
        return backend.walk_step_adaptive(PRNGKey(9), c["indptr"], c["indices"], c["bias"],
                                          c["cur"], buckets=ladder, use_chunked=tail,
                                          methods=methods, tables=tables)

    want = step(cpu)
    kernels.reset_launch_counts()
    got = step(gpu)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    bucket_its = "its" in methods[:len(ladder)]
    assert kernels.launch_counts() == {"walk_step": int(bucket_its),
                                       "reject_step": int("rejection" in methods),
                                       "alias_step": int("alias" in methods),
                                       "walk_step_window": 0, "its_select": 0,
                                       "derive_keys": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [True, False])
def test_reject_step_runs_every_round_and_the_fallback(cuda_device, tail):
    """Skewed rows: one heavy edge among light ones, so most draws are
    rejected in every round and the exhausted budget keeps the last slot
    (or -1 where that slot has no mass)."""
    rng = np.random.default_rng(11)
    v, w = 64, 8191
    deg = rng.integers(2, 1200, v)
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    bias = np.full(e, 1e-3, np.float32)
    bias[rng.random(e) < 0.3] = 0.0
    bias[indptr[:-1] + rng.integers(0, deg)] = 1.0  # one heavy edge a row
    cpu = {k: torch.from_numpy(x) for k, x in dict(
        indptr=indptr.astype(np.int32), indices=rng.integers(0, 1 << 30, e).astype(np.int32),
        bias=bias, row_max_v=sel.build_row_max(indptr, bias),
        cur=rng.integers(-1, v, w).astype(np.int32)).items()}
    gpu = {k: x.to(cuda_device) for k, x in cpu.items()}
    ladder = (128, 512)
    want = _step(kernels.reject_step, cpu, PRNGKey(4), ladder, tail, "rejection")
    got = _step(kernels.reject_step, gpu, PRNGKey(4), ladder, tail, "rejection")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    # the rounds of the budget the kernel hashed: most served walkers use all 8
    _, starts, deg = ref.walker_rows(cpu["indptr"], cpu["cur"])
    cohort = ref.walker_cohorts(deg, ladder, tail)
    cap = deg
    for k, seg in enumerate(ladder):
        cap = torch.where(cohort == k, deg.clamp(max=seg), cap)
    rm = cpu["row_max_v"][cpu["cur"].clamp(min=0).long()]
    rej = ref.rejection_randoms(fold_in(PRNGKey(4), 2), (w,))
    accepted = torch.zeros(w, dtype=torch.bool)
    for t in range(ref.REJECT_ITERS):
        slot = torch.minimum((rej[:, t, 0] * cap.float()).int(), (cap - 1).clamp(min=0))
        accepted |= rej[:, t, 1] * rm < cpu["bias"][(starts + slot).long()]
    exhausted = (cohort >= 0) & ~accepted
    assert int(exhausted.sum()) > w // 4
    assert ((want >= 0) & exhausted).any() and ((want == -1) & exhausted).any()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, (1 << 33) + 5])
def test_device_hash_equals_counted_uniforms(cuda_device, offset):
    """The kernels' threefry hash, alone, against ``rng.uniform`` bit for
    bit: the 16 round keys of a rejection step, counters from ``offset``
    (one above 2^32 sets the counter's high word)."""
    kb = fold_in(fold_in(PRNGKey(7), 3), 2)
    keys = np.stack([fold_in(kb, t) for t in range(16)])
    n = 100_003
    counters = torch.arange(n, dtype=torch.int64, device=cuda_device) + offset
    got = hash_uniform(keys, counters)
    torch.cuda.synchronize()
    want = torch.stack([uniform_at(k, counters.cpu()) for k in keys])
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want.numpy().view(np.uint32))
    if offset == 0:
        many = uniform_many(keys, n, device=cuda_device)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      many.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
def test_blocked_cumsum_same_bits_on_card(cuda_device):
    x = torch.from_numpy(np.random.default_rng(0).random((64, 1024)).astype(np.float32))
    want = ref.blocked_cumsum(x)
    got = ref.blocked_cumsum(x.to(cuda_device)).cpu()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["its", "alias", "rejection", None])
def test_card_walks_equal_cpu_walks(cuda_device, method):
    rng = np.random.default_rng(1)
    leaves = np.arange(1, 601)
    src = np.concatenate([np.zeros(600, np.int64), leaves])
    dst = np.concatenate([leaves, np.roll(leaves, 1)])
    g = csr_from_edges(601, src, dst, weights=rng.random(src.size) + 0.1, symmetrize=True,
                       device="cpu")
    seeds = rng.integers(0, 601, 256).astype(np.int32)
    seeds[:32] = 0
    spec = dataclasses.replace(alg.weighted_random_walk(), selection_method=method)
    cpu = random_walk(g, seeds, PRNGKey(2), depth=6, spec=spec, max_degree=600, device="cpu")
    kernels.reset_launch_counts()
    gpu = random_walk(g, seeds, PRNGKey(2), depth=6, spec=spec, max_degree=600, device=cuda_device)
    np.testing.assert_array_equal(gpu.walks.cpu().numpy(), cpu.walks.numpy())
    assert sum(kernels.launch_counts().values()) > 0


def _window_case(seed: int, w: int, seg: int):
    """Row-aligned window bias rows for walkers on rows of degree 0..seg,
    some zero-bias entries and zero-total rows."""
    rng = np.random.default_rng(seed)
    e = 1 << 16
    degs = rng.integers(0, seg + 1, w).astype(np.int32)
    degs[:8] = seg
    starts = rng.integers(0, e - seg, w).astype(np.int32)
    bias = (rng.random((w, seg)) * (rng.random((w, seg)) > 0.1)).astype(np.float32)
    bias[np.arange(seg)[None, :] >= degs[:, None]] = 0.0
    bias[10] = 0.0
    arrays = dict(starts=starts, degs=degs, bias=bias,
                  indices=rng.integers(0, 1 << 30, e).astype(np.int32),
                  rand=rng.random(w).astype(np.float32))
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [128, 256, 512])
def test_window_kernel_matches_plain_version(cuda_device, seg):
    cpu = _window_case(seg, 4096, seg)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    kernels.reset_launch_counts()
    args = ("starts", "degs", "indices", "bias", "rand")
    want = kernels.walk_step_window(*(cpu[k] for k in args), max_seg=seg)
    got = kernels.walk_step_window(*(gpu[k] for k in args), max_seg=seg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want == -1).any() and (want >= 0).any()
    assert kernels.launch_counts()["walk_step_window"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [128, 512])
def test_window_kernel_at_every_offset(cuda_device, seg):
    """Rows at every ``local % 16``, at and across the group edge at 256,
    of degree 1, 15, 16, 17 and ``seg``; all-zero rows and rows with
    negative values (the kernel counts prefixes, it does not search)."""
    rng = np.random.default_rng(seg + 1)
    locals_ = np.arange(seg)
    degs = np.array([1, 15, 16, 17, seg, seg - 1])
    local = np.repeat(locals_, degs.size)
    deg = np.minimum(np.tile(degs, locals_.size), seg)
    w = local.size
    base = rng.integers(1, 64, w) * seg
    bias = (rng.random((w, seg)) * np.exp2(rng.uniform(-20, 20, (w, seg)))).astype(np.float32)
    bias[rng.random(w) < 0.05] = 0.0  # all-zero rows
    neg = rng.random(w) < 0.2
    bias[neg] *= np.where(rng.random((int(neg.sum()), seg)) < 0.3, -1.0, 1.0).astype(np.float32)
    bias[np.arange(seg)[None, :] >= deg[:, None]] = 0.0
    cpu = {k: torch.from_numpy(v) for k, v in dict(
        starts=(base + local).astype(np.int32), degs=deg.astype(np.int32), bias=bias,
        indices=rng.integers(0, 1 << 30, 80 * seg).astype(np.int32),
        rand=rng.random(w).astype(np.float32)).items()}
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    args = ("starts", "degs", "indices", "bias", "rand")
    want = kernels.walk_step_window(*(cpu[k] for k in args), max_seg=seg)
    got = kernels.walk_step_window(*(gpu[k] for k in args), max_seg=seg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want == -1).any() and (want >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,iters", [(1, 1), (4, 8), (8, 32), (32, 32)])
@pytest.mark.parametrize("p", [37, 128, 1000, 1024, 1152, 4096])
def test_its_select_kernel_matches_plain_version(cuda_device, k, iters, p):
    rng = np.random.default_rng(p + k)
    n = 2048
    b = (rng.random((n, p)) * (rng.random((n, p)) > 0.3)).astype(np.float32)
    b[:16] = 0.0  # no candidate
    b[16:32, 3:] = 0.0  # fewer candidates than K
    b[32:48] = (rng.random((16, p)) > 0.5) * 1.0  # equal biases
    r = rng.random((n, iters, k)).astype(np.float32)
    want_idx, want_stats = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    kernels.reset_launch_counts()
    got_idx, got_stats = kernels.its_select(torch.from_numpy(b).to(cuda_device),
                                            torch.from_numpy(r).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_idx.cpu().numpy(), want_idx.numpy())
    np.testing.assert_array_equal(got_stats.cpu().numpy(), want_stats.numpy())
    assert kernels.launch_counts()["its_select"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,iters", [(1, 1), (8, 32), (32, 32)])
@pytest.mark.parametrize("p", [37, 128, 1000, 1024, 1152, 4096])
def test_its_select_kernel_on_edge_rows(cuda_device, k, iters, p):
    """All-zero and all-negative rows, rows with one candidate, and an
    instance count that is no multiple of the warps a block holds."""
    rng = np.random.default_rng(10 * p + k)
    n = 1237
    b = (rng.random((n, p)) * np.exp2(rng.uniform(-20, 20, (n, p)))).astype(np.float32)
    b[rng.random((n, p)) < 0.3] *= -1.0
    b[:40] = 0.0
    b[40:80] = -rng.random((40, p)).astype(np.float32)
    b[80:120] = 0.0
    b[80:120, p - 1] = 1.0  # the only candidate is the last
    r = rng.random((n, iters, k)).astype(np.float32)
    want_idx, want_stats = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    got_idx, got_stats = kernels.its_select(torch.from_numpy(b).to(cuda_device),
                                            torch.from_numpy(r).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_idx.cpu().numpy(), want_idx.numpy())
    np.testing.assert_array_equal(got_stats.cpu().numpy(), want_stats.numpy())
    assert (want_idx[:80] == -1).all()


@pytest.mark.cuda
def test_its_select_kernel_refuses_outside_its_limits(cuda_device):
    """Every K >= 1 and P >= 1 runs (the wide kernel past the warp kernel's
    shapes); the shape checks stay, and the warp kernel's launcher still
    refuses what it cannot take."""
    b = torch.ones(4, 4097, device=cuda_device)
    with pytest.raises(ValueError, match="K <= 32 and P <= 4096"):
        its_module._launch(b, torch.zeros(4, 1, 1, device=cuda_device), wide=False)
    with pytest.raises(ValueError, match="K >= 1"):
        kernels.its_select(b, torch.zeros(4, 1, 0, device=cuda_device))
    with pytest.raises(ValueError, match="ITERS >= 1"):
        kernels.its_select(b, torch.zeros(4, 0, 2, device=cuda_device))
    with pytest.raises(ValueError, match="biases"):
        kernels.its_select(b, torch.zeros(3, 1, 2, device=cuda_device))


def _sparse_pools(seed: int, n: int, p: int, k: int, iters: int):
    """Rows with few positive entries, so draws collide often: rows with
    fewer candidates than K, with one candidate (the last), with none,
    with equal biases, with negative entries and with biases over forty
    binary orders of magnitude."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, p), np.float32)
    for i in range(n):
        m = int(rng.integers(1, 4 * k + 2))
        at = rng.choice(p, size=min(m, p), replace=False)
        b[i, at] = (rng.random(at.size) * np.exp2(rng.uniform(-20, 20, at.size))).astype(np.float32)
    b[0] = 0.0
    b[1] = 0.0
    b[1, p - 1] = 1.0
    b[2, rng.choice(p, size=min(2 * k, p), replace=False)] = 1.0
    b[3] = np.where(b[3] > 0, -b[3], -1.0)
    r = rng.random((n, iters, k)).astype(np.float32)
    return b, r


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 33, 64])
@pytest.mark.parametrize("p", [4097, 102_784, 821_376])
def test_its_select_wide_kernel_matches_plain_version(cuda_device, k, p):
    n = {4097: 600, 102_784: 64, 821_376: 12}[p]
    b, r = _sparse_pools(p + k, n, p, k, 32)
    want_idx, want_stats = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    kernels.reset_launch_counts()
    got_idx, got_stats = kernels.its_select(torch.from_numpy(b).to(cuda_device),
                                            torch.from_numpy(r).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_idx.cpu().numpy(), want_idx.numpy())
    np.testing.assert_array_equal(got_stats.cpu().numpy(), want_stats.numpy())
    assert kernels.its_select.wide_launches == 1 and kernels.launch_counts()["its_select"] == 1
    if k > 1:
        assert (want_stats[:, 0] > 1).any()  # collisions: some instance took several rounds


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 600])
@pytest.mark.parametrize("p", [1, 17, 300, 4096])
def test_its_select_wide_kernel_on_narrow_rows_and_many_draws(cuda_device, k, p):
    """The wide kernel launched at any shape: rows of one candidate, rows
    of one scan block and a bit more, and more draws than its 512 threads
    (each thread serves several)."""
    n = 64 if k > 32 else 300
    b, r = _sparse_pools(10 * p + k, n, p, k, 16)
    want = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    got = its_module._launch(torch.from_numpy(b).to(cuda_device),
                             torch.from_numpy(r).to(cuda_device), wide=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _launch_rows(seed: int, n: int, p: int, k: int, iters: int, device):
    """Rows made on the card, in turn: rows whose 16-blocks start with a
    zero bias and that hold a long run of zeros, with their first round's
    draws on the entries where the CTPS steps down (and just before them);
    rows of fewer positive entries than K (as few as one); all-zero rows;
    rows of a few hundred positive entries, so draws collide."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b = torch.rand((n, p), generator=gen, device=device)
    b = b * torch.exp2(torch.rand((n, p), generator=gen, device=device) * 16 - 8)
    r = torch.rand((n, iters, k), generator=gen, device=device)
    kind = torch.arange(n, device=device) % 4
    b[kind == 0, 16::16] = 0.0
    b[kind == 0, p // 5: p // 2] = 0.0
    keep = torch.rand((n, p), generator=gen, device=device)
    few = torch.clamp(torch.randint(1, k + 1, (n, 1), generator=gen, device=device), max=k) - 1
    sparse = keep < 400.0 / p
    for i in torch.nonzero(kind == 1).flatten().tolist():  # fewer than K positive (at least one)
        at = torch.randperm(p, generator=gen, device=device)[: max(1, int(few[i]))]
        sparse[i] = False
        sparse[i, at] = True
    b = torch.where((kind[:, None] == 1) | (kind[:, None] == 3), torch.where(sparse, b, 0.0), b)
    b[kind == 2] = 0.0
    sums = ref.padded_cumsum(b)
    ctps = sums / torch.clamp(sums[:, -1:], min=1e-12)
    for i in torch.nonzero(kind == 0).flatten().tolist():
        down = torch.nonzero(ctps[i, 1:] < ctps[i, :-1]).flatten()
        at = torch.cat([ctps[i, down + 1], ctps[i, down]])
        if at.numel():
            r[i, 0] = at[torch.randint(0, at.numel(), (k,), generator=gen, device=device)]
    return b.contiguous(), r.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8, 16, 33, 600])
@pytest.mark.parametrize("p", [4097, 65_537, 102_784, 821_376])
@pytest.mark.parametrize("n", [1, 3, 163])
def test_its_select_wide_kernel_at_launch_shapes(cuda_device, n, p, k):
    """The wide kernel at the traversal paths' shapes (layer's 163 rows of
    821,376, the per-vertex rows of 102,784) and around the chunk edges,
    against the plain version run on the card: rows where the CTPS steps
    down, rows of fewer candidates than K, all-zero rows."""
    b, r = _launch_rows(n * p + k, n, p, k, 8, cuda_device)
    want = ref.its_select_ref(b, r)
    kernels.reset_launch_counts()
    got = kernels.its_select(b, r)
    torch.cuda.synchronize()
    for field, g, w in zip(("idx", "stats"), got, want):
        assert torch.equal(g, w), f"{field}: {int((g != w).sum())} mismatches"
    assert kernels.its_select.wide_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,k", [(3, 20_000, 9000), (1, 4096 * 4097, 4)])
def test_its_select_wide_kernel_with_tables_in_device_memory(cuda_device, n, p, k):
    """The rounds kernel's tables past its shared-memory budgets: the taken
    set of K = 9,000 draws, and the chunk extremes of a row of 4,097
    chunks, both in device memory."""
    b, r = _launch_rows(n + p + k, n, p, k, 4, cuda_device)
    want = ref.its_select_ref(b, r)
    got = kernels.its_select(b, r)
    torch.cuda.synchronize()
    for field, g, w in zip(("idx", "stats"), got, want):
        assert torch.equal(g, w), f"{field}: {int((g != w).sum())} mismatches"


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_its_select_kernels_agree_at_the_warp_limit(cuda_device, dense):
    """P = 4096, K = 32: the largest shape both kernels take."""
    p, k = 4096, 32
    if dense:
        rng = np.random.default_rng(7)
        b = (rng.random((900, p)) * (rng.random((900, p)) > 0.3)).astype(np.float32)
        r = rng.random((900, 32, k)).astype(np.float32)
    else:
        b, r = _sparse_pools(11, 900, p, k, 32)
    want = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    bt, rt = torch.from_numpy(b).to(cuda_device), torch.from_numpy(r).to(cuda_device)
    for wide in (False, True):
        got = its_module._launch(bt, rt, wide=wide)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _stepping_case(seed: int, n: int, p: int, k: int, iters: int):
    """Rows whose 16-blocks start with zero biases, and a budget whose first
    round draws sit on the entries where the CTPS steps down (and just
    before them), where a binary search and the count of entries <= r part."""
    rng = np.random.default_rng(seed)
    b = (rng.random((n, p)) * np.exp2(rng.uniform(-8, 8, (n, p)))).astype(np.float32)
    b[:, 16::16] = 0.0
    b[: n // 4, p // 5: p // 2] = 0.0  # a long run of zeros
    r = rng.random((n, iters, k)).astype(np.float32)
    ctps = sel.build_ctps(torch.from_numpy(b)).numpy()
    for i in range(n):
        down = np.nonzero(ctps[i, 1:] < ctps[i, :-1])[0]
        at = np.concatenate([ctps[i, down + 1], ctps[i, down]])
        if at.size:
            r[i, 0] = rng.choice(at, k)
    return b, r


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 40])
@pytest.mark.parametrize("p", [512, 4096, 4097, 102_784])
def test_its_select_kernels_count_where_the_ctps_steps_down(cuda_device, k, p):
    """Both kernels take the count of CTPS entries <= r, as the plain
    version and the reference do, also at draws on the entries where the
    scan's rounding makes the CTPS step down."""
    b, r = _stepping_case(p + k, 64 if p <= 4097 else 16, p, k, 8)
    want = kernels.its_select(torch.from_numpy(b), torch.from_numpy(r))
    bt, rt = torch.from_numpy(b).to(cuda_device), torch.from_numpy(r).to(cuda_device)
    for wide in (False, True) if k <= 32 and p <= 4096 else (True,):
        got = its_module._launch(bt, rt, wide=wide)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=f"wide={wide}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["neighbor_unbiased", "neighbor_biased", "forest_fire", "layer",
                                  "snowball", "mdrw"])
def test_card_traversal_equals_cpu_traversal(cuda_device, name):
    """Every traversal algorithm on a graph with a hub of degree 600: the
    per-vertex rows take the warp kernel, layer sampling's pooled rows of
    8 x 600 candidates the wide one."""
    rng = np.random.default_rng(4)
    leaves = np.arange(1, 601)
    src = np.concatenate([np.zeros(600, np.int64), leaves, rng.integers(1, 601, 2000)])
    dst = np.concatenate([leaves, np.roll(leaves, 1), rng.integers(1, 601, 2000)])
    g = csr_from_edges(601, src, dst, weights=rng.random(src.size) + 0.1, symmetrize=True,
                       device="cpu")
    pools = rng.integers(0, 601, (48, 3)).astype(np.int32)
    pools[:8, 0] = 0
    pools[8:12, 1:] = -1
    kw = dict(depth=3, spec=alg.ALGORITHMS[name](), max_degree=g.max_degree(),
              pool_capacity=32, max_vertices=601)
    cpu = traversal_sample(g, pools, PRNGKey(6), device="cpu", **kw)
    kernels.reset_launch_counts()
    gpu = traversal_sample(g, pools, PRNGKey(6), device=cuda_device, **kw)
    for field, a, b in zip(cpu._fields, cpu, gpu):
        np.testing.assert_array_equal(b.cpu().numpy(), a.numpy(), err_msg=field)
    assert kernels.launch_counts()["its_select"] == 2 * 3
    if name == "layer":
        assert kernels.its_select.wide_launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node2vec", "mhrw", "jump", "restart_home", "opaque"])
def test_card_walks_equal_cpu_walks_for_every_mode(cuda_device, name):
    rng = np.random.default_rng(2)
    leaves = np.arange(1, 601)
    src = np.concatenate([np.zeros(600, np.int64), leaves, rng.integers(1, 601, 2000)])
    dst = np.concatenate([leaves, np.roll(leaves, 1), rng.integers(1, 601, 2000)])
    g = csr_from_edges(601, src, dst, weights=rng.random(src.size) + 0.1, symmetrize=True,
                       device="cpu")
    spec = {
        "node2vec": alg.node2vec(3.0, 0.7),
        "mhrw": alg.metropolis_hastings_walk(),
        "jump": alg.random_walk_with_jump(0.2, 601),
        "restart_home": alg.random_walk_with_restart(0.2),
        "opaque": dataclasses.replace(alg.weighted_random_walk(), transition=None,
                                      flat_edge_bias=None),
    }[name]
    seeds = rng.integers(0, 601, 512).astype(np.int32)
    seeds[:32] = 0
    md = g.max_degree()
    cpu = random_walk(g, seeds, PRNGKey(3), depth=8, spec=spec, max_degree=md, device="cpu")
    kernels.reset_launch_counts()
    gpu = random_walk(g, seeds, PRNGKey(3), depth=8, spec=spec, max_degree=md, device=cuda_device)
    np.testing.assert_array_equal(gpu.walks.cpu().numpy(), cpu.walks.numpy())
    launched = kernels.launch_counts()
    want = {"node2vec": "walk_step_window", "opaque": "its_select"}.get(name, "reject_step")
    assert launched[want] > 0, launched


# -- per-row key tables (random_walk_segments) and the out-of-memory engine --


def _row_keys(rows: int, width: int, device, seed: int = 3):
    """``RowKeys`` of ``rows`` rows of ``width`` walkers, keys
    ``fold_in(PRNGKey(seed), r)``, on ``device``."""
    words = np.stack([fold_in(PRNGKey(seed), r) for r in range(rows)])
    base = torch.from_numpy(words.view(np.int32).copy()).to(device)
    return RowKeys(base, width)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(1, 4099), (3, 1237), (64, 65), (64, 31)])
@pytest.mark.parametrize("ladder,tail", [((128, 512), True), ((128,), False)])
def test_key_table_kernels_match_plain_versions(cuda_device, rows, width, ladder, tail):
    """The three step kernels under a key table of R rows (W not a multiple
    of the block, a row all -1): one ``derive_keys`` and one step launch
    each, every walker equal to the plain version under the same keys."""
    w = rows * width
    cpu = _case(rows + width, w=w)
    cpu["cur"][width:2 * width] = -1  # a row of finished walkers (or padding)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    kcpu = fold_in(_row_keys(rows, width, "cpu"), 1)
    kgpu = fold_in(_row_keys(rows, width, cuda_device), 1)
    for fn, method in STEP_KERNELS:
        want = _step(fn, cpu, kcpu, ladder, tail, method)
        kernels.reset_launch_counts()
        got = _step(fn, gpu, kgpu, ladder, tail, method)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=fn.__name__)
        counts = kernels.launch_counts()
        assert counts[fn.__name__] == 1 and counts["derive_keys"] == 1
        if rows > 1:
            assert (want[width:2 * width] == -1).all()


@pytest.mark.cuda
def test_key_table_rows_equal_single_key_launches(cuda_device):
    """Row ``r`` of a key-table launch equals the by-value launch of the
    row alone under its own key, for each step kernel."""
    rows, width = 5, 777
    c = {k: v.to(cuda_device) for k, v in _case(11, w=rows * width).items()}
    rk = _row_keys(rows, width, cuda_device)
    words = np.stack([fold_in(PRNGKey(3), r) for r in range(rows)])
    for fn, method in STEP_KERNELS:
        batch = _step(fn, c, fold_in(rk, 2), (128, 512), True, method)
        for r in range(rows):
            sl = slice(r * width, (r + 1) * width)
            row = {**c, "cur": c["cur"][sl].contiguous()}
            solo = _step(fn, row, fold_in(words[r], 2), (128, 512), True, method)
            assert torch.equal(batch[sl], solo), (fn.__name__, r)


@pytest.mark.cuda
def test_derive_keys_kernel_matches_fold_in(cuda_device):
    rows = 70
    words = np.stack([fold_in(PRNGKey(9), r) for r in range(rows)])
    base = torch.from_numpy(words.view(np.int32).copy())
    paths = [(), (1,), (4, 1, 2), (4, 1, 2, 15), tuple(range(8))] + [(t,) for t in range(11)]
    kernels.reset_launch_counts()
    got = derive_keys(base.to(cuda_device), paths)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["derive_keys"] == 1
    assert torch.equal(got.cpu(), derive_keys(base, paths))
    for r in (0, 33, rows - 1):
        for p, path in enumerate(paths):
            k = words[r]
            for d in path:
                k = fold_in(k, d)
            np.testing.assert_array_equal(got[r, p].cpu().numpy().view(np.uint32), k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepwalk", "alias", "its", "node2vec", "opaque", "mhrw",
                                  "restart_home"])
def test_card_segments_equal_cpu_segments(cuda_device, name):
    rng = np.random.default_rng(4)
    leaves = np.arange(1, 601)
    src = np.concatenate([np.zeros(600, np.int64), leaves, rng.integers(1, 601, 900)])
    dst = np.concatenate([leaves, np.roll(leaves, 1), rng.integers(1, 601, 900)])
    g = csr_from_edges(601, src, dst, weights=rng.random(src.size) + 0.1, symmetrize=True,
                       device="cpu")
    seeds = rng.integers(0, 601, (6, 40)).astype(np.int32)
    seeds[:, :4] = 0
    seeds[2, 9:] = -1
    seeds[4] = -1
    spec = {
        "deepwalk": alg.deepwalk(),
        "alias": dataclasses.replace(alg.weighted_random_walk(), selection_method="alias"),
        "its": dataclasses.replace(alg.weighted_random_walk(), selection_method="its"),
        "node2vec": alg.node2vec(),
        "opaque": dataclasses.replace(alg.weighted_random_walk(), transition=None,
                                      flat_edge_bias=None),
        "mhrw": alg.metropolis_hastings_walk(),
        "restart_home": alg.random_walk_with_restart(0.3),
    }[name]
    keys = np.stack([fold_in(PRNGKey(8), r) for r in range(6)])
    kw = dict(depth=5, spec=spec, max_degree=g.max_degree())
    cpu = random_walk_segments(g, seeds, keys, device="cpu", **kw)
    kernels.reset_launch_counts()
    gpu = random_walk_segments(g, seeds, keys, device=cuda_device, **kw)
    for a, b in zip(cpu[:3], gpu[:3]):  # walks, lengths, sampled edges
        assert torch.equal(a, b.cpu())
    assert cpu.stats is None and gpu.stats is None
    assert sum(kernels.launch_counts().values()) > 0
    solo = random_walk(g, seeds[3], keys[3], device=cuda_device, **kw)
    assert torch.equal(solo.walks, gpu.walks[3])


@pytest.mark.cuda
@pytest.mark.parametrize("name,flags", [
    ("auto", dict(batched=False, workload_aware=False, balance=False)),
    ("auto", dict()), ("its", dict()), ("node2vec", dict()), ("opaque", dict()),
    ("jump", dict(num_streams=3)),
])
def test_card_oom_equals_cpu_oom(cuda_device, name, flags):
    g = powerlaw_graph(600, seed=5, weighted=True, device="cpu")
    parts = partition_by_vertex_range(g, 4)
    seeds = np.random.default_rng(2).integers(-1, 600, 120)
    spec = {
        "auto": alg.biased_random_walk(),
        "its": dataclasses.replace(alg.weighted_random_walk(), selection_method="its"),
        "node2vec": alg.node2vec(),
        "opaque": dataclasses.replace(alg.weighted_random_walk(), transition=None,
                                      flat_edge_bias=None),
        "jump": alg.random_walk_with_jump(0.2, 600),
    }[name]
    limits = np.random.default_rng(3).integers(0, 7, 120)
    kw = dict(depth=6, spec=spec, max_degree=g.max_degree(), chunk=64, depth_limits=limits,
              **flags)
    walks_cpu, stats_cpu = oom_random_walk(parts, 600, seeds, PRNGKey(5), device="cpu", **kw)
    kernels.reset_launch_counts()
    walks_gpu, stats_gpu = oom_random_walk(parts, 600, seeds, PRNGKey(5), device=cuda_device,
                                           **kw)
    np.testing.assert_array_equal(walks_gpu, walks_cpu)
    assert dataclasses.asdict(stats_gpu) == dataclasses.asdict(stats_cpu)
    assert stats_gpu.partition_transfers > 0 and sum(kernels.launch_counts().values()) > 0


def _serve_burst(svc, n_vertices, seed=6):
    """A mixed burst (deepwalk, weighted, node2vec from one factory call,
    biased; 9-16 seeds, depths 3-12, explicit keys) submitted to ``svc``;
    returns the request ids."""
    rng = np.random.default_rng(seed)
    specs = [alg.deepwalk(), alg.weighted_random_walk(), alg.node2vec(), alg.biased_random_walk()]
    return [svc.submit(rng.integers(0, n_vertices, int(rng.integers(9, 17))),
                       depth=int(rng.integers(3, 13)), spec=specs[i % 4],
                       key=fold_in(PRNGKey(31), i))
            for i in range(16)]


@pytest.mark.cuda
def test_card_service_fused_equals_unfused_and_cpu(cuda_device):
    from repro_torch.serve import SamplingService, ServiceConfig

    g = powerlaw_graph(3000, seed=5, weighted=True, device="cpu")
    runs = {}
    for name, dev, fuse in [("fused", cuda_device, True), ("unfused", cuda_device, False),
                            ("cpu", "cpu", True)]:
        svc = SamplingService(g, device=dev, config=ServiceConfig(fuse=fuse))
        assert svc.device.type == torch.device(dev).type
        kernels.reset_launch_counts()
        ids = _serve_burst(svc, g.num_vertices)
        runs[name] = (ids, svc.drain(), svc.stats, kernels.launch_counts())
    ids, fused, stats, launches = runs["fused"]
    assert stats.launches < runs["unfused"][2].launches
    assert launches["walk_step_window"] > 0 and launches["derive_keys"] > 0
    for other in ("unfused", "cpu"):
        assert runs[other][0] == ids
        for rid in ids:
            np.testing.assert_array_equal(fused[rid].walks, runs[other][1][rid].walks)
            assert fused[rid].sampled_edges == runs[other][1][rid].sampled_edges


@pytest.mark.cuda
def test_card_oom_service_equals_cpu(cuda_device):
    from repro_torch.serve import SamplingService

    g = powerlaw_graph(3000, seed=5, weighted=True, device="cpu")
    parts = partition_by_vertex_range(g, 4)
    runs = []
    for dev in (cuda_device, "cpu"):
        svc = SamplingService(partitions=parts, total_vertices=g.num_vertices, device=dev,
                              oom_chunk=128, key=PRNGKey(2))
        svc.prewarm(alg.biased_random_walk(), depth=8, width=16, requests=4)
        rng = np.random.default_rng(4)
        ids = [svc.submit(rng.integers(0, g.num_vertices, 16), depth=int(rng.choice([4, 8])),
                          spec=alg.biased_random_walk()) for _ in range(8)]
        runs.append((ids, svc.drain(), dataclasses.asdict(svc.stats)))
    (ids, card, card_stats), (cpu_ids, cpu, cpu_stats) = runs
    assert ids == cpu_ids and card_stats == cpu_stats and card_stats["oom_launches"] == 1
    for rid in ids:
        np.testing.assert_array_equal(card[rid].walks, cpu[rid].walks)


@pytest.mark.cuda
def test_card_streaming_thread_burst_equals_unfused(cuda_device):
    """The scheduler thread launches on the service's card; a burst it
    serves equals the unfused batch service's answers, and no future fails."""
    from repro_torch.serve import (
        SamplingService, ServiceConfig, StreamConfig, StreamingSamplingService)

    g = powerlaw_graph(3000, seed=5, weighted=True, device="cpu")
    svc = SamplingService(g, device=cuda_device, config=ServiceConfig(max_requests_per_launch=4))
    for spec in (alg.deepwalk(), alg.weighted_random_walk()):
        svc.prewarm(spec, depth=8, width=16, requests=4)
    rng = np.random.default_rng(9)
    specs = [alg.deepwalk(), alg.weighted_random_walk()]
    reqs = [(rng.integers(0, g.num_vertices, int(rng.integers(9, 17))), specs[i % 2],
             fold_in(PRNGKey(23), i)) for i in range(24)]
    with StreamingSamplingService(svc, StreamConfig(max_batch_window_ms=3)) as stream:
        futs = [stream.submit(s, depth=8, spec=sp, key=k, deadline_ms=200) for s, sp, k in reqs]
        got = [f.result(timeout=120) for f in futs]
    assert svc.stats.stream_failed_requests == 0 and svc.stats.launches < len(reqs)
    base = SamplingService(g, device=cuda_device, config=ServiceConfig(fuse=False))
    ids = [base.submit(s, depth=8, spec=sp, key=k) for s, sp, k in reqs]
    want = base.drain()
    for res, rid in zip(got, ids):
        np.testing.assert_array_equal(res.walks, want[rid].walks)


def _entry_keys(depth: int, d, inst, device, seed: int = 5):
    """``EntryKeys`` of a walk of ``depth`` steps under ``PRNGKey(seed)``
    for entries at depths ``d`` and instances ``inst``, on ``device``."""
    words = np.stack([fold_in(PRNGKey(seed), t) for t in range(depth)])
    base = torch.from_numpy(words.view(np.int32).copy()).to(device)
    return EntryKeys(base, torch.from_numpy(d).to(device), torch.from_numpy(inst).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,mixed", [(1, False), (41, False), (41, True)])
@pytest.mark.parametrize("ladder,tail", [((128, 512), True), ((128,), False)])
def test_entry_key_kernels_match_plain_versions(cuda_device, depth, mixed, ladder, tail):
    """The three step kernels under per-entry keys (a key table a depth,
    each entry at its own depth and instance): batches of one depth (0 or
    40) and of many, instances out of order and empty slots; one
    ``derive_keys`` and one step launch each, every entry equal to the
    plain version."""
    w = 3001
    cpu = _case(depth + 7 * mixed, w=w)
    rng = np.random.default_rng(depth)
    inst = rng.permutation(5 * w)[:w].astype(np.int32)
    d = (rng.integers(0, depth, w) if mixed else np.full(w, depth - 1)).astype(np.int32)
    inst[cpu["cur"].numpy() < 0] = -1
    d[::97] = -1
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    kcpu = fold_in(_entry_keys(depth, d, inst, "cpu"), 1)
    kgpu = fold_in(_entry_keys(depth, d, inst, cuda_device), 1)
    for fn, method in STEP_KERNELS:
        want = _step(fn, cpu, kcpu, ladder, tail, method)
        kernels.reset_launch_counts()
        got = _step(fn, gpu, kgpu, ladder, tail, method)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=fn.__name__)
        counts = kernels.launch_counts()
        assert counts[fn.__name__] == 1 and counts["derive_keys"] <= 1


@pytest.mark.cuda
def test_entry_keys_equal_single_key_launches(cuda_device):
    """An entry at depth t and instance i draws what walker i of a
    by-value launch under ``fold_in(key, t)`` draws."""
    w, depth = 2000, 7
    c = {k: v.to(cuda_device) for k, v in _case(13, w=w).items()}
    rng = np.random.default_rng(1)
    d = rng.integers(0, depth, w).astype(np.int32)
    ek = fold_in(_entry_keys(depth, d, np.arange(w, dtype=np.int32), cuda_device), 1)
    for fn, method in STEP_KERNELS:
        batch = _step(fn, c, ek, (128, 512), True, method)
        for t in range(depth):
            solo = _step(fn, c, fold_in(fold_in(PRNGKey(5), t), 1), (128, 512), True, method)
            sel_t = torch.from_numpy(d == t).to(cuda_device)
            assert torch.equal(batch[sel_t], solo[sel_t]), (fn.__name__, t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepwalk", "weighted", "node2vec"])
def test_card_sharded_walk_equals_card_walk(cuda_device, name):
    """Four shards on one card walk as the card's single-device
    ``random_walk`` does, with traffic through the exchange and the hubs,
    and launch the step kernels under per-entry keys."""
    from repro_torch.shard import ShardMesh, sharded_random_walk

    spec = {"deepwalk": alg.deepwalk(), "weighted": alg.weighted_random_walk(),
            "node2vec": alg.node2vec()}[name]
    g = powerlaw_graph(20_000, seed=2, weighted=True, device=cuda_device)
    md = g.max_degree()
    seeds = np.arange(0, 20_000, 3, dtype=np.int32)
    want = random_walk(g, seeds, PRNGKey(8), depth=10, spec=spec, max_degree=md,
                       device=cuda_device)
    kernels.reset_launch_counts()
    got = sharded_random_walk(ShardMesh.on(cuda_device, 4), g, seeds, PRNGKey(8), depth=10,
                              spec=spec, max_degree=md, sub_rounds=2, exchange_slots=500)
    counts = kernels.launch_counts()
    assert torch.equal(got.walks, want.walks)
    assert got.stats["exchanged_entries"] > 0 and got.stats["hub_hops"] > 0
    step = "walk_step_window" if name == "node2vec" else None
    assert step is None or counts[step] > 0
    assert counts["derive_keys"] > 0 or name == "node2vec"


@pytest.mark.cuda
def test_cuda_mesh_pins_each_shard_to_a_card(cuda_device):
    from repro_torch.shard import ShardMesh

    mesh = ShardMesh.on("cuda", 4)
    assert mesh.size == 4 and all(d.type == "cuda" and d.index is not None for d in mesh.devices)


@pytest.mark.cuda
@pytest.mark.parametrize("max_seg", [128, 512])
def test_ops_helpers_match_plain_versions(cuda_device, max_seg):
    """``kernels.ops``: ``walk_step`` and ``its_select`` drawing their own
    uniforms from a key, on the card and on the CPU."""
    from repro_torch.kernels import ops

    g = powerlaw_graph(3000, seed=4, weighted=True, max_degree=max_seg, device="cpu")
    rng = np.random.default_rng(max_seg)
    cur = torch.from_numpy(rng.integers(-1, g.num_vertices, 5000).astype(np.int32))
    key = PRNGKey(max_seg)
    card = ops.walk_step(key, g.to(cuda_device), cur.to(cuda_device), max_seg=max_seg)
    assert torch.equal(card.cpu(), ops.walk_step(key, g, cur, max_seg=max_seg))
    b = torch.from_numpy((rng.random((300, max_seg)) * (rng.random((300, max_seg)) > 0.2))
                         .astype(np.float32))
    card = ops.its_select(key, b.to(cuda_device), 8, iters=8)
    assert torch.equal(card.cpu(), ops.its_select(key, b, 8, iters=8))


@pytest.mark.cuda
def test_lm_step_runs_on_the_card(cuda_device):
    """A dense smoke decoder's train step, prefill and decode on the card
    agree with the CPU's on the same weights (f32, TF32 off)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, forward, init_cache
    from repro_torch.train.train_step import make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("gemma3_1b")
    cpu = DecoderLM(cfg, seed=3, device="cpu")
    card = DecoderLM(cfg, seed=3, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want, _ = forward(cpu, toks)
        got, _ = forward(card, toks.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    serve = make_serve_step(cfg, 2, 32, device=cuda_device)
    cache = init_cache(cfg, 2, 32, device=cuda_device)
    dec = torch.cat([serve(card, cache, toks[:, t:t + 1])[0] for t in range(24)], dim=1)
    np.testing.assert_allclose(dec.cpu().numpy(), want.numpy(), rtol=3e-3, atol=3e-3)
