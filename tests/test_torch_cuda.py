"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Exact
tolerance throughout (vertex ids).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import select as sel  # noqa: E402
from repro_torch.core.engine import random_walk  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.graph import csr_from_edges  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _case(seed: int, w: int):
    """CSR rows of degree 0..700 (dead ends, a zero-total row, zero-bias
    edges, rows above every segment) and W walkers, some dead."""
    rng = np.random.default_rng(seed)
    v = 40
    deg = rng.integers(1, 700, v)
    deg[[0, 5]] = 0
    deg[[3, 9]] = [600, 513]
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    bias = ((rng.random(e) + 0.05) * (rng.random(e) > 0.1)).astype(np.float32)
    bias[indptr[7]:indptr[8]] = 0.0
    rows = rng.integers(0, v, w)
    alive = rng.random(w) > 0.15
    prob, alias = sel.build_alias(indptr, bias)
    arrays = dict(
        indices=rng.integers(0, 1 << 30, e).astype(np.int32),
        bias=bias,
        prob=prob,
        alias=alias,
        starts=np.where(alive, indptr[rows], 0).astype(np.int32),
        degs=np.where(alive, deg[rows], 0).astype(np.int32),
        rand=rng.random(w).astype(np.float32),
        rej=rng.random((w, sel.REJECT_ITERS, 2)).astype(np.float32),
        row_max=(sel.build_row_max(indptr, bias)[rows] * alive).astype(np.float32),
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [128, 512, None])
def test_kernels_match_plain_versions(cuda_device, seg):
    cpu = _case(4, w=4096)
    gpu = {k: v.to(cuda_device) for k, v in cpu.items()}
    kernels.reset_launch_counts()
    for fn, extra in [
        (kernels.alias_step, ("prob", "alias", "rand")),
        (kernels.reject_step, ("bias", "row_max", "rej")),
    ]:
        want = fn(cpu["starts"], cpu["degs"], cpu["indices"], *(cpu[k] for k in extra), max_seg=seg)
        got = fn(gpu["starts"], gpu["degs"], gpu["indices"], *(gpu[k] for k in extra), max_seg=seg)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=fn.__name__)
    if seg is not None:
        dcap = torch.clamp(cpu["degs"], max=seg)
        want = kernels.walk_step(cpu["starts"], dcap, cpu["indices"], cpu["bias"], cpu["rand"],
                                 max_seg=seg)
        got = kernels.walk_step(gpu["starts"], dcap.to(cuda_device), gpu["indices"],
                                gpu["bias"], gpu["rand"], max_seg=seg)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg="walk_step")
        # the plain version run on the card gives the same ids
        on_card = ref.walk_step_block_ref(gpu["starts"], dcap.to(cuda_device), gpu["indices"],
                                          gpu["bias"], gpu["rand"], seg=seg)
        np.testing.assert_array_equal(on_card.cpu().numpy(), want.numpy())
    counts = kernels.launch_counts()
    assert counts["alias_step"] == 1 and counts["reject_step"] == 1
    assert counts["walk_step"] == (0 if seg is None else 1)


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
    b = torch.ones(4, 4097, device=cuda_device)
    with pytest.raises(ValueError, match="P <= 4096"):
        kernels.its_select(b, torch.zeros(4, 1, 1, device=cuda_device))
    with pytest.raises(ValueError, match="K <= 32"):
        kernels.its_select(b[:, :64], torch.zeros(4, 1, 33, device=cuda_device))


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
