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
