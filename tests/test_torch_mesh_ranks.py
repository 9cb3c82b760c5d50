"""The port's mesh-aware train step across 4 gloo ranks against the
one-process step (``test_torch_mesh.py`` says how these tests close the
chain to ``repro``).

One job of 4 child processes (``torch_mesh_child.four_rank_steps``, 300 s
timeout) runs, on the (data 2, model 2) mesh, 2 train steps (steps 1 and 2,
lr 1e-3 from the first) of three smoke configs from the one-process step's
weights and global batch of 8:

- ``internlm2_1_8b``: 2 kv heads on ``model``, an untied vocabulary head;
- ``gemma3_1b``: 1 kv head, which does not divide ``model`` (replicated,
  repeated to the 4 heads, which do), a tied head through the
  vocabulary-split cross entropy;
- ``arctic_480b``: 8 experts on ``model``, the dispatch in local regions;

then ``internlm2_1_8b`` at 2 microbatches, the guard on a microbatch the
data group does not divide, the launcher's rows by rank, and the int8
compressed pod gradients on (pod 2, data 1, model 2).  The recurrent configs
and the split-KV decode run in ``test_torch_mesh_recurrent_serve.py``, a job
of their own, so that ``--dist loadfile`` runs the two beside each other.

Tolerances (f32; the mesh sums the same products in other orders): each
step's loss and gradient norm within 1e-6 relative (measured at most 7.6e-8
and 1.1e-7), the parameters after both updates within 1e-4 absolute, a
tenth of one AdamW step of lr 1e-3: the normalized update turns last-bit
differences of gradients near zero into differences of up to a whole step
(measured at most 2.7e-5, gemma3's).  Compressed against plain: the
loss within 5 % relative, ``repro``'s criterion
(``test_multidevice.py::test_compressed_pod_gradients``), and the gradient
against its int8 bound, as :func:`test_compressed_pod_gradients` says
(measured: loss 7.1e-8 relative; each leaf's error at most 0.998 of its
bound; at most 1.2e-4 of a leaf's entries off the emulation; the norm 8e-8
relative from the emulation's, 2.9e-4 from the one-process norm against a
bound of 0.18; parameters 2.1e-7 where the sign is sure, 1.5e-3 elsewhere).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_mesh_child  # noqa: E402

ARCHS = ("internlm2_1_8b", "gemma3_1b", "arctic_480b")
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-4


@pytest.fixture(scope="module")
def four():
    return torch_mesh_child.run("four_rank_steps", 4, archs=list(ARCHS),
                                mb_arch="internlm2_1_8b")


def close(res):
    plain, mesh = np.array(res["plain"]), np.array(res["mesh"])
    np.testing.assert_allclose(mesh, plain, rtol=LOSS_RTOL)
    assert res["param_err"] <= PARAM_ATOL, res["param_err"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_one_process(four, arch):
    assert four["mesh"] == [2, 2]
    close(four["train"][arch])


def test_microbatches_match_one_process(four):
    """2 microbatches of 4 rows: each microbatch the global batch's rows,
    split over the data group, its gradient kept in the parameters'
    layout."""
    close(four["microbatches"])


def test_microbatch_guard(four):
    """A batch of 2 at 2 microbatches leaves a microbatch of 1 row for a
    data group of 2: the step raises rather than replicate compute."""
    assert four["guard"] and "not divisible by batch-sharding group 2" in four["guard"]


def test_launcher_rows_by_rank(four):
    """The launcher on the (2, 2) mesh: ranks that differ only along
    ``model`` read the same rows; the two data coordinates read disjoint
    halves that together make the one-process batch, each step."""
    by_coord = {tuple(r["coord"]): r["rows"] for r in four["rows"]}
    assert sorted(by_coord) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in (0, 1):
        assert by_coord[(d, 0)] == by_coord[(d, 1)]
    for step, whole in enumerate(four["one_process_rows"]):
        assert by_coord[(0, 0)][step] + by_coord[(1, 0)][step] == whole
        assert len(by_coord[(0, 0)][step]) == len(whole) // 2


def test_rp_einsum_reduces_in_its_dtype(four):
    """A bf16 product whose contraction is split over ``model``: with
    ``reduce_dtype="f32"`` the f32 partial sums are added, then rounded
    once to bf16 (within one bf16 rounding, 2^-8 relative, of the f32
    product); with ``"bf16"`` each rank's partial is rounded first (within
    two roundings)."""
    res = four["rp_einsum"]
    for mode, rounds in (("f32", 1), ("bf16", 2)):
        assert res[mode]["dtype"] == "torch.bfloat16"
        assert res[mode]["err"] <= rounds * 2.0 ** -8 * res[mode]["scale"], (mode, res[mode])
    assert res["f32"]["err"] <= res["bf16"]["err"]


def test_compressed_pod_gradients(four):
    """The int8 pod reduction against one process (``torch_mesh_child
    ._compressed``): ``repro``'s criterion (the loss within 5 %), then the
    gradient itself.  Each leaf within its int8 bound of the whole batch's
    gradient (half a quantum a pod, plus 1e-6 of the leaf's scale for the
    sums' order) and equal to the per-tensor emulation but for rounding
    flips at half a quantum (at most 1 % of a leaf's entries); the gradient
    norm within the bound's 2-norm of the one-process norm and 1e-5 of the
    emulation's; the parameters after the step within ``PARAM_ATOL`` of the
    one-process step's where ``|g|`` is above twice its leaf's bound, and
    within two AdamW steps elsewhere."""
    res = four["compressed"]
    rel = abs(res["compressed"][0] - res["plain"][0]) / abs(res["plain"][0])
    assert rel < 0.05, res
    assert rel <= LOSS_RTOL, res  # the loss is computed before any gradient
    for name, leaf in res["leaves"].items():
        assert leaf["err"] <= leaf["bound"] + 1e-6 * leaf["scale"], (name, leaf)
        assert leaf["flip_share"] <= 0.01, (name, leaf)
    norm = res["compressed"][1]
    assert abs(norm - res["norm"]) <= res["norm_bound"], res
    assert abs(norm - res["emul_norm"]) <= 1e-5 * res["emul_norm"], res
    assert res["step_err"]["sure"] <= PARAM_ATOL, res["step_err"]
    assert res["step_err"]["unsure"] <= 2 * res["lr"] + PARAM_ATOL, res["step_err"]
