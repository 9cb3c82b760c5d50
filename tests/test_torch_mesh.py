"""The port's mesh-aware steps on a world of one: mesh (1, 1) against the
steps without a mesh, and the elastic restore onto a smaller mesh.

The port's steps without a mesh are held against ``repro``'s
(``test_torch_train*.py``, ``test_torch_lm*.py``), so a mesh step equal to
the port's step without a mesh is held to ``repro``'s too; this file and
``test_torch_mesh_ranks.py`` (4 ranks) close that chain.  Every process
group lives in child processes (``torch_mesh_child.run``, gloo over a
``FileStore``, a 300 s timeout each): the pytest worker starts none.

On a mesh of one every placement is whole (an axis of size 1 replicates),
and the mesh steps run the same kernels in the same order as the steps
without a mesh: the losses, gradient norms, updated parameters, prefill
logits and decode logits are equal, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_mesh_child  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402

SERVE_ARCHS = ("gemma3_1b", "recurrentgemma_9b")


@pytest.fixture(scope="module")
def one_rank():
    return torch_mesh_child.run("one_rank_steps", 1, archs=list(ARCH_IDS),
                                serve_archs=list(SERVE_ARCHS))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_a_mesh_of_one(one_rank, arch):
    """One train step (AdamW or the config's Adafactor, lr 1e-3) of the
    smoke config from the same weights and batch, on the (1, 1) mesh and
    without a mesh: equal loss, gradient norm and updated parameters."""
    assert one_rank["mesh"] == [1, 1]
    res = one_rank["train"][arch]
    assert res["mesh"] == res["plain"]
    assert res["param_equal"], res["param_err"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_on_a_mesh_of_one(one_rank, arch):
    """Prefill of 4 × 24 tokens and 2 greedy decode steps of a dense and a
    recurrent architecture: equal logits and tokens on and off the mesh."""
    res = one_rank["serve"][arch]
    assert res["prefill_equal"] and res["decode_equal"]
    assert res["tokens"] == res["tokens_mesh"]


def test_elastic_restore_across_meshes(tmp_path):
    """A checkpoint written from a (2, 2) mesh of 4 ranks (its leaves
    whole), restored by 2 ranks onto ``elastic_remesh(model_axis=2)``'s
    (1, 2) mesh: equal leaves, the weight a DTensor spanning both ranks."""
    ckpt = str(tmp_path / "elastic")
    saved = torch_mesh_child.run("elastic_save", 4, directory=ckpt)
    assert saved == {"mesh": [2, 2], "w_local": [4, 4]}
    res = torch_mesh_child.run("elastic_restore", 2, directory=ckpt)
    assert res["mesh"] == [1, 2] and res["step"] == 3
    np.testing.assert_array_equal(res["w"], np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(res["b"], np.ones(4))
    assert res["w_ranks"] == [0, 1] and res["w_local"] == [8, 4]
