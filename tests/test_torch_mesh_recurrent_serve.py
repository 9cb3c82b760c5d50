"""The port's mesh-aware steps across 4 gloo ranks, continued: the
recurrent layers' sharded code and the serve path on a sharded mesh, against
one process (``test_torch_mesh.py`` says how these tests close the chain to
``repro``).

One job of 4 child processes (``torch_mesh_child.four_rank_more``, 300 s
timeout) runs, on the (data 2, model 2) mesh, 2 train steps of two smoke
configs from the one-process step's weights and global batch of 8, as
``test_torch_mesh_ranks.py`` does for three others:

- ``recurrentgemma_9b``: the RG-LRU's width on ``model``, its scan on each
  rank's rows, the causal conv's pad;
- ``xlstm_350m``: the mLSTM's heads and its q-chunks, the sLSTM's state made
  in the activations' layout;

then ``gemma3_1b``'s prefill and 2 greedy decode steps from a cache placed
by ``shard_cache``: its single kv head does not divide ``model``, so the
cache splits its sequence over ``model`` (split-KV).

Tolerances (f32): losses and gradient norms within 1e-6 relative (measured
1.5e-7 and 1.2e-7), parameters within 1e-4 absolute (4.3e-6 and 2.1e-5), as
in ``test_torch_mesh_ranks.py``; prefill and decode logits within 1e-5 of
their scale (measured 4.5e-7 and 4.9e-7), and equal greedy tokens.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_mesh_child  # noqa: E402
from test_torch_mesh_ranks import close  # noqa: E402

ARCHS = ("recurrentgemma_9b", "xlstm_350m")
SERVE_ARCHS = ("gemma3_1b",)
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def four():
    return torch_mesh_child.run("four_rank_more", 4, archs=list(ARCHS),
                                serve_archs=list(SERVE_ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_recurrent_steps_match_one_process(four, arch):
    assert four["mesh"] == [2, 2]
    close(four["train"][arch])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_one_process(four, arch):
    """Prefill of 4 × 24 tokens and 2 greedy decode steps on the (2, 2)
    mesh against one process: gemma3's single kv head does not divide
    ``model``, so the cache splits its sequence over ``model`` (split-KV),
    each token written on the rank whose shard holds its slot."""
    res = four["serve"][arch]
    assert res["prefill_err"] <= LOGIT_RTOL * res["prefill_scale"], res
    for err, scale in zip(res["decode_err"], res["decode_scale"]):
        assert err <= LOGIT_RTOL * scale, res
    assert res["tokens_mesh"] == res["tokens"]
