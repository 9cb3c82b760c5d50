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

- ``xlstm_350m`` again in ``tp_mode="model"``: with its 2 heads, which
  the ``model`` axis divides (the mLSTM's q blocks with their heads on
  ``model``), and with 3 heads at a width of 48, which it does not divide
  (as the full config's 4 heads do not divide 16): the mLSTM's blocked
  form as a region on each rank's batch and q-chunk rows, the sLSTM's
  recurrence split over ``model``;

then prefill and 2 greedy decode steps from a cache placed by
``shard_cache`` at 4 rows: ``gemma3_1b``, whose single kv head does not
divide ``model``, so the cache splits its sequence over ``model``
(split-KV), and ``xlstm_350m``; the same for ``gemma3_1b``,
``recurrentgemma_9b`` and ``xlstm_350m`` at a batch of 1, which the
``data`` axis does not split: the decode step keeps the weights in their
FSDP shards, each product partial sums over ``data``; and the xLSTM's split
config at 4 rows and at 1, its mLSTM decode products and the sLSTM's
recurrence split over ``model``.

Tolerances (f32): losses and gradient norms within 1e-6 relative (measured
1.5e-7 and 1.2e-7), parameters within 1e-4 absolute (4.3e-6 and 2.1e-5; the
xLSTM's split and heads-on-model configs 3.1e-5 and 2.5e-5), as in
``test_torch_mesh_ranks.py``; prefill and decode logits within 1e-5 of
their scale (measured at most 6.5e-7 over the seven serve runs), and equal
greedy tokens.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_mesh_child  # noqa: E402
from test_torch_mesh_ranks import close  # noqa: E402

ARCHS = ("recurrentgemma_9b", "xlstm_350m")
SPLIT_ARCHS = ("xlstm_350m",)
SERVE_ARCHS = ("gemma3_1b", "xlstm_350m")
SINGLE_ARCHS = ("gemma3_1b", "recurrentgemma_9b", "xlstm_350m")
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def four():
    return torch_mesh_child.run("four_rank_more", 4, archs=list(ARCHS),
                                serve_archs=list(SERVE_ARCHS), split_archs=list(SPLIT_ARCHS),
                                single_archs=list(SINGLE_ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_recurrent_steps_match_one_process(four, arch):
    assert four["mesh"] == [2, 2]
    close(four["train"][arch])


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_heads_model_does_not_divide_match_one_process(four, arch):
    """The xLSTM with 3 heads on (data 2, model 2), ``tp_mode="model"``:
    the dry run's ``xlstm-350m × train_4k`` on 2 × 16 × 16 in small."""
    close(four["train"][f"{arch}_split"])


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_heads_on_model_match_one_process(four, arch):
    """The xLSTM's smoke config (2 heads) on (data 2, model 2) in
    ``tp_mode="model"``: the mLSTM's blocked form with each q block's heads
    on ``model``, through the same driver as the plain step."""
    close(four["train"][f"{arch}_model"])


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


@pytest.mark.parametrize("arch", SINGLE_ARCHS)
def test_batch_of_one_decode_matches_one_process(four, arch):
    """Prefill of 1 × 24 tokens and 2 greedy decode steps on the (2, 2)
    mesh against one process: the decode step keeps the weights' FSDP
    shards, so each product is partial sums over ``data``, reduced in f32."""
    res = four["serve"][f"{arch}_rows1"]
    assert res["prefill_err"] <= LOGIT_RTOL * res["prefill_scale"], res
    for err, scale in zip(res["decode_err"], res["decode_scale"]):
        assert err <= LOGIT_RTOL * scale, res
    assert res["tokens_mesh"] == res["tokens"]


@pytest.mark.parametrize("rows", (4, 1))
@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_heads_model_does_not_divide_decode_matches_one_process(four, arch, rows):
    """Prefill of ``rows`` × 24 tokens and 2 greedy decode steps of the
    xLSTM's split config (3 heads, ``tp_mode="model"``) on the (2, 2) mesh
    against one process."""
    res = four["serve"][f"{arch}_split_rows{rows}"]
    assert res["prefill_err"] <= LOGIT_RTOL * res["prefill_scale"], res
    for err, scale in zip(res["decode_err"], res["decode_scale"]):
        assert err <= LOGIT_RTOL * scale, res
    assert res["tokens_mesh"] == res["tokens"]
