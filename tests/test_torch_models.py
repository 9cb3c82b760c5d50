"""The port's model layers against ``repro.models``, module by module, and
the port-only contracts of ``tests/test_models.py``'s dense tests.

Inputs come from numpy seeds; weights are built by ``repro``'s ``init_tree``
and carried across as numpy.  f32 throughout, except the two bf16 cases.
Tolerances (max abs difference over the reference's max abs): 1e-5 for the
elementwise layers and attention (measured at most 1.2e-6), bf16 cases at
bf16's resolution (2^-7 of the scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs.base import ModelConfig as RefConfig  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import blocks as ref_blocks  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.layers import set_activation_mesh  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_activation_mesh():
    """``repro``'s layers read a module-global activation mesh, which a test
    file run earlier in the same process may have left set (with
    ``Explicit`` axes, which ``ashard`` refuses): this file's reference calls
    run without one."""
    set_activation_mesh(None)


KEY = jax.random.PRNGKey(0)


def base(cls, **kw):
    d = dict(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", attn_chunk=16, remat="none",
    )
    d.update(kw)
    return cls(**d)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    err, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"max abs diff {err:.3g} over scale {scale:.3g}"


def _weights(defs, seed=0):
    """``repro``'s init of ``defs``, as numpy and as the port's tensors."""
    tree = jax.tree_util.tree_map(np.array, ref_layers.init_tree(
        jax.random.PRNGKey(seed), defs, jnp.float32))
    # zero-initialized norm scales would hide the scale term: perturb them
    tree = jax.tree_util.tree_map(
        lambda a: a + _rand(seed + 1, *a.shape, scale=0.1) if a.ndim == 1 else a, tree)
    return tree, jax.tree_util.tree_map(torch.from_numpy, tree)


# -- elementwise layers -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, scale = _rand(1, 4, 8, 256, scale=3.0), _rand(2, 256, scale=0.1)
    want = ref_layers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype))
    got = layers.rms_norm(torch.from_numpy(x).to(layers.torch_dtype(dtype)),
                          torch.from_numpy(scale).to(layers.torch_dtype(dtype)))
    assert got.dtype == layers.torch_dtype(dtype)
    _close(np.asarray(want, np.float32), got, 1e-5 if dtype == "float32" else 2**-7)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    x = _rand(3, 2, 24, 4, 32)
    pos = np.arange(24)[None] + 5
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(want, got, 1e-5)


def test_softcap():
    x = _rand(4, 64, scale=40.0)
    _close(ref_layers.softcap(jnp.asarray(x), 30.0), layers.softcap(torch.from_numpy(x), 30.0),
           1e-6)
    t = torch.from_numpy(x)
    assert layers.softcap(t, 0.0) is t  # cap 0: off


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    x, w = _rand(5, 2, 10, 8), _rand(6, 8, 4)
    st = _rand(7, 2, 3, 8) if with_state else None
    want_y, want_s = ref_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                              None if st is None else jnp.asarray(st))
    got_y, got_s = layers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                        None if st is None else torch.from_numpy(st))
    _close(want_y, got_y, 1e-6)
    _close(want_s, got_s, 0.0)


@pytest.mark.parametrize("act", sorted(layers.ACTIVATIONS))
def test_activations(act):
    """gelu/geglu are ``jax.nn.gelu``'s tanh approximation, not torch's exact
    default."""
    x = _rand(8, 1000, scale=3.0)
    _close(ref_layers.ACTIVATIONS[act](jnp.asarray(x)),
           layers.ACTIVATIONS[act](torch.from_numpy(x)), 1e-6)


# -- attention --------------------------------------------------------------


def _qkv_inputs(s, seed=0, b=2, h=4, kvh=2, dh=16):
    return _rand(seed, b, s, h, dh), _rand(seed + 1, b, s, kvh, dh), _rand(seed + 2, b, s, kvh, dh)


@pytest.mark.parametrize("s,chunk,window", [(32, 8, 0), (64, 16, 0), (64, 16, 24),
                                            (48, 12, 12), (33, 16, 0)])
def test_blocked_attention(s, chunk, window):
    """``test_models.py``'s five cases, including a length the chunk does
    not divide (33 against 16 blocks as 11)."""
    q, k, v = _qkv_inputs(s)
    want = ref_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      base(RefConfig, attn_chunk=chunk), window=window)
    got = attn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 base(ModelConfig, attn_chunk=chunk), window=window)
    _close(want, got, 1e-5)


@pytest.mark.parametrize("cap,scores", [(5.0, "f32"), (0.0, "bf16"), (5.0, "bf16")])
def test_blocked_attention_softcap_and_bf16_scores(cap, scores):
    q, k, v = (a * 3 for a in _qkv_inputs(48, seed=10))
    kw = dict(attn_chunk=16, attn_softcap=cap, attn_scores_dtype=scores)
    want = ref_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      base(RefConfig, **kw), window=20)
    got = attn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 base(ModelConfig, **kw), window=20)
    _close(want, got, 1e-5 if scores == "f32" else 2**-7)


@pytest.mark.parametrize("pick", [(33, 16, 11), (64, 16, 16), (7, 1024, 7), (1024, 512, 512)])
def test_pick_chunk(pick):
    s, chunk, want = pick
    assert attn.pick_chunk(s, chunk) == ref_attn.pick_chunk(s, chunk) == want


@pytest.mark.parametrize("window,s_max", [(0, 16), (6, 6), (6, 16)])
def test_attention_decode(window, s_max):
    """Ten tokens through ``attention_decode``: the ring buffer of a local
    layer (a cache of the window, wrapping), the clamped slot otherwise."""
    kw = dict(use_qk_norm=True, window_size=window)
    rcfg, cfg = base(RefConfig, **kw), base(ModelConfig, **kw)
    tree, params = _weights(ref_attn.attn_defs(rcfg), seed=3)
    x = _rand(11, 2, 10, 64)
    rk = jnp.zeros((2, s_max, 2, 16))
    rv = jnp.zeros((2, s_max, 2, 16))
    ck, cv = torch.zeros(2, s_max, 2, 16), torch.zeros(2, s_max, 2, 16)
    for t in range(10):
        want, rk, rv = ref_attn.attention_decode(tree, rcfg, jnp.asarray(x[:, t:t + 1]), rk, rv,
                                                 jnp.asarray(t, jnp.int32), window=window)
        got, ck2, cv2 = attn.attention_decode(params, cfg, torch.from_numpy(x[:, t:t + 1]),
                                              ck, cv, t, window=window)
        assert ck2 is ck and cv2 is cv  # written in place
        _close(want, got, 1e-5)
        _close(rk, ck, 1e-6)


@pytest.mark.parametrize("act,glu", [("geglu", True), ("swiglu", True), ("gelu", False),
                                     ("relu", False)])
def test_ffn_apply(act, glu):
    rcfg, cfg = base(RefConfig, activation=act, glu=glu), base(ModelConfig, activation=act, glu=glu)
    tree, params = _weights(ref_ffn.ffn_defs(rcfg), seed=4)
    x = _rand(12, 2, 8, 64)
    _close(ref_ffn.ffn_apply(tree, rcfg, jnp.asarray(x)),
           ffn.ffn_apply(params, cfg, torch.from_numpy(x)), 1e-5)


@pytest.mark.parametrize("kind", blocks.ATTN_KINDS)
def test_block_train(kind):
    kw = dict(window_size=12, use_qk_norm=kind == "local", attn_softcap=20.0)
    rcfg, cfg = base(RefConfig, **kw), base(ModelConfig, **kw)
    tree, params = _weights(ref_blocks.block_defs(rcfg, kind), seed=5)
    x, pos = _rand(13, 2, 32, 64), np.arange(32)[None]
    want, _ = ref_blocks.block_train(tree, rcfg, kind, jnp.asarray(x), jnp.asarray(pos))
    got, aux = blocks.block_train(params, cfg, kind, torch.from_numpy(x), torch.from_numpy(pos))
    assert float(aux) == 0.0
    _close(want, got, 1e-5)


BLOCK_CASES = {
    "rglru": dict(),
    "mlstm": dict(),
    "slstm": dict(),
    "global+moe": dict(num_experts=4, num_experts_per_tok=2, moe_dense_ff=96,
                       capacity_factor=1.0),
    "global_dense+moe": dict(num_experts=4, num_experts_per_tok=1),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_train_and_decode_of_the_other_kinds(case):
    """The recurrent blocks and the attention blocks of an expert config
    ("global" with experts and a dense FFN beside them, capacity 8 at S =
    16, so choices drop; "global_dense", the dense layer of an MoE config):
    ``block_train``'s output and aux loss, then 6 tokens of
    ``block_decode`` from ``block_cache_init`` and the cache left behind."""
    kind = case.split("+")[0]
    kw = dict(BLOCK_CASES[case], rnn_width=64)
    rcfg, cfg = base(RefConfig, **kw), base(ModelConfig, **kw)
    tree, params = _weights(ref_blocks.block_defs(rcfg, kind), seed=9)
    assert sorted(blocks.block_defs(cfg, kind)) == sorted(tree)
    x, pos = _rand(14, 2, 16, 64), np.arange(16)[None]
    want, want_aux = ref_blocks.block_train(tree, rcfg, kind, jnp.asarray(x), jnp.asarray(pos))
    got, aux = blocks.block_train(params, cfg, kind, torch.from_numpy(x), torch.from_numpy(pos))
    _close(want, got, 1e-5)
    _close(want_aux, aux, 1e-5)
    assert (float(aux) > 0) == (case == "global+moe")
    rcache = ref_blocks.block_cache_init(rcfg, kind, 2, 8, jnp.float32)
    cache = blocks.block_cache_init(cfg, kind, 2, 8, torch.float32, torch.device("cpu"))
    for t in range(6):
        want, rcache = ref_blocks.block_decode(tree, rcfg, kind, jnp.asarray(x[:, t:t + 1]),
                                               rcache, jnp.asarray(t))
        got, cache = blocks.block_decode(params, cfg, kind, torch.from_numpy(x[:, t:t + 1]),
                                         cache, t)
        _close(want, got, 1e-5)
    assert set(rcache) == set(cache)
    for name, leaf in rcache.items():
        _close(leaf, cache[name], 1e-5)


def test_unknown_block_kind_raises():
    cfg = base(ModelConfig)
    with pytest.raises(ValueError, match="unknown"):
        blocks.block_defs(cfg, "conv")
    with pytest.raises(ValueError, match="unknown"):
        blocks.block_cache_init(cfg, "conv", 1, 8, torch.float32, torch.device("cpu"))


# -- the port's own contracts (tests/test_models.py's dense tests) ----------


def _ref_attention(q, k, v, scale, window=0):
    """Naive full attention oracle (GQA via repeat), test_models.py's."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    k = np.repeat(k, g, axis=2)
    v = np.repeat(v, g, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = np.tril(np.ones((s, s), bool))
    if window:
        mask &= ~np.tril(np.ones((s, s), bool), -window)
    scores = np.where(mask[None, None], scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("s,chunk,window", [(32, 8, 0), (64, 16, 24), (33, 16, 0)])
def test_blocked_attention_matches_naive(s, chunk, window):
    q, k, v = _qkv_inputs(s, seed=20)
    got = attn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 base(ModelConfig, attn_chunk=chunk), window=window)
    np.testing.assert_allclose(got.numpy(), _ref_attention(q, k, v, 16**-0.5, window),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch,steps,max_len", [("internlm2_1_8b", 12, 16),
                                                ("gemma3_1b", 24, 32)])
def test_decode_matches_train(arch, steps, max_len):
    """Token-by-token decode equals the full forward (the local window
    included: gemma3's smoke window of 16 under 24 tokens)."""
    cfg = get_smoke_config(arch)
    model = tm.DecoderLM(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, steps)))
    cache = tm.init_cache(cfg, 2, max_len, device="cpu")
    with torch.no_grad():
        full, _ = tm.forward(model, toks)
        dec = torch.cat([tm.decode_step(model, toks[:, t:t + 1], cache)[0]
                         for t in range(steps)], dim=1)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), rtol=3e-3, atol=3e-3)


def test_rope_relative_property():
    """<rope(q,m), rope(k,n)> depends only on m-n."""
    q, k = torch.from_numpy(_rand(30, 1, 1, 1, 32)), torch.from_numpy(_rand(31, 1, 1, 1, 32))

    def dot_at(m, n):
        return float(torch.sum(layers.rope(q, torch.tensor([[m]]), 1e4)
                               * layers.rope(k, torch.tensor([[n]]), 1e4)))

    assert abs(dot_at(5, 3) - dot_at(12, 10)) < 1e-4
    assert abs(dot_at(5, 3) - dot_at(6, 3)) > 1e-6


def test_rope_preserves_norm():
    x = torch.from_numpy(_rand(32, 2, 8, 4, 32))
    y = layers.rope(x, torch.arange(8)[None], 1e4)
    np.testing.assert_allclose(torch.linalg.norm(x, dim=-1).numpy(),
                               torch.linalg.norm(y, dim=-1).numpy(), rtol=1e-5)


def test_rms_norm_unit_scale():
    y = layers.rms_norm(torch.from_numpy(_rand(33, 4, 32, scale=3.0)), torch.zeros(32))
    np.testing.assert_allclose(torch.sqrt(torch.mean(y**2, -1)).numpy(), 1.0, rtol=1e-3)


def test_rms_norm_bf16_close_to_f32():
    x = torch.from_numpy(_rand(34, 4, 256))
    y32 = layers.rms_norm(x, torch.zeros(256))
    y16 = layers.rms_norm(x.bfloat16(), torch.zeros(256, dtype=torch.bfloat16))
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0.03, atol=0.03)


def test_init_distributions():
    """The port draws ``repro``'s distributions: zeros / ones / fan-in
    normal / the RG-LRU lambda range."""
    defs = {"w": layers.ParamDef((400, 300)), "z": layers.ParamDef((5,), init="zeros"),
            "o": layers.ParamDef((5,), init="ones"),
            "lam": layers.ParamDef((4000,), init="lru_lambda")}
    tree = layers.ParamTree(defs, torch.float32, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    tree.init_from(gen)
    p = {k: v.detach() for k, v in tree.tree().items()}
    assert abs(float(p["w"].std()) - 1 / np.sqrt(400)) < 2e-3
    assert float(p["z"].abs().sum()) == 0 and float(p["o"].sum()) == 5
    a = torch.sigmoid(p["lam"]) ** 8
    assert 0.9 - 1e-5 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-5
