"""The port's decoder LMs against ``repro``'s, architecture by architecture:
the six dense architectures, then ``gemma3_1b``'s smoke config with the full
config's numerics, and the configs' and weights' contracts of all ten.

For each ``SMOKE`` config, ``repro``'s weights are carried across by
``params_from_jax`` and the same numpy-seeded tokens go through both:
``forward``'s logits and aux loss, ``loss_fn`` and its gradient (autograd
against ``jax.value_and_grad``), three ``opt_update`` steps under AdamW and
under Adafactor fed the same gradients, and a 12-token decode, all in f32
(the four tests and their tolerances: ``lm_reference.py``; the expert and
recurrent architectures run them in ``test_torch_lm_moe.py`` and
``test_torch_lm_recurrent.py``).  Then ``gemma3_1b``'s smoke config with the
full config's numerics (bf16, ``remat="full"``, 2 microbatches): its loss,
gradient and optimizer steps against ``repro``'s, and its gradient with and
without remat.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from lm_reference import (  # noqa: E402,F401 (the shared tests and autouse fixture)
    NEW, S, _close, _close_trees, _port_state_tree, case_fixture, no_activation_mesh,
    test_decode_matches_reference_and_forward, test_forward_logits_match_reference,
    test_loss_and_gradient_match_reference, test_optimizer_steps_match_reference)
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

case = case_fixture(tuple(a for a in ARCH_IDS if a not in NEW))


# -- the timed numerics: bf16, remat="full" ----------------------------------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16", remat="full", microbatches=2)
# bf16 rounds each side's activations at its own op boundaries, so the two
# gradients differ by rounding noise the size of bf16's own error.  In the
# 2-norm, |port - repro| / |repro| is at most BF16_LEAF_TOL per leaf
# (measured worst 5.9e-2, while either side is 8.4e-2 to 8.6e-2 from the
# f32 gradient) and BF16_GRAD_TOL over the whole gradient (measured 3.0e-2,
# while the port is 5.8e-2 from the f32 gradient: it rounds where ``repro``
# rounds; an rms_norm left in f32 gives 6.9e-2, its variance summed in
# bf16 5.5e-2).  The loss within 2e-4 relative (measured 4.2e-5).
BF16_LEAF_TOL, BF16_GRAD_TOL, BF16_LOSS_RTOL = 1e-1, 4.5e-2, 2e-4


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class Bf16Case:
    """``gemma3_1b``'s smoke config with the full config's numerics, as the
    chip's ``lm_gemma3_1b`` phase trains it: bf16 activations and
    parameters, ``remat="full"``, 2 microbatches, on ``repro``'s bf16
    weights."""

    def __init__(self):
        self.rcfg = dataclasses.replace(ref_smoke_config("gemma3_1b"), **BF16)
        self.cfg = dataclasses.replace(get_smoke_config("gemma3_1b"), **BF16)
        self.rparams = ref_model.init_params(jax.random.PRNGKey(0), self.rcfg)
        self.model = tm.DecoderLM(self.cfg, device="cpu")
        self.model.load_state_dict(
            params_from_jax(jax.tree_util.tree_map(np.asarray, self.rparams), self.cfg))
        rs = np.random.default_rng(5)
        self.tokens = rs.integers(0, self.cfg.vocab_size, (4, S)).astype(np.int32)
        self.labels = np.roll(self.tokens, -1, axis=1)
        self.labels[:, -1] = -100
        self.ref_value_and_grad = jax.jit(jax.value_and_grad(self.ref_loss))
        self.ref_grad_at_init = functools.cache(
            lambda: self.ref_value_and_grad(self.rparams))

    def ref_loss(self, params):
        return ref_model.loss_fn(params, self.rcfg, jnp.asarray(self.tokens),
                                 jnp.asarray(self.labels))

    def port_grads(self, model):
        loss = tm.loss_fn(model, torch.from_numpy(self.tokens), torch.from_numpy(self.labels))
        names, params = zip(*model.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def _f32_leaves(tree):
    return [np.asarray(jnp.asarray(a).astype(jnp.float32))
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def bf16_case() -> Bf16Case:
    return Bf16Case()


def test_bf16_remat_loss_and_gradient_match_reference(bf16_case):
    """The loss, every leaf of the gradient and the whole gradient against
    ``repro``'s in bf16."""
    c = bf16_case
    want, grads = c.ref_grad_at_init()
    loss, got = c.port_grads(c.model)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want), rtol=BF16_LOSS_RTOL)
    assert all(g.dtype == torch.bfloat16 for g in got.values())
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
    ref_l = _f32_leaves(grads)
    got_l = jax.tree_util.tree_leaves(params_to_numpy(got, c.cfg))
    for name, a, b in zip(names, ref_l, got_l):
        assert _norm_rel(b, a) <= BF16_LEAF_TOL, (name, _norm_rel(b, a))
    ref_all, got_all = (np.concatenate([x.ravel() for x in ls]) for ls in (ref_l, got_l))
    assert _norm_rel(got_all, ref_all) <= BF16_GRAD_TOL, _norm_rel(got_all, ref_all)


def test_bf16_remat_gives_no_remat_gradient(bf16_case):
    """``remat="full"`` recomputes each repetition's forward in its
    backward: the same loss and the same gradient, bit for bit."""
    c = bf16_case
    plain = tm.DecoderLM(dataclasses.replace(c.cfg, remat="none"), device="cpu")
    plain.load_state_dict(c.model.state_dict())
    loss, grads = c.port_grads(c.model)
    loss_n, grads_n = c.port_grads(plain)
    assert torch.equal(loss, loss_n)
    for name, g in grads.items():
        assert torch.equal(g, grads_n[name]), name


def _bf16_words(x):
    """A bf16 value widened to f32, as its 16-bit word (signed int)."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_bf16_optimizer_steps_match_reference(bf16_case, kind):
    """Three updates of the bf16 parameters, both sides fed ``repro``'s
    gradient: each is updated in f32 and rounded once to bf16, so the
    parameters agree to one bf16 step (measured: at most 3 of 242,688
    entries one step apart) and the f32 state to 1e-5."""
    c = bf16_case
    ocfg = dict(kind=kind, lr=1e-2, warmup_steps=2, min_dim_factored=16)
    rcfg_o, tcfg_o = ref_opt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    model = tm.DecoderLM(c.cfg, device="cpu")
    model.load_state_dict(c.model.state_dict())
    params = dict(model.named_parameters())
    rparams, rstate = c.rparams, ref_opt.opt_init(rcfg_o, c.rparams)
    state = topt.opt_init(tcfg_o, params)
    for step in range(3):
        _, g = c.ref_grad_at_init() if step == 0 else c.ref_value_and_grad(rparams)
        tg = params_from_jax(jax.tree_util.tree_map(np.asarray, g), c.cfg)
        rparams, rstate, rnorm = ref_opt.opt_update(rcfg_o, g, rstate, rparams,
                                                    jnp.asarray(step, jnp.int32))
        state, norm = topt.opt_update(tcfg_o, tg, state, params, step, model.update_groups())
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        _close(rnorm, norm.numpy(), 1e-5, f"bf16 {kind} grad norm")
        got = jax.tree_util.tree_leaves(params_to_numpy(model.state_dict(), c.cfg))
        for a, b in zip(_f32_leaves(rparams), got):
            assert np.abs(_bf16_words(a) - _bf16_words(b)).max() <= 1
        _close_trees(jax.tree_util.tree_map(np.asarray, rstate),
                     _port_state_tree(state, c.cfg), 1e-5, f"bf16 {kind} state")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_repro_s(arch):
    """Every ``CONFIG`` and ``SMOKE`` is a field-for-field copy."""
    from repro.configs import get_config as ref_config

    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.layer_kinds() == theirs.layer_kinds()
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_dict_holds_param_count(arch):
    """The port's modules hold as many parameters as ``repro``'s tree, and
    for the attention-only configs ``param_count()`` of them (the formula
    counts no norms or qk-norms; those are the remainder; for the recurrent
    cells it is an approximation, in ``repro`` too)."""
    cfg = get_smoke_config(arch)
    model = tm.DecoderLM(cfg, device="cpu")
    total = sum(p.numel() for p in model.parameters())
    ref = ref_model.abstract_params(ref_smoke_config(arch))
    assert total == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(ref))
    if set(cfg.layer_kinds()) <= {"global", "local", "global_dense"}:
        norms = sum(p.numel() for n, p in model.named_parameters() if "norm" in n)
        proj = model.frontend_proj.numel() if cfg.frontend != "none" else 0
        assert total - norms - proj == cfg.param_count()


@pytest.mark.parametrize("arch", ["gemma3_1b", "internvl2_26b"])
def test_bf16_weights_carry_across_bit_for_bit(arch):
    """bf16 leaves (``ml_dtypes`` arrays) are read by their words; the
    inverse widens them to f32 exactly, in ``repro``'s stacked layout."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), param_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    rparams = ref_model.init_params(jax.random.PRNGKey(3), rcfg)
    model = tm.DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), cfg))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    back = params_to_numpy(model.state_dict(), cfg)
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = jax.tree_util.tree_leaves(back)
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_weights_round_trip(arch, dtype):
    """The expert (``moe``) and recurrent (``rnn``, ``cell``) subtrees carry
    across and back leaf for leaf, bit for bit, in ``repro``'s stacked
    layout; the port's forward on them equals ``repro``'s."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), param_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=dtype)
    rparams = ref_model.init_params(jax.random.PRNGKey(5), rcfg)
    model = tm.DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), cfg),
                          strict=True)
    subtree = {"arctic_480b": "moe", "llama4_maverick_400b_a17b": "moe",
               "recurrentgemma_9b": "rnn", "xlstm_350m": "cell"}[arch]
    assert any(f".{subtree}." in n for n, _ in model.named_parameters())
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = jax.tree_util.tree_leaves(params_to_numpy(model.state_dict(), cfg))
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b,
                                      err_msg=jax.tree_util.keystr(path))
    if dtype == "float32":
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
        ref_logits, _ = ref_model.forward(rparams, rcfg, jnp.asarray(toks))
        with torch.no_grad():
            logits, _ = tm.forward(model, torch.from_numpy(toks))
        _close(ref_logits, logits.numpy(), 1e-4, f"{arch} round-trip logits")


# -- the port's own contracts (tests/test_arch_smoke.py) ---------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_train_and_decode_finite(arch):
    """One loss, gradient and AdamW step, and two decode steps from a cache
    of 64, all finite, with the shapes ``test_arch_smoke.py`` asks for."""
    cfg = get_smoke_config(arch)
    model = tm.DecoderLM(cfg, seed=0, device="cpu")
    rs = np.random.default_rng(0)
    toks = torch.from_numpy(rs.integers(0, cfg.vocab_size, (2, 32)))
    fe = (torch.from_numpy(rs.standard_normal((2, cfg.frontend_tokens, cfg.d_model))
                           .astype(np.float32)) if cfg.frontend != "none" else None)
    ocfg = topt.OptConfig(kind="adamw", lr=1e-3, warmup_steps=1)
    params = dict(model.named_parameters())
    state = topt.opt_init(ocfg, params)
    loss = tm.loss_fn(model, toks, toks, fe)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert np.isfinite(float(loss.detach()))
    _, gnorm = topt.opt_update(ocfg, grads, state, params, 0)
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    cache = tm.init_cache(cfg, 2, 64, device="cpu")
    with torch.no_grad():
        tm.decode_step(model, toks[:, :1], cache)
        lg, cache = tm.decode_step(model, toks[:, :1], cache)
    assert lg.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(lg).all())
    assert cache["index"] == 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_sane(arch):
    """The exact assigned configs: structural invariants only (no alloc)."""
    cfg = get_config(arch)
    assert cfg.num_heads % cfg.num_kv_heads == 0
    assert len(cfg.layer_kinds()) == cfg.num_layers
    assert cfg.n_rep * len(cfg.pattern) + cfg.n_tail == cfg.num_layers
    n = cfg.param_count()
    assert n > 1e8, f"{arch}: implausibly small param count {n}"
    if cfg.num_experts:
        assert cfg.active_param_count() < n


def test_assigned_param_counts():
    """Named sizes land near the assignment (approximate formulas)."""
    expect = {
        "xlstm_350m": (0.2e9, 0.5e9),
        "gemma3_1b": (0.8e9, 1.3e9),
        "internlm2_1_8b": (1.5e9, 2.2e9),
        "gemma_7b": (7.5e9, 9.5e9),
        "starcoder2_3b": (2.6e9, 3.5e9),
        "recurrentgemma_9b": (8e9, 11e9),
        "arctic_480b": (430e9, 520e9),
        "llama4_maverick_400b_a17b": (360e9, 440e9),
        "musicgen_medium": (1.0e9, 1.8e9),
        "internvl2_26b": (17e9, 27e9),
    }
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B outside [{lo/1e9},{hi/1e9}]"
