"""Shared pieces of the port's LM tests against ``repro``: the per-architecture
case (``repro``'s weights carried across, the same tokens on both sides),
the four tests run on every architecture, and the train step's batch, mesh
and tolerances.  ``test_torch_lm.py`` (the dense architectures),
``test_torch_lm_moe.py`` and ``test_torch_lm_recurrent.py`` each import the
four tests and bind ``case`` to their own architectures with
:func:`case_fixture`, so the suite's workers share them.

Tolerances (max abs difference over the reference's max abs, per leaf),
each set from the measured worst case on these inputs with headroom:
logits 1e-4 (measured 2.1e-5, internvl2); aux loss 1e-5 (2.3e-7, arctic);
loss 1e-6 relative (1.4e-7); gradient 1e-3 (3.5e-4: internvl2's
embedding, float association through the backward of attention and the
chunked CE); optimizer parameters and state 1e-5 (the same gradients in,
so only the update's own rounding); decode logits 1e-4.

``xlstm_350m``'s smoke stack is ill-conditioned on ``repro``'s own tree:
``repro``'s init draws a stacked leaf with the fan-in of the stacking axis
(``repro/models/layers.py:35`` reads ``shape[0]``, here n_rep = 1, so std
1; ROADMAP queue 3), and its logits then move by up to 4.5e-4 of their
scale under a 1e-7 relative jitter of the weights (three seeds,
``test_torch_lm_recurrent.py::test_xlstm_reference_spread``).  Its case
therefore loads ``repro``'s tree with each stacked leaf rescaled to the
layer's own fan-in, as the port's init draws it, and keeps the tolerances
above (measured on it: logits 2.0e-7, gradient 3.2e-6, decode 2.1e-7).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.models.layers import set_activation_mesh
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.train import optimizer as topt


@pytest.fixture(autouse=True, scope="module")
def no_activation_mesh():
    """``repro``'s layers read a module-global activation mesh, which a test
    file run earlier in the same process may have left set (with
    ``Explicit`` axes, which ``ashard`` refuses): a file that imports this
    fixture runs its reference calls without one."""
    set_activation_mesh(None)


NEW = ("arctic_480b", "llama4_maverick_400b_a17b", "recurrentgemma_9b", "xlstm_350m")
B, S, DECODE = 2, 32, 12
LOGITS_TOL, GRAD_TOL, DECODE_TOL = 1e-4, 1e-3, 1e-4
# the stacked leaves of these archs' cases are rescaled to the layer's fan-in
PER_LAYER_FAN_IN = ("xlstm_350m",)


def _close(ref, got, tol, what):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: max abs diff {err:.3g} over scale {scale:.3g}"


def _close_trees(ref_tree, got_tree, tol, what):
    ref_l = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got_l = jax.tree_util.tree_leaves(got_tree)
    assert len(ref_l) == len(got_l)
    for (path, a), b in zip(ref_l, got_l):
        _close(a, b, tol, f"{what}{jax.tree_util.keystr(path)}")


def _per_layer_fan_in(rparams, rcfg):
    """``repro``'s tree with each stacked leaf drawn from a normal rescaled
    from the stacking axis's fan-in (n_rep) to the layer's own."""
    def fix(p, d):
        if d.init != "normal":
            return p
        layer = d.shape[1:]
        fan_in = layer[0] if len(layer) >= 2 else max(layer[0], 1)
        return p * np.float32(np.sqrt(d.shape[0] / fan_in))

    out = dict(rparams)
    out["blocks"] = jax.tree_util.tree_map(fix, rparams["blocks"],
                                           ref_model.model_defs(rcfg)["blocks"])
    return out


class Case:
    """One architecture: ``repro``'s params and the port's model on the
    same weights, the tokens and the frontend embeddings."""

    def __init__(self, arch):
        self.arch = arch
        self.rcfg, self.cfg = ref_smoke_config(arch), get_smoke_config(arch)
        self.rparams = ref_model.init_params(jax.random.PRNGKey(0), self.rcfg)
        if arch in PER_LAYER_FAN_IN:
            self.rparams = _per_layer_fan_in(self.rparams, self.rcfg)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.rparams)
        self.model = tm.DecoderLM(self.cfg, device="cpu")
        self.model.load_state_dict(params_from_jax(self.np_params, self.cfg), strict=True)
        rs = np.random.default_rng(sum(map(ord, arch)))
        self.tokens = rs.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        self.labels = np.roll(self.tokens, -1, axis=1)
        self.labels[:, -1] = -100  # a masked position
        self.fe = (rs.standard_normal((B, self.cfg.frontend_tokens, self.cfg.d_model))
                   .astype(np.float32) if self.cfg.frontend != "none" else None)
        self.ref_value_and_grad = jax.jit(jax.value_and_grad(self.ref_loss))
        # ``repro``'s loss and gradient at its initial weights, computed once
        # for the case's tests
        self.ref_grad_at_init = functools.cache(
            lambda: self.ref_value_and_grad(self.rparams))

    def jfe(self):
        return None if self.fe is None else jnp.asarray(self.fe)

    def tfe(self):
        return None if self.fe is None else torch.from_numpy(self.fe)

    def ref_loss(self, params):
        return ref_model.loss_fn(params, self.rcfg, jnp.asarray(self.tokens),
                                 jnp.asarray(self.labels), self.jfe())


def case_fixture(archs):
    """A module fixture ``case`` over ``archs``: one architecture's case,
    built once, so pytest runs its tests together."""
    @pytest.fixture(scope="module", params=archs)
    def case(request) -> Case:
        return Case(request.param)
    return case


def test_forward_logits_match_reference(case):
    c, arch = case, case.arch
    want, want_aux = ref_model.forward(c.rparams, c.rcfg, jnp.asarray(c.tokens), c.jfe())
    with torch.no_grad():
        got, aux = tm.forward(c.model, torch.from_numpy(c.tokens), c.tfe())
    total = S + (c.cfg.frontend_tokens if c.cfg.frontend != "none" else 0)
    assert got.shape == (B, total, c.cfg.vocab_size) and aux.dtype == torch.float32
    _close(want, got.numpy(), LOGITS_TOL, f"{arch} logits")
    _close(want_aux, aux.numpy(), 1e-5, f"{arch} aux")
    assert (float(aux) > 0) == bool(c.cfg.num_experts)


def test_loss_and_gradient_match_reference(case):
    c, arch = case, case.arch
    want, grads = c.ref_grad_at_init()
    loss = tm.loss_fn(c.model, torch.from_numpy(c.tokens), torch.from_numpy(c.labels), c.tfe())
    names, params = zip(*c.model.named_parameters())
    got = torch.autograd.grad(loss, params)
    _close(want, loss.detach().numpy(), 1e-6, f"{arch} loss")
    _close_trees(jax.tree_util.tree_map(np.asarray, grads),
                 params_to_numpy(dict(zip(names, got)), c.cfg), GRAD_TOL,
                 f"{arch} grad")


def _port_state_tree(state, cfg):
    """The port's optimizer state in ``repro``'s tree layout."""
    if "mu" in state:
        return {k: params_to_numpy(state[k], cfg) for k in ("mu", "nu")}
    leaves = {}
    for name, v in state["v"].items():
        for sub, t in v.items():
            leaves[f"{name}.{sub}"] = t
    # params_to_numpy nests by the dotted names: "<param>.v" / ".vr" / ".vc"
    return {"v": params_to_numpy(leaves, cfg)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(case, kind):
    """Three updates, both sides fed ``repro``'s gradient at ``repro``'s
    current parameters; the parameters and the state after each."""
    c, arch = case, case.arch
    # factor matrices of 16 or more a side, so the smoke widths reach
    # Adafactor's factored moments; every smoke n_rep is below 16, so a
    # stacked (n_rep, d) norm stays unfactored like the port's (d,) ones
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
        _close(rnorm, norm.numpy(), 1e-5, f"{arch} grad norm")
        _close_trees(jax.tree_util.tree_map(np.asarray, rparams),
                     params_to_numpy(model.state_dict(), c.cfg), 1e-5, f"{arch} params")
        _close_trees(jax.tree_util.tree_map(np.asarray, rstate),
                     _port_state_tree(state, c.cfg), 1e-5, f"{arch} {kind} state")


def test_decode_matches_reference_and_forward(case):
    """12 decode steps from an empty cache: the logits equal ``repro``'s
    decode and the port's own full forward at those positions.  A decode
    step routes one token a group, which never drops a choice, so the
    forward it is held against runs with room for every choice too."""
    c, arch = case, case.arch
    toks = c.tokens[:, :DECODE]
    rcache = ref_model.init_cache(c.rcfg, B, 16)
    cache = tm.init_cache(c.cfg, B, 16, device="cpu")
    step = jax.jit(lambda p, t, ch: ref_model.decode_step(p, c.rcfg, t, ch))
    want, got = [], []
    with torch.no_grad():
        for t in range(DECODE):
            lg, rcache = step(c.rparams, jnp.asarray(toks[:, t:t + 1]), rcache)
            want.append(np.asarray(lg[:, 0]))
            lg, cache = tm.decode_step(c.model, torch.from_numpy(toks[:, t:t + 1]), cache)
            got.append(lg[:, 0].numpy())
        full, _ = tm.forward(_no_drops(c.model), torch.from_numpy(toks))
    assert cache["index"] == DECODE == int(rcache["index"])
    _close(np.stack(want, 1), np.stack(got, 1), DECODE_TOL, f"{arch} decode")
    np.testing.assert_allclose(full.numpy(), np.stack(got, 1), rtol=3e-3, atol=3e-3)


def _no_drops(model):
    """``model``, or for an expert config a copy on the same weights whose
    capacity holds every (token, choice) of a group."""
    cfg = model.cfg
    if not cfg.num_experts:
        return model
    wide = tm.DecoderLM(dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts)),
                        device="cpu")
    wide.load_state_dict(model.state_dict())
    return wide


# -- the train step ------------------------------------------------------------

# Each side follows its own trajectory, and Adam divides a gradient entry by
# its own magnitude: where an entry is near float noise, the two gradients'
# association differences become differences of a fraction of lr in the
# weight, which the next steps carry on.  The parameters are compared by
# their change over the five steps, each leaf's difference over the largest
# change the reference made to it (a step that updated nothing scores 1),
# and the first moments, which start at 0, over their own scale (measured
# worst over the five steps: loss 1.4e-5 relative, gradient norm 4.7e-4,
# parameter change 1.1e-2, first moments 1.2e-3).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_STATE_TOL = 1e-4, 2e-3, 3e-2


def learnable_batch(b=4, s=32):
    """``test_train.py``'s learnable corpus: a fixed repeating pattern."""
    base = np.arange(s + 1) % 7 + 1
    return {"tokens": np.tile(base[:-1], (b, 1)).astype(np.int32),
            "labels": np.tile(base[1:], (b, 1)).astype(np.int32)}


@pytest.fixture
def reference_mesh():
    """A one-device mesh with ``Auto`` axes for ``repro``'s train step: under
    JAX 0.9 ``jax.make_mesh`` gives ``Explicit`` axes, which
    ``with_sharding_constraint`` refuses.  The step sets a global activation
    mesh, reset after the test."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    yield mesh
    set_activation_mesh(None)
