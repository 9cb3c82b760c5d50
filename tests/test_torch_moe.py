"""The port's mixture-of-experts layer against ``repro.models.moe``: the
router (top-k and the sampled C-SAW router), the sort-based capacity
dispatch with its drops, the experts, the combine and the aux loss.

Weights come from ``repro``'s ``init_tree`` and are carried across as numpy;
inputs from numpy seeds.  Tolerances (max abs difference over the
reference's max abs), set from the measured worst case with headroom (CPU,
torch 2.x against JAX 0.9): ``TOL`` = 5e-6 in f32 for ``y``, the aux loss
and the gradients (measured worst 4.3e-7, the gradient of ``wi``);
``BF16_TOL`` = 2^-6 of the scale in bf16 (measured worst 4.8e-3).  The
routes themselves (which expert, which token dropped) are compared exactly,
and the sampled router's picks bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import set_activation_mesh  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_activation_mesh():
    """``repro``'s layers read a module-global activation mesh, which a test
    file run earlier in the same process may have left set (with
    ``Explicit`` axes, which ``ashard`` refuses): this file's reference calls
    run without one."""
    set_activation_mesh(None)


TOL, BF16_TOL = 5e-6, 2.0**-6


def _close(ref, got, tol, what=""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max abs diff {err:.3g} over scale {scale:.3g}"


class Layer:
    """An MoE layer of ``arch``'s smoke config (with ``kw``): ``repro``'s
    weights and the port's tensors of the same values, in ``dtype``."""

    def __init__(self, arch="arctic_480b", dtype="float32", **kw):
        kw = dict(dict(dtype=dtype, param_dtype=dtype), **kw)
        self.rcfg = dataclasses.replace(ref_smoke_config(arch), **kw)
        self.cfg = dataclasses.replace(get_smoke_config(arch), **kw)
        tree = jax.tree_util.tree_map(np.array, ref_layers.init_tree(
            jax.random.PRNGKey(4), ref_moe.moe_defs(self.rcfg), jnp.float32))
        jdt = jnp.dtype(dtype)
        self.rparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), tree)
        self.tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        self.params = {k: torch.from_numpy(v).to(self.tdt) for k, v in tree.items()}
        self.jdt = jdt

    def inputs(self, b, s, seed=0):
        x = np.random.default_rng(seed).standard_normal((b, s, self.cfg.d_model)).astype(np.float32)
        return jnp.asarray(x).astype(self.jdt), torch.from_numpy(x).to(self.tdt)

    def ref_apply(self, params, x, key=None):
        return ref_moe.moe_apply(params, self.rcfg, x, rng=key)


def _dropped(cfg, idx, s):
    """(token, choice) pairs past their expert's capacity, counted from the
    routes ``idx`` (G, S, k)."""
    e = cfg.num_experts
    counts = np.stack([np.bincount(row.ravel(), minlength=e) for row in np.asarray(idx)])
    return int(np.maximum(counts - moe.capacity(cfg, s), 0).sum())


@pytest.mark.parametrize("arch,b,s", [("arctic_480b", 2, 32), ("arctic_480b", 3, 8),
                                      ("llama4_maverick_400b_a17b", 2, 32)])
def test_moe_apply_matches_reference(arch, b, s):
    """``(y, aux)`` of the smoke configs: arctic (8 experts, top-2, capacity
    10 at S = 32, so tokens drop; capacity 4 at S = 8) and llama4 (4
    experts, top-1, capacity 10 at S = 32)."""
    lay = Layer(arch)
    jx, tx = lay.inputs(b, s, seed=s)
    want_y, want_aux = jax.jit(lay.ref_apply)(lay.rparams, jx)
    y, aux = moe.moe_apply(lay.params, lay.cfg, tx)
    _close(want_y, y, TOL, f"{arch} y")
    _close(want_aux, aux, TOL, f"{arch} aux")
    _, idx, _ = ref_moe._route(lay.rparams, lay.rcfg, jx, None)
    if arch == "arctic_480b" and s == 32:
        assert _dropped(lay.cfg, idx, s) > 0  # the case drops tokens


def test_routes_and_drops_are_repro_s():
    """Exactly the same expert picks, and a token row gets nothing back
    exactly where ``repro``'s does (every choice of it dropped): the
    arctic case at capacity factor 0.25, where most choices drop."""
    lay = Layer(capacity_factor=0.25)
    jx, tx = lay.inputs(2, 64, seed=1)
    rg, ridx, rprobs = ref_moe._route(lay.rparams, lay.rcfg, jx, None)
    g, idx, probs = moe._route(lay.params, lay.cfg, tx, None)
    np.testing.assert_array_equal(np.asarray(ridx), idx.numpy())
    _close(rg, g, TOL, "gates")
    _close(rprobs, probs, TOL, "probs")
    want_y, _ = lay.ref_apply(lay.rparams, jx)
    y, _ = moe.moe_apply(lay.params, lay.cfg, tx)
    empty = np.linalg.norm(np.asarray(want_y), axis=-1) == 0
    assert empty.any()
    np.testing.assert_array_equal(empty, y.norm(dim=-1).numpy() == 0)
    _close(want_y, y, TOL, "y")


def test_top_k_breaks_ties_to_the_lower_index():
    """``lax.top_k``'s order among equal probabilities: the lower expert
    first."""
    cfg = get_smoke_config("arctic_480b")
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0, 0.0, 0.0, 0.0],
                          [0.25, 0.0, 0.0, 0.25, 0.0, 0.25, 0.25, 0.0]])
    gates, idx = moe.select_experts(cfg, probs)
    want_g, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    assert idx.tolist() == [[1, 2], [0, 3]]
    np.testing.assert_allclose(gates.numpy(), [[0.5, 0.5], [0.5, 0.5]])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampled_router_is_bit_for_bit(seed):
    """The sampled router on ``repro``'s probabilities under
    ``jax.random.PRNGKey(seed)``: ``idx`` and ``gates`` equal to the bit
    (Gumbel bits of the counted RNG, XLA's log, ties to the lower index)."""
    lay = Layer(router_mode="sampled")
    jx, _ = lay.inputs(2, 32, seed=seed)
    gates, idx, probs = ref_moe._route(lay.rparams, lay.rcfg, jx, jax.random.PRNGKey(seed))
    tg, ti = moe.select_experts(lay.cfg, torch.from_numpy(np.array(probs)),
                                rng.PRNGKey(seed))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tg.numpy().view(np.uint32),
                                  np.asarray(gates).view(np.uint32))
    _, top = jax.lax.top_k(probs, 2)
    assert (np.asarray(idx) != np.asarray(top)).any()  # sampling, not top-k


def test_sampled_moe_apply_matches_reference():
    """``moe_apply`` under the sampled router with a key, against
    ``repro``'s with the same key."""
    lay = Layer(router_mode="sampled")
    jx, tx = lay.inputs(2, 16, seed=4)
    want_y, want_aux = jax.jit(lay.ref_apply)(lay.rparams, jx, jax.random.PRNGKey(1))
    y, aux = moe.moe_apply(lay.params, lay.cfg, tx, rng.PRNGKey(1))
    _close(want_y, y, TOL, "sampled y")
    _close(want_aux, aux, TOL, "sampled aux")
    y2, _ = moe.moe_apply(lay.params, lay.cfg, tx, rng.PRNGKey(2))
    assert not torch.allclose(y, y2)  # stochastic


def test_bf16_matches_reference():
    """bf16 activations and weights (f32 router probabilities and gates;
    the combine's scatter-add in bf16)."""
    lay = Layer(dtype="bfloat16")
    jx, tx = lay.inputs(2, 32, seed=6)
    want_y, want_aux = jax.jit(lay.ref_apply)(lay.rparams, jx)
    y, aux = moe.moe_apply(lay.params, lay.cfg, tx)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(want_y, y, BF16_TOL, "bf16 y")
    _close(want_aux, aux, TOL, "bf16 aux")


def test_gradient_matches_reference():
    """The gradient of ``sum(y · w) + aux`` by autograd against
    ``jax.grad``, with drops: router, experts and input."""
    lay = Layer()
    jx, tx = lay.inputs(2, 32, seed=8)
    wts = np.random.default_rng(9).standard_normal((2, 32, lay.cfg.d_model)).astype(np.float32)

    def ref_loss(p, x):
        y, aux = lay.ref_apply(p, x)
        return jnp.sum(y * wts) + aux

    gp, gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(lay.rparams, jx)
    params = {k: v.clone().requires_grad_(True) for k, v in lay.params.items()}
    tx = tx.clone().requires_grad_(True)
    y, aux = moe.moe_apply(params, lay.cfg, tx)
    (torch.sum(y * torch.from_numpy(wts)) + aux).backward()
    _close(gx, tx.grad, TOL, "grad x")
    for name, g in gp.items():
        _close(g, params[name].grad, TOL, f"grad {name}")


def test_capacity_is_repro_s_arithmetic():
    """``max(int(s·k/e·capacity_factor), 4)``, float arithmetic and all."""
    for arch in ("arctic_480b", "llama4_maverick_400b_a17b"):
        for cfg in (get_smoke_config(arch), get_config(arch)):
            for s in (1, 7, 8, 32, 100, 1024):
                k, e = cfg.num_experts_per_tok, cfg.num_experts
                assert moe.capacity(cfg, s) == max(int(s * k / e * cfg.capacity_factor), 4)
    assert moe.capacity(get_smoke_config("arctic_480b"), 32) == 10


# -- the port's own contracts (tests/test_models.py's MoE tests) -----------


def test_capacity_drops_tokens():
    lay = Layer(num_experts=4, num_experts_per_tok=1, capacity_factor=0.25)
    _, tx = lay.inputs(1, 64, seed=0)
    y, _ = moe.moe_apply(lay.params, lay.cfg, tx)
    assert (y[0].norm(dim=-1) < 1e-6).any()


def test_decode_shape_never_drops():
    """One token a group (decode): capacity 4, at most one choice an expert,
    so nothing drops and every row gets its experts' output."""
    lay = Layer()
    _, tx = lay.inputs(8, 1, seed=2)
    y, aux = moe.moe_apply(lay.params, lay.cfg, tx)
    assert y.shape == tx.shape and bool((y.norm(dim=-1) > 0).all()) and float(aux) > 0


def test_sampled_routing_marginals():
    """C-SAW sampled routing: the first pick's frequency tracks the router
    probabilities (Plackett-Luce first draw == softmax)."""
    lay = Layer(num_experts=4, num_experts_per_tok=1, router_mode="sampled")
    _, tx = lay.inputs(1, 1, seed=0)
    _, _, probs = moe._route(lay.params, lay.cfg, tx[0], None)
    sel = [int(moe.select_experts(lay.cfg, probs, rng.PRNGKey(i))[1][0, 0])
           for i in range(800)]
    counts = np.bincount(sel, minlength=4) / 800
    np.testing.assert_allclose(counts, probs[0].numpy(), atol=0.06)
