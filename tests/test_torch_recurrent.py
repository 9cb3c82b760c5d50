"""The port's recurrent cells against ``repro.models.recurrent``: RG-LRU,
mLSTM and sLSTM, their train forms, their decode steps and the states
those leave behind.

Weights come from ``repro``'s ``init_tree`` and are carried across as numpy;
inputs from numpy seeds.  Tolerances (max abs difference over the
reference's max abs), each set from the measured worst case on these inputs
with headroom (CPU, torch 2.x against JAX 0.9):

- f32: ``TOL`` = 5e-6 for every cell, train and decode, the states and
  the gradients (measured worst 6.8e-7, sLSTM's train form; RG-LRU 1.7e-7,
  its scan associating as ``jax.lax.associative_scan``; mLSTM 6.9e-7, the
  gradient of ``bif``).
- bf16 activations and weights: ``BF16_TOL`` = 2^-6 of the scale, two of
  bf16's steps (measured worst 6.8e-3, mLSTM's train form).
- The port's own decode against its own train form: ``repro``'s tolerances
  in ``tests/test_models.py`` (rtol / atol 1e-4 / 1e-5; mLSTM 2e-3 / 2e-4).
- Gradients at 1,024 tokens: per case (``LONG_CASES``), the sLSTM at the
  full config's widths within 3e-2, where ``repro``'s own gradient norm
  moves by 4.5e-3 under a 1e-7 weight jitter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs.base import ModelConfig as RefConfig  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.layers import set_activation_mesh  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_activation_mesh():
    """``repro``'s layers read a module-global activation mesh, which a test
    file run earlier in the same process may have left set (with
    ``Explicit`` axes, which ``ashard`` refuses): this file's reference calls
    run without one."""
    set_activation_mesh(None)


TOL, BF16_TOL = 5e-6, 2.0**-6
CELLS = ("rglru", "mlstm", "slstm")


def base(cls, **kw):
    d = dict(
        name="t", family="ssm", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", attn_chunk=16, remat="none",
        rnn_width=64, conv1d_width=4,
    )
    d.update(kw)
    return cls(**d)


def _close(ref, got, tol, what=""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max abs diff {err:.3g} over scale {scale:.3g}"


class Cell:
    """One cell kind under ``repro``'s config ``kw``: the reference's
    weights (``init_tree``, biases perturbed so they count) and the port's
    tensors of the same values, in ``dtype``."""

    def __init__(self, kind, dtype="float32", **kw):
        kw = dict(dict(dtype=dtype, param_dtype=dtype), **kw)
        self.kind = kind
        self.rcfg, self.cfg = base(RefConfig, **kw), base(ModelConfig, **kw)
        defs = getattr(ref_rec, f"{kind}_defs")(self.rcfg)
        tree = jax.tree_util.tree_map(np.array, ref_layers.init_tree(
            jax.random.PRNGKey(sum(map(ord, kind))), defs, jnp.float32))
        rs = np.random.default_rng(7)
        for name in ("ba", "bi", "bif", "bx"):
            if name in tree:
                tree[name] = tree[name] + rs.standard_normal(tree[name].shape).astype(np.float32)
        jdt = jnp.dtype(dtype)
        self.rparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), tree)
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        self.params = {k: torch.from_numpy(v).to(tdt) for k, v in tree.items()}
        self.jdt, self.tdt = jdt, tdt

    def inputs(self, b, s, seed=0):
        d = self.cfg.d_model
        x = (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5).astype(np.float32)
        return jnp.asarray(x).astype(self.jdt), torch.from_numpy(x).to(self.tdt)

    def ref_train(self, params, x):
        return getattr(ref_rec, f"{self.kind}_train")(params, self.rcfg, x)

    def train(self, jx, tx):
        want = jax.jit(self.ref_train)(self.rparams, jx)
        got = getattr(rec, f"{self.kind}_train")(self.params, self.cfg, tx)
        return want, got

    def decode(self, jx, tx):
        """Token by token from the initial state: both sides' outputs
        (B, S, D) and final states."""
        b, s = tx.shape[:2]
        rstate = getattr(ref_rec, f"{self.kind}_init_state")(self.rcfg, b, self.jdt)
        state = getattr(rec, f"{self.kind}_init_state")(self.cfg, b, self.tdt, "cpu")
        rstep = jax.jit(lambda p, x, st: getattr(ref_rec, f"{self.kind}_decode")(
            p, self.rcfg, x, st))
        want, got = [], []
        for t in range(s):
            y, rstate = rstep(self.rparams, jx[:, t:t + 1], rstate)
            want.append(y)
            y, state = getattr(rec, f"{self.kind}_decode")(self.params, self.cfg,
                                                          tx[:, t:t + 1], state)
            got.append(y)
        return jnp.concatenate(want, 1), torch.cat(got, 1), rstate, state


@pytest.mark.parametrize("s", [1, 10, 32, 33])
def test_affine_scan_is_the_recurrence(s):
    """``H[t] = a[t]·H[t-1] + b[t]``, against the loop, at every parity of
    the recursion's levels (lengths 1, 10, 32, 33)."""
    rs = np.random.default_rng(s)
    a = torch.from_numpy(rs.uniform(0.5, 1.0, (3, s, 5)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((3, s, 5)).astype(np.float32))
    big_a, h = rec.affine_scan(a, b)
    want_h, want_a = torch.zeros(3, 5), torch.ones(3, 5)
    for t in range(s):
        want_h, want_a = a[:, t] * want_h + b[:, t], a[:, t] * want_a
        torch.testing.assert_close(h[:, t], want_h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(big_a[:, t], want_a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [10, 33, 64])
@pytest.mark.parametrize("kind", CELLS)
def test_train_matches_reference(kind, s):
    """The train form at lengths that split the scan unevenly (33) and,
    for mLSTM, into 1, 3 and 4 chunks of ``attn_chunk`` 16 (pick_chunk 10,
    11 and 16)."""
    c = Cell(kind)
    want, got = c.train(*c.inputs(2, s, seed=s))
    _close(want, got, TOL, f"{kind} train S={s}")


@pytest.mark.parametrize("kind", CELLS)
def test_decode_and_state_match_reference(kind):
    """Twelve tokens through the decode step from the initial state: every
    output, and every leaf of the state left behind."""
    c = Cell(kind)
    want, got, rstate, state = c.decode(*c.inputs(2, 12, seed=3))
    _close(want, got, TOL, f"{kind} decode")
    assert set(rstate) == set(state)
    for name in rstate:
        assert state[name].dtype == (torch.float32 if name != "conv" else c.tdt), name
        _close(rstate[name], state[name], TOL, f"{kind} state {name}")


@pytest.mark.parametrize("kind", CELLS)
def test_bf16_matches_reference(kind):
    """bf16 activations and weights (f32 gates and states): the train form
    and eight decode steps."""
    c = Cell(kind, "bfloat16")
    jx, tx = c.inputs(2, 24, seed=5)
    want, got = c.train(jx, tx)
    assert got.dtype == torch.bfloat16
    _close(want, got, BF16_TOL, f"{kind} bf16 train")
    want, got, _, _ = c.decode(jx[:, :8], tx[:, :8])
    _close(want, got, BF16_TOL, f"{kind} bf16 decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_bf16_reduce_matches_reference(dtype):
    """``reduce_dtype="bf16"`` (``xlstm_350m``'s full config) casts the f32
    state and ``r`` to bf16 before the recurrent product: a change of
    values, which the port makes too.  Train and decode, f32 and bf16
    activations."""
    c = Cell("slstm", dtype, reduce_dtype="bf16")
    jx, tx = c.inputs(2, 16, seed=9)
    want, got = c.train(jx, tx)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(want, got, tol, f"slstm reduce bf16 train ({dtype})")
    if dtype == "float32":
        # the cast shows: without it the output is 2.1e-3 of the scale away
        _, plain = Cell("slstm", dtype).train(jx, tx)
        err = float((plain - got).abs().max()) / float(got.abs().max())
        assert err > 100 * TOL, err
    want, got, rstate, state = c.decode(jx[:, :8], tx[:, :8])
    _close(want, got, tol, f"slstm reduce bf16 decode ({dtype})")
    for name in rstate:
        _close(rstate[name], state[name], tol, f"slstm reduce bf16 state {name}")


@pytest.mark.parametrize("kind", CELLS)
def test_train_gradient_matches_reference(kind):
    """The gradient of ``sum(y · w)`` through the train form, by autograd
    against ``jax.grad``: every weight and the input."""
    c = Cell(kind)
    jx, tx = c.inputs(2, 20, seed=11)
    wts = np.random.default_rng(12).standard_normal((2, 20, 64)).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(c.ref_train(p, x) * wts),
                              argnums=(0, 1)))(c.rparams, jx)
    params = {k: v.clone().requires_grad_(True) for k, v in c.params.items()}
    tx = tx.clone().requires_grad_(True)
    y = getattr(rec, f"{kind}_train")(params, c.cfg, tx)
    torch.sum(y * torch.from_numpy(wts)).backward()
    _close(gx, tx.grad, TOL, f"{kind} grad x")
    for name, g in gp.items():
        _close(g, params[name].grad, TOL, f"{kind} grad {name}")


# At 1,024 tokens, the length the card trains at, the two sides' rounding
# differences grow along the sequence: each case's bound is set from its
# measured worst leaf with headroom.  At the full config's widths the sLSTM
# is ill-conditioned there: ``repro``'s own gradient norm moves by 4.5e-3
# under a 1e-7 relative jitter of the weights, which the test asserts.
LONG_CASES = [("rglru", 64, TOL), ("mlstm", 64, 3e-4), ("slstm", 1024, 3e-2)]


@pytest.mark.parametrize("kind,width,tol", LONG_CASES)
def test_gradient_at_1024_tokens_matches_reference(kind, width, tol):
    """The gradient of ``sum(y · w)`` through the train form at 1,024
    tokens, by autograd against ``jax.grad``: every weight, the input, and
    the global norm a clip would read.  Measured worst leaf: RG-LRU 4.9e-7
    and mLSTM 3.3e-5 (4 chunks of 256) at the test width; the sLSTM at the
    full config's widths (d_model 1,024, 4 heads) 7.3e-3 (``r``), its norm
    6.8e-3 apart (130,715 against ``repro``'s 131,603, where at 128 tokens
    both read 10,796)."""
    c = Cell(kind, d_model=width, rnn_width=width, head_dim=width // 4, attn_chunk=256)
    jx, tx = c.inputs(1, 1024, seed=11)
    wts = np.random.default_rng(12).standard_normal((1, 1024, width)).astype(np.float32)
    ref_grad = jax.jit(jax.grad(lambda p, x: jnp.sum(c.ref_train(p, x) * wts), argnums=(0, 1)))
    gp, gx = ref_grad(c.rparams, jx)
    params = {k: v.clone().requires_grad_(True) for k, v in c.params.items()}
    tx = tx.clone().requires_grad_(True)
    y = getattr(rec, f"{kind}_train")(params, c.cfg, tx)
    torch.sum(y * torch.from_numpy(wts)).backward()
    _close(gx, tx.grad, tol, f"{kind} grad x")
    for name, g in gp.items():
        _close(g, params[name].grad, tol, f"{kind} grad {name}")
    norm = lambda grads: np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                                     for g in grads.values()))
    want = norm(gp)
    got = np.sqrt(sum(float(params[n].grad.double().square().sum()) for n in gp))
    assert abs(got - want) <= tol * want, (got, want)
    if width == 1024:
        # the bound's floor: ``repro``'s own norm moves by more than 1e-3
        # under a 1e-7 relative jitter of the weights (measured 4.5e-3)
        rs = np.random.default_rng(1)
        jittered = jax.tree_util.tree_map(
            lambda a: a * (1 + 1e-7 * rs.standard_normal(a.shape).astype(np.float32)), c.rparams)
        assert abs(norm(ref_grad(jittered, jx)[0]) - want) > 1e-3 * want


# -- the port's own contracts (tests/test_models.py's recurrent tests) ------


@pytest.mark.parametrize("kind,chunk,rtol,atol", [("rglru", 16, 1e-4, 1e-5),
                                                  ("mlstm", 5, 2e-3, 2e-4),
                                                  ("slstm", 16, 1e-4, 1e-5)])
def test_train_decode_equivalence(kind, chunk, rtol, atol):
    c = Cell(kind, attn_chunk=chunk, num_heads=2 if kind == "mlstm" else 4)
    _, tx = c.inputs(2, 10, seed=2)
    with torch.no_grad():
        y_train = getattr(rec, f"{kind}_train")(c.params, c.cfg, tx)
        _, y_dec, _, _ = c.decode(jnp.asarray(tx.numpy()), tx)
    np.testing.assert_allclose(y_train.numpy(), y_dec.numpy(), rtol=rtol, atol=atol)


def test_rglru_state_bounded():
    """|a| < 1 keeps the LRU state bounded over long rollouts."""
    c = Cell("rglru")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 500, 64))
                         .astype(np.float32))
    with torch.no_grad():
        y = rec.rglru_train(c.params, c.cfg, x)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 1e3


def test_init_states_are_repro_s():
    """The initial states: shapes, dtypes and values (mLSTM's ``m`` at
    -1e9, sLSTM's ``n`` at 1e-6)."""
    for kind in CELLS:
        c = Cell(kind, "bfloat16")
        want = getattr(ref_rec, f"{kind}_init_state")(c.rcfg, 3, jnp.bfloat16)
        got = getattr(rec, f"{kind}_init_state")(c.cfg, 3, torch.bfloat16, "cpu")
        assert set(want) == set(got)
        for name, a in want.items():
            assert got[name].dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                                       else torch.float32)
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          got[name].float().numpy())


def test_defs_are_repro_s():
    """The same leaves, shapes and initializers as ``repro``'s defs."""
    for kind in CELLS:
        for kw in ({}, dict(rnn_width=48, conv1d_width=3, mlstm_proj_factor=1.5)):
            rcfg, cfg = base(RefConfig, **kw), base(ModelConfig, **kw)
            want = getattr(ref_rec, f"{kind}_defs")(rcfg)
            got = getattr(rec, f"{kind}_defs")(cfg)
            assert list(want) == list(got)
            for name, d in want.items():
                assert dataclasses.astuple(got[name]) == (d.shape, d.init, d.scale), name
