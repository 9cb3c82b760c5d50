"""The port's training substrate: the train step against ``repro``'s, and
the contracts of ``tests/test_train.py`` (optimizers, checkpoints, fault
tolerance, the pipeline) on the port.

``repro``'s ``make_train_step`` runs here on a one-device mesh with
``Auto`` axes: under JAX 0.9 ``jax.make_mesh`` gives ``Explicit`` axes,
which ``with_sharding_constraint`` refuses (the reason
``test_train.py::test_loss_decreases_on_learnable_data`` fails here).  It
sets a global activation mesh, which a fixture resets.

The train step's tolerances, and why, are stated beside
``TRAIN_LOSS_RTOL`` (``lm_reference.py``); ``test_torch_lm.py`` holds the
optimizer itself to 1e-5 on equal gradients.  The expert and recurrent
configs' train, prefill and serve steps are in
``test_torch_train_moe_recurrent.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from lm_reference import (  # noqa: E402,F401 (the autouse fixture)
    TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL, TRAIN_STATE_TOL, learnable_batch, no_activation_mesh,
    reference_mesh)
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, flatten  # noqa: E402
from repro_torch.train.fault import StepMonitor, largest_mesh_shape, run_with_recovery  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_prefill, make_serve_step, make_train_step)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(reference_mesh, microbatches):
    """Five steps of ``internlm2``'s smoke config on the learnable batch,
    each side on its own trajectory: each step's loss and gradient norm,
    and the parameters and first moments after the last, against
    ``repro``'s jitted step (with 2 microbatches: the f32 accumulation of
    both)."""
    rcfg = dataclasses.replace(ref_smoke_config("internlm2-1.8b"), microbatches=microbatches)
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), microbatches=microbatches)
    ocfg = dict(kind="adamw", lr=3e-3, warmup_steps=2)
    rparams = ref_model.init_params(jax.random.PRNGKey(0), rcfg)
    init = jax.tree_util.tree_map(np.asarray, rparams)
    ropt = ref_opt.opt_init(ref_opt.OptConfig(**ocfg), rparams)
    model = tm.DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init, cfg))
    ostate = opt_init(OptConfig(**ocfg), dict(model.named_parameters()))
    ref_step, _ = ref_make_train_step(rcfg, ref_opt.OptConfig(**ocfg), reference_mesh)
    step_fn = make_train_step(cfg, OptConfig(**ocfg), device="cpu")
    batch = learnable_batch()
    rstep, step = jnp.zeros((), jnp.int32), 0
    for _ in range(5):
        rparams, ropt, rstep, rm = ref_step(rparams, ropt, rstep,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
        ostate, step, m = step_fn(model, ostate, step, batch)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=TRAIN_GNORM_RTOL)
        assert step == int(rstep) == m["step"]
    zeros = jax.tree_util.tree_map(np.zeros_like, init)
    for ref_tree, got_tree, start in (
            (rparams, params_to_numpy(model.state_dict(), cfg), init),
            (ropt["mu"], params_to_numpy(ostate["mu"], cfg), zeros)):
        want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, ref_tree))[0]
        for (path, a), b, a0 in zip(want, jax.tree_util.tree_leaves(got_tree),
                                    jax.tree_util.tree_leaves(start)):
            moved = np.abs(a - a0).max()
            assert moved > 0, jax.tree_util.keystr(path)
            err = np.abs((b - a0) - (a - a0)).max()
            assert err <= TRAIN_STATE_TOL * moved, (jax.tree_util.keystr(path), err, moved)


def test_bf16_remat_train_step_matches_reference(reference_mesh):
    """One step of ``gemma3_1b``'s smoke config with the full config's
    numerics (bf16, ``remat="full"``, 2 microbatches) from ``repro``'s
    weights, at full lr: the loss and gradient norm, each leaf's first
    moment (the microbatches' f32 sum, scaled) and the direction each
    parameter moved, against ``repro``'s step.  Tolerances are bf16's
    (measured: loss 4.2e-5 relative, gradient norm 1.4e-3, first moments
    4.5e-2 in the 2-norm; Adam's first step moves an entry by about lr
    whatever its gradient's size, so where the two bf16 gradients straddle
    0 the moves part: at most 3.1 % of a leaf's entries)."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16", remat="full", microbatches=2)
    rcfg = dataclasses.replace(ref_smoke_config("gemma3_1b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("gemma3_1b"), **kw)
    ocfg = dict(kind="adamw", lr=1e-2, warmup_steps=1)
    rparams = ref_model.init_params(jax.random.PRNGKey(0), rcfg)
    init = [np.asarray(a.astype(jnp.float32)) for a in jax.tree_util.tree_leaves(rparams)]
    ropt = ref_opt.opt_init(ref_opt.OptConfig(**ocfg), rparams)
    model = tm.DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), cfg))
    ostate = opt_init(OptConfig(**ocfg), dict(model.named_parameters()))
    ref_step, _ = ref_make_train_step(rcfg, ref_opt.OptConfig(**ocfg), reference_mesh)
    rs = np.random.default_rng(5)
    tokens = rs.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    rparams, ropt, _, rm = ref_step(rparams, ropt, jnp.asarray(1, jnp.int32),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    ostate, step, m = make_train_step(cfg, OptConfig(**ocfg), device="cpu")(
        model, ostate, 1, batch)
    assert step == 2 and all(p.dtype == torch.bfloat16 for p in model.parameters())
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=5e-3)
    after = jax.tree_util.tree_flatten_with_path(rparams)[0]
    mu_ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ropt["mu"]))
    for (path, a), a0, b, mr, mp in zip(
            after, init, jax.tree_util.tree_leaves(params_to_numpy(model.state_dict(), cfg)),
            mu_ref, jax.tree_util.tree_leaves(params_to_numpy(ostate["mu"], cfg))):
        name = jax.tree_util.keystr(path)
        assert np.linalg.norm(mp - mr) <= 1e-1 * np.linalg.norm(mr), name
        moved = np.sign(np.asarray(a.astype(jnp.float32)) - a0)
        assert np.mean(np.sign(b - a0) == moved) >= 0.9, name


def test_loss_decreases_on_learnable_data():
    cfg = get_smoke_config("internlm2-1.8b")
    ocfg = OptConfig(kind="adamw", lr=3e-3, warmup_steps=2)
    model = tm.DecoderLM(cfg, device="cpu")
    ostate = opt_init(ocfg, dict(model.named_parameters()))
    step_fn = make_train_step(cfg, ocfg, device="cpu")
    batch, step, losses = learnable_batch(), 0, []
    for _ in range(20):
        ostate, step, m = step_fn(model, ostate, step, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses


def test_microbatch_guard():
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), microbatches=3)
    ocfg = OptConfig()
    model = tm.DecoderLM(cfg, device="cpu")
    step_fn = make_train_step(cfg, ocfg, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step_fn(model, opt_init(ocfg, dict(model.named_parameters())), 0, learnable_batch(b=4))


def test_step_refuses_a_model_of_another_config():
    model = tm.DecoderLM(get_smoke_config("gemma3_1b"), device="cpu")
    with pytest.raises(ValueError, match="built for"):
        make_prefill(get_smoke_config("internlm2_1_8b"), device="cpu")(model, learnable_batch())


def test_prefill_and_serve_step():
    """Prefill gives the last position's logits of the full forward; the
    serve step decodes one token a call, the cache updated in place."""
    cfg = get_smoke_config("gemma3_1b")
    model = tm.DecoderLM(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    last = make_prefill(cfg, device="cpu")(model, {"tokens": toks})
    with torch.no_grad():
        full, _ = tm.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    serve = make_serve_step(cfg, 2, 24, device="cpu")
    cache = tm.init_cache(cfg, 2, 24, device="cpu")
    k0 = cache["layers"][2]["k"]
    for t in range(20):
        lg, cache = serve(model, cache, toks[:, t:t + 1])
    assert cache["index"] == 20 and cache["layers"][2]["k"] is k0
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), rtol=3e-3, atol=3e-3)
    with pytest.raises(ValueError, match="tokens"):
        serve(model, cache, toks[:, :2])


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("internlm2_1_8b")
    for build in (lambda: tm.DecoderLM(cfg), lambda: tm.init_cache(cfg, 1, 4),
                  lambda: make_train_step(cfg, OptConfig()), lambda: make_prefill(cfg),
                  lambda: make_serve_step(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


class TestOptimizers:
    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_quadratic_convergence(self, kind):
        """Optimizer drives a quadratic toward its minimum."""
        target = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.full((4, 200), 0.5)}
        params = {"w": torch.zeros(3), "b": torch.zeros(4, 200)}
        cfg = OptConfig(kind=kind, lr=0.05, weight_decay=0.0, warmup_steps=1,
                        min_dim_factored=4)
        state = opt_init(cfg, params)
        loss = lambda: sum(float(torch.sum((params[k] - target[k]) ** 2)) for k in params)
        l0 = loss()
        for i in range(200):
            grads = {k: 2 * (params[k] - target[k]) for k in params}
            state, _ = opt_update(cfg, grads, state, params, i)
        assert loss() < 0.05 * l0

    def test_adafactor_state_is_factored(self):
        params = {"big": torch.zeros(256, 512), "small": torch.zeros(8)}
        state = opt_init(OptConfig(kind="adafactor"), params)
        assert set(state["v"]["big"]) == {"vr", "vc"}
        assert state["v"]["big"]["vr"].shape == (256,)
        assert state["v"]["big"]["vc"].shape == (512,)
        assert set(state["v"]["small"]) == {"v"}

    def test_adafactor_factors_each_expert_of_a_stacked_leaf(self):
        """An expert weight ``(e, d, f)`` keeps ``vr`` ``(e, d)`` and ``vc``
        ``(e, f)``: ``repro``'s ``(n_rep, e, d)`` and ``(n_rep, e, f)`` with
        the stacking undone."""
        cfg = get_smoke_config("arctic_480b")
        model = tm.DecoderLM(cfg, device="cpu")
        ocfg = OptConfig(kind="adafactor", min_dim_factored=16)
        v = opt_init(ocfg, dict(model.named_parameters()))["v"]
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert v["layers.1.moe.wi"]["vr"].shape == (e, d)
        assert v["layers.1.moe.wi"]["vc"].shape == (e, f)
        assert v["layers.1.moe.wo"]["vr"].shape == (e, f)
        assert set(v["layers.0.moe.router"]) == {"v"}  # 8 experts < 16
        rv = ref_opt.opt_init(ref_opt.OptConfig(kind="adafactor", min_dim_factored=16),
                              ref_model.abstract_params(ref_smoke_config("arctic_480b")))["v"]
        assert rv["blocks"][0]["moe"]["wi"]["vr"].shape == (cfg.n_rep, e, d)

    def test_grad_clip(self):
        params = {"w": torch.zeros(4)}
        cfg = OptConfig(kind="adamw", grad_clip=1.0, lr=1.0, warmup_steps=1)
        state = opt_init(cfg, params)
        _, gnorm = opt_update(cfg, {"w": torch.full((4,), 1e6)}, state, params, 0)
        assert float(gnorm) > 1e5
        assert float(params["w"].abs().max()) < 10.0

    def test_warmup_starts_at_zero_lr(self):
        params = {"w": torch.ones(4)}
        cfg = OptConfig(kind="adamw", lr=1.0, warmup_steps=10)
        opt_update(cfg, {"w": torch.ones(4)}, opt_init(cfg, params), params, 0)
        assert torch.equal(params["w"], torch.ones(4))

    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_bf16_params_update_in_f32(self, kind):
        """A bf16 parameter is updated in f32 and rounded once: a step far
        below bf16's spacing at 1.0 leaves it unchanged, and the state is
        f32."""
        params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
        cfg = OptConfig(kind=kind, lr=1e-4, weight_decay=0.0, warmup_steps=1)
        state = opt_init(cfg, params)
        state, _ = opt_update(cfg, {"w": torch.ones(4, 4, dtype=torch.bfloat16)}, state,
                              params, 1)
        assert params["w"].dtype == torch.bfloat16 and torch.equal(params["w"].float(),
                                                                   torch.ones(4, 4))
        assert all(t.dtype == torch.float32 for t in flatten(state))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, fingerprint="test")
        tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
        mgr.save(10, tree)
        restored, manifest = mgr.restore(tree)
        assert manifest["step"] == 10
        for x, y in zip(flatten(tree), flatten(restored)):
            assert torch.equal(x, y) and x.dtype == y.dtype

    def test_bf16_leaves_roundtrip_as_words(self, tmp_path):
        """numpy has no bf16 here: the words are stored and the dtype kept
        in the manifest; every bit comes back."""
        mgr = CheckpointManager(str(tmp_path))
        w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).bfloat16()
        mgr.save(1, {"w": w, "step": np.int32(3)})
        leaf = np.load(os.path.join(tmp_path, "step_00000001", "leaf_00001.npy"))
        assert leaf.dtype == np.uint16
        restored, manifest = mgr.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                                          "step": np.int32(0)})
        assert manifest["dtypes"] == ["int32", "bfloat16"]
        assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], w)
        assert int(restored["step"]) == 3

    def test_model_and_optimizer_state_roundtrip(self, tmp_path):
        cfg = get_smoke_config("gemma3_1b")
        model = tm.DecoderLM(cfg, seed=1, device="cpu")
        ocfg = OptConfig(kind="adafactor", min_dim_factored=16)
        ostate = opt_init(ocfg, dict(model.named_parameters()))
        step_fn = make_train_step(cfg, ocfg, device="cpu")
        ostate, step, _ = step_fn(model, ostate, 0, learnable_batch(b=2, s=16))
        mgr = CheckpointManager(str(tmp_path), fingerprint=cfg.name)
        mgr.save(step, (model.state_dict(), ostate))
        fresh = tm.DecoderLM(cfg, seed=2, device="cpu")
        template = (fresh.state_dict(), opt_init(ocfg, dict(fresh.named_parameters())))
        (sd, restored), m = mgr.restore(template)
        fresh.load_state_dict(sd)
        assert m["step"] == 1
        for x, y in zip(flatten((model.state_dict(), ostate)), flatten((fresh.state_dict(),
                                                                      restored))):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("arch", ["arctic_480b", "xlstm_350m"])
    def test_expert_and_recurrent_model_and_optimizer_state_roundtrip(self, tmp_path, arch):
        """Expert weights with their factored Adafactor moments, and the
        recurrent cells' leaves, save and restore bit for bit."""
        cfg = get_smoke_config(arch)
        model = tm.DecoderLM(cfg, seed=1, device="cpu")
        ocfg = OptConfig(kind="adafactor", min_dim_factored=16)
        ostate = opt_init(ocfg, dict(model.named_parameters()))
        ostate, step, _ = make_train_step(cfg, ocfg, device="cpu")(
            model, ostate, 0, learnable_batch(b=2, s=16))
        mgr = CheckpointManager(str(tmp_path), fingerprint=cfg.name)
        mgr.save(step, (model.state_dict(), ostate))
        fresh = tm.DecoderLM(cfg, seed=2, device="cpu")
        template = (fresh.state_dict(), opt_init(ocfg, dict(fresh.named_parameters())))
        (sd, restored), _ = mgr.restore(template)
        for x, y in zip(flatten((model.state_dict(), ostate)), flatten((sd, restored))):
            assert torch.equal(x, y)

    def test_shape_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            mgr.restore({"a": torch.zeros(4)})
        with pytest.raises(ValueError, match="leaves"):
            mgr.restore({"a": torch.zeros(3), "b": torch.zeros(1)})

    def test_keep_k_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"a": torch.zeros(3)})
        assert mgr.all_steps() == [3, 4]

    def test_async_save_snapshots_at_call(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        a = torch.arange(1000.0)
        mgr.save_async(5, {"a": a})
        a.add_(1)  # after the call: not in the checkpoint
        mgr.wait()
        restored, m = mgr.restore({"a": a})
        assert m["step"] == 5 and torch.equal(restored["a"], torch.arange(1000.0))

    def test_atomicity_no_tmp_visible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        mgr.save(1, {"a": torch.zeros(2)})
        assert all(not n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_fingerprint_mismatch_rejected(self, tmp_path):
        CheckpointManager(str(tmp_path), fingerprint="cfgA").save(1, {"a": torch.zeros(2)})
        with pytest.raises(ValueError):
            CheckpointManager(str(tmp_path), fingerprint="cfgB").restore({"a": torch.zeros(2)})

    def test_restore_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        for s in (3, 7, 11):
            mgr.save(s, {"a": torch.full((2,), float(s))})
        restored, m = mgr.restore({"a": torch.zeros(2)})
        assert m["step"] == 11 and float(restored["a"][0]) == 11.0
        assert mgr.latest_step() == 11

    def test_no_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore({"a": torch.zeros(2)})


class TestFaultTolerance:
    def test_straggler_detection(self):
        mon = StepMonitor(deadline_factor=3.0)
        for i in range(10):
            assert not mon.observe(i, 1.0)
        assert mon.observe(10, 10.0)  # 10x median
        assert mon.straggler_steps == [10]

    def test_recovery_replays_from_checkpoint(self):
        calls = {"n": 0}

        def step_fn(a, b, batch):
            return a + batch, b, {"loss": 0.0}

        def fail_first(attempt):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected node failure")

        state, metrics, attempts = run_with_recovery(
            step_fn, (1, 2), 10, restore_fn=lambda: (100, 200), fail_injector=fail_first)
        assert attempts == 1
        assert state == (110, 200)  # restored state was used

    def test_recovery_gives_up(self):
        def always_fail(attempt):
            raise RuntimeError("down")

        with pytest.raises(RuntimeError):
            run_with_recovery(lambda *a: a, (1,), 2, restore_fn=lambda: (1,), max_retries=1,
                              fail_injector=always_fail)

    def test_largest_mesh_shape(self):
        assert largest_mesh_shape(512, 16) == (32, 16)
        assert largest_mesh_shape(496, 16) == (31, 16)  # 496 = 31×16
        assert largest_mesh_shape(508, 16) == (127, 4)  # lost nodes: shrink TP
        assert largest_mesh_shape(13, 4) == (13, 1)


class TestPipeline:
    def test_deterministic_by_cursor(self):
        b1, b2 = TokenPipeline(100, 4, 16, seed=3).next(), TokenPipeline(100, 4, 16, seed=3).next()
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_state_restore_resumes_stream(self):
        p1 = TokenPipeline(100, 4, 16, seed=3)
        for _ in range(5):
            p1.next()
        state = p1.state_dict()
        expected = p1.next()
        p2 = TokenPipeline(100, 4, 16, seed=3)
        p2.load_state_dict(state)
        np.testing.assert_array_equal(expected["tokens"], p2.next()["tokens"])

    def test_labels_shifted(self):
        p = TokenPipeline(100, 4, 16, corpus=np.tile(np.arange(17)[None], (8, 1)))
        b = p.next()
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding(self):
        c = np.arange(8 * 17).reshape(8, 17) % 97
        b0 = TokenPipeline(100, 4, 16, corpus=c, host_index=0, host_count=2).next()
        b1 = TokenPipeline(100, 4, 16, corpus=c, host_index=1, host_count=2).next()
        assert b0["tokens"].shape == (2, 16)
        assert not np.array_equal(b0["tokens"], b1["tokens"])
