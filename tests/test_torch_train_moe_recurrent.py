"""The port's train, prefill and serve steps for the expert and recurrent
smoke configs (``arctic_480b``, ``llama4_maverick_400b_a17b``,
``recurrentgemma_9b``, ``xlstm_350m``) against ``repro``'s, as
``test_torch_train.py`` holds the dense ones: ``repro``'s jitted train step
on a one-device mesh with ``Auto`` axes (``lm_reference.reference_mesh``),
each side on its own trajectory, at the train step's tolerances
(``lm_reference.TRAIN_LOSS_RTOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from lm_reference import (  # noqa: E402,F401 (the autouse fixture)
    NEW, TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL, learnable_batch, no_activation_mesh,
    reference_mesh)
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_init  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_prefill, make_serve_step, make_train_step)

# xLSTM starts from the port's init (each layer's own fan-in), which both
# sides load: ``repro``'s stacked init is ill-conditioned there (ROADMAP
# queue 3; ``test_torch_lm_recurrent.py``)
PORT_INIT = ("xlstm_350m",)


@pytest.mark.parametrize("arch", NEW)
def test_train_step_of_experts_and_recurrent_cells_matches_reference(reference_mesh, arch):
    """Three steps of the expert and recurrent smoke configs (arctic and
    llama4 with Adafactor, as their full configs; recurrentgemma and xLSTM
    with AdamW) on a learnable batch of 2 × 16, against ``repro``'s jitted
    step, each side on its own trajectory: each step's loss and gradient
    norm (the first step's warm-up lr is 0; measured worst over the three
    steps 4.6e-7 and 2.0e-4 relative, recurrentgemma's third)."""
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    kind = "adafactor" if cfg.num_experts else "adamw"
    ocfg = dict(kind=kind, lr=3e-3, warmup_steps=2, min_dim_factored=16)
    model = tm.DecoderLM(cfg, device="cpu")
    if arch in PORT_INIT:
        rparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
            {k: v.detach() for k, v in model.state_dict().items()}, cfg))
    else:
        rparams = ref_model.init_params(jax.random.PRNGKey(0), rcfg)
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), cfg))
    ropt = ref_opt.opt_init(ref_opt.OptConfig(**ocfg), rparams)
    ostate = opt_init(OptConfig(**ocfg), dict(model.named_parameters()))
    ref_step, _ = ref_make_train_step(rcfg, ref_opt.OptConfig(**ocfg), reference_mesh)
    step_fn = make_train_step(cfg, OptConfig(**ocfg), device="cpu")
    batch = learnable_batch(b=2, s=16)
    rstep, step = jnp.zeros((), jnp.int32), 0
    for i in range(3):
        rparams, ropt, rstep, rm = ref_step(rparams, ropt, rstep,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
        ostate, step, m = step_fn(model, ostate, step, batch)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=TRAIN_GNORM_RTOL)
        assert step == int(rstep)


@pytest.mark.parametrize("arch", NEW)
def test_loss_decreases_on_learnable_data_with_experts_and_recurrent_cells(arch):
    cfg = get_smoke_config(arch)
    ocfg = OptConfig(kind="adamw", lr=3e-3, warmup_steps=2)
    model = tm.DecoderLM(cfg, device="cpu")
    ostate = opt_init(ocfg, dict(model.named_parameters()))
    step_fn = make_train_step(cfg, ocfg, device="cpu")
    batch, step, losses = learnable_batch(), 0, []
    for _ in range(20):
        ostate, step, m = step_fn(model, ostate, step, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_serve_step_with_experts_and_recurrent_cells(arch):
    """As above for the expert and recurrent configs: the serve step stores
    each recurrent layer's new state in the cache (an attention layer's
    buffers stay the same tensors), and its last logits equal the forward's.
    A decode step never drops a choice, so an expert config runs here with
    room for every choice of a group in the forward too."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    model = tm.DecoderLM(cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    last = make_prefill(cfg, device="cpu")(model, {"tokens": toks})
    with torch.no_grad():
        full, _ = tm.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    serve = make_serve_step(cfg, 2, 24, device="cpu")
    cache = tm.init_cache(cfg, 2, 24, device="cpu")
    first = list(cache["layers"])
    for t in range(20):
        lg, cache = serve(model, cache, toks[:, t:t + 1])
    assert cache["index"] == 20
    for kind, c0, c in zip(cfg.layer_kinds(), first, cache["layers"]):
        assert (c is c0) == (kind in ("global", "local", "global_dense")), kind
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), rtol=3e-3, atol=3e-3)
    with pytest.raises(ValueError, match="cache"):
        serve(model, tm.init_cache(cfg, 3, 24, device="cpu"), toks[:, :1])
