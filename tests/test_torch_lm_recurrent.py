"""The port's recurrent decoder LMs (``xlstm_350m``, ``recurrentgemma_9b``)
against ``repro``'s: logits, loss, gradient, optimizer steps and decode, as
``test_torch_lm.py`` holds the dense ones (the tests and their tolerances:
``lm_reference.py``), and why the xLSTM case rescales ``repro``'s tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from lm_reference import (  # noqa: E402,F401 (the shared tests and autouse fixture)
    LOGITS_TOL, Case, case_fixture, no_activation_mesh,
    test_decode_matches_reference_and_forward, test_forward_logits_match_reference,
    test_loss_and_gradient_match_reference, test_optimizer_steps_match_reference)
from repro.models import model as ref_model  # noqa: E402

case = case_fixture(("xlstm_350m", "recurrentgemma_9b"))


def _jitter_spread(fwd, params, seed=0):
    """How far ``fwd``'s output moves, over its scale, when every weight is
    jittered by 1e-7 relative."""
    rs = np.random.default_rng(seed)
    jitter = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-7 * rs.standard_normal(a.shape).astype(np.float32)), params)
    a, b = np.asarray(fwd(params)), np.asarray(fwd(jitter))
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_xlstm_reference_spread():
    """Why the xLSTM case rescales ``repro``'s tree: on ``repro``'s own
    smoke weights its logits move by up to more than three times the logits
    tolerance under a 1e-7 relative jitter of those weights (measured
    1.2e-4, 1.3e-4 and 4.5e-4 over three seeds), on the rescaled tree by
    less than a tenth of it (measured 2.0e-7 for each seed)."""
    c = Case("xlstm_350m")
    fwd = jax.jit(lambda p: ref_model.forward(p, c.rcfg, jnp.asarray(c.tokens))[0])
    own = ref_model.init_params(jax.random.PRNGKey(0), c.rcfg)
    assert max(_jitter_spread(fwd, own, seed) for seed in range(3)) > 3 * LOGITS_TOL
    assert max(_jitter_spread(fwd, c.rparams, seed) for seed in range(3)) < LOGITS_TOL / 10


