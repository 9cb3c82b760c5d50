"""The port's mixture-of-experts decoder LMs (``arctic_480b``,
``llama4_maverick_400b_a17b``) against ``repro``'s: logits, aux loss, loss,
gradient, optimizer steps and decode, as ``test_torch_lm.py`` holds the
dense ones (the tests and their tolerances: ``lm_reference.py``)."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from lm_reference import (  # noqa: E402,F401 (the shared tests and autouse fixture)
    case_fixture, no_activation_mesh,
    test_decode_matches_reference_and_forward, test_forward_logits_match_reference,
    test_loss_and_gradient_match_reference, test_optimizer_steps_match_reference)

case = case_fixture(("arctic_480b", "llama4_maverick_400b_a17b"))
