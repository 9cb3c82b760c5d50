"""The port's training launcher (``repro_torch.launch.train``) against
``repro.launch.train``.

``repro``'s launcher runs here on a one-device mesh with ``Auto`` axes
(``make_host_mesh`` replaced): under JAX 0.9 ``jax.make_mesh`` gives
``Explicit`` axes, which ``repro``'s train step refuses
(``lm_reference.reference_mesh`` is the same mesh).  Its ``make_train_step`` is
wrapped to record each step's loss and gradient norm, and compiled once per
config for the whole file.  The port's launcher starts from ``repro``'s
initial tree, carried across by ``models/convert.py`` in place of its
``build_model``.

In one process the port's launcher runs the steps without a mesh and starts
no process group (the 4-rank launcher runs in ``test_torch_mesh_ranks.py``).
"""
import os
import shutil
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import repro.launch.train as ref_launch  # noqa: E402
from lm_reference import (  # noqa: E402,F401 (the autouse fixture)
    TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL, no_activation_mesh)
from repro.models.layers import set_activation_mesh  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

SMALL = ["--smoke", "--batch", "4", "--seq", "32", "--log-every", "1"]


@pytest.fixture(scope="module")
def compiled():
    """``repro``'s jitted train steps, one per config, shared by the file."""
    return {}


@pytest.fixture
def reference(monkeypatch, compiled):
    """``run(argv)`` runs ``repro``'s launcher; returns each step's ``(loss,
    grad_norm)``, each in-loop checkpoint's ``(label, updates made)`` and the
    initial parameter tree."""
    real_make_train_step = ref_launch.make_train_step
    real_init_params = ref_launch.init_params

    def auto_mesh():
        return jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def run(argv):
        steps, saves, init = [], [], []

        def init_params(key, cfg):
            tree = real_init_params(key, cfg)
            init.append(jax.tree_util.tree_map(np.array, tree))  # the step donates its input
            return tree

        def make_train_step(cfg, ocfg, mesh, **kw):
            if cfg.name not in compiled:
                compiled[cfg.name] = real_make_train_step(cfg, ocfg, mesh, **kw)
            step_fn, rest = compiled[cfg.name]

            def counted(*args):
                out = step_fn(*args)
                steps.append((float(out[3]["loss"]), float(out[3]["grad_norm"])))
                return out
            return counted, rest

        class Manager(ref_launch.CheckpointManager):
            def save_async(self, step, tree, extra=None):
                saves.append((step, len(steps)))
                super().save_async(step, tree, extra)

        monkeypatch.setattr(ref_launch, "init_params", init_params)
        monkeypatch.setattr(ref_launch, "make_train_step", make_train_step)
        monkeypatch.setattr(ref_launch, "make_host_mesh", auto_mesh)
        monkeypatch.setattr(ref_launch, "CheckpointManager", Manager)
        monkeypatch.setattr(sys, "argv", ["train", *argv])
        ref_launch.main()
        set_activation_mesh(None)
        return steps, saves, init[0]

    return run


def reference_start(monkeypatch, init):
    """Make the port's launcher start from ``repro``'s initial tree ``init``
    (numpy)."""
    def build_model(cfg, device):
        model = DecoderLM(cfg, device=device)
        model.load_state_dict(params_from_jax(init, cfg))
        return model
    monkeypatch.setattr(launch, "build_model", build_model)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gemma3_1b"])
def test_launcher_matches_reference(reference, monkeypatch, tmp_path, arch):
    """Three steps of the smoke config on synthetic data from the same
    initial weights: each step's loss and gradient norm, at the train step's
    tolerances (measured worst over both configs: loss 2.1e-7 relative,
    gradient norm 2.1e-5, internlm2's)."""
    want, _, init = reference(["--arch", arch, *SMALL, "--steps", "3",
                               "--ckpt-dir", str(tmp_path / "ref")])
    reference_start(monkeypatch, init)
    got = launch.main(["--arch", arch, *SMALL, "--steps", "3", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "port")])
    assert got["start"] == 0 and len(want) == len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], [w[0] for w in want], rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], [w[1] for w in want], rtol=TRAIN_GNORM_RTOL)


def _params(run) -> list:
    return [p.detach().clone() for p in run["model"].parameters()]


def test_restart_resumes_exactly(tmp_path, capsys):
    """A run stopped at step 2 and started again ends where an uninterrupted
    run of 4 steps ends, whether it restarts from the final checkpoint of a
    2-step run or from the checkpoint written inside a 4-step run's loop."""
    argv = ["--arch", "gemma3_1b", *SMALL, "--device", "cpu", "--ckpt-every", "2"]
    straight = launch.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002", "step_00000004"]

    launch.main([*argv, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    resumed = launch.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    shutil.copytree(tmp_path / "a" / "step_00000002", tmp_path / "c" / "step_00000002")
    mid_run = launch.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "c")])
    assert capsys.readouterr().out.count("restarted from step 2") == 2
    for run in (resumed, mid_run):
        assert run["start"] == 2 and len(run["losses"]) == 2
        assert run["losses"] == straight["losses"][2:]
        for a, b in zip(_params(run), _params(straight)):
            assert torch.equal(a, b)


def test_reference_restart_makes_one_update_more(reference, tmp_path):
    """``repro``'s launcher labels the checkpoint it writes after step ``i``
    as ``i`` though it holds ``i + 1`` updates (ROADMAP queue 3, item 7): a
    run restarted from it makes ``--steps`` + 1 updates in all."""
    ckpt = tmp_path / "ref"
    argv = ["--arch", "internlm2_1_8b", *SMALL, "--steps", "3", "--ckpt-every", "2",
            "--ckpt-dir", str(ckpt)]
    straight, saves, _ = reference(argv)
    assert len(straight) == 3 and saves == [(2, 3)]  # label 2 after 3 updates
    shutil.rmtree(ckpt / "step_00000003")  # the run stopped before its final save
    restarted, _, _ = reference(argv)
    assert len(restarted) == 1  # it resumes at "step 2"
    assert saves[0][1] + len(restarted) == len(straight) + 1


@pytest.mark.parametrize("flag", ["--production-mesh", "--multipod", "--compressed"])
def test_mesh_flags_raise(tmp_path, flag):
    """``--production-mesh`` raises without its 256 ranks, and with
    ``--multipod`` without 512, before writing anything; ``--multipod``
    alone only shapes the production mesh, and ``--compressed`` without a
    pod axis is the plain step: each gives the plain run's losses.  No run
    leaves a process group."""
    argv = ["--arch", "gemma3_1b", *SMALL, "--device", "cpu", "--steps", "2"]
    if flag == "--production-mesh":
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            launch.main([*argv, flag, "--ckpt-dir", str(tmp_path)])
        assert not os.listdir(tmp_path)  # it raised before writing anything
        return
    if flag == "--multipod":
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            launch.main([*argv, "--production-mesh", flag, "--ckpt-dir", str(tmp_path)])
        assert not os.listdir(tmp_path)
    plain = launch.main([*argv, "--ckpt-dir", str(tmp_path / "plain")])
    flagged = launch.main([*argv, flag, "--ckpt-dir", str(tmp_path / "flagged")])
    assert len(plain["losses"]) == 2
    assert flagged["losses"] == plain["losses"]
    assert flagged["grad_norms"] == plain["grad_norms"]
    assert flagged["mesh"] is None and not torch.distributed.is_initialized()


def test_launcher_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "gemma3_1b", "--smoke", "--ckpt-dir", str(tmp_path)])
