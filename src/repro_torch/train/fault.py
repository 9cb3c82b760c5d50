"""Fault tolerance: straggler detection, failure recovery, elastic re-mesh.

The trainer composes three mechanisms:

  1. ``StepMonitor`` — per-step wall-clock tracking; a step exceeding
     ``deadline_factor`` × median flags a straggler (on a real fleet this
     triggers hot-spare swap / collective re-formation; here it triggers an
     early checkpoint so the swap loses nothing).
  2. ``run_with_recovery`` — wraps the step; on failure restores the last
     checkpoint and replays (failures injected in tests).
  3. ``elastic_remesh`` — rebuilds the mesh from the ranks of the current
     process group: the largest full (data, model) rectangle
     (``largest_mesh_shape``); ``CheckpointManager.restore`` with
     ``shardings`` on it completes an elastic rescale (node loss → shrink →
     continue).

The port of ``repro.train.fault``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class StepMonitor:
    def __init__(self, deadline_factor: float = 3.0, window: int = 50):
        self.deadline_factor = deadline_factor
        self.window = window
        self.durations: list[float] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step duration; True = straggler (checkpoint now)."""
        self.durations.append(seconds)
        hist = self.durations[-self.window :]
        if len(hist) < 5:
            return False
        med = float(np.median(hist[:-1]))
        if seconds > self.deadline_factor * med:
            self.straggler_steps.append(step)
            return True
        return False

    @property
    def median(self) -> float:
        return float(np.median(self.durations)) if self.durations else 0.0


def run_with_recovery(
    step_fn: Callable,
    state,
    batch,
    *,
    restore_fn: Callable,
    max_retries: int = 2,
    fail_injector: Optional[Callable] = None,
):
    """Run one training step; on exception restore + retry.

    ``restore_fn()`` must return a fresh state (e.g. CheckpointManager
    restore).  ``fail_injector(attempt)`` raising simulates node failure.
    Returns (state, metrics, attempts_used).
    """
    for attempt in range(max_retries + 1):
        try:
            if fail_injector is not None:
                fail_injector(attempt)
            out = step_fn(*state, batch)
            return out[:-1], out[-1], attempt
        except Exception:
            if attempt == max_retries:
                raise
            state = restore_fn()
    raise RuntimeError("unreachable")


def largest_mesh_shape(n_devices: int, model_axis: int) -> tuple:
    """Largest (data, model) rectangle that fits n_devices, preserving the
    model axis (params must keep their TP layout to restore cheaply)."""
    model = model_axis
    while model > 1 and n_devices % model:
        model //= 2
    data = n_devices // model
    return (data, model)


def elastic_remesh(model_axis: int = 1, device: str = "cuda"):
    """The best ``(data, model)`` mesh over the ranks of the current process
    group (``launch.mesh.init_world`` starts one when none is initialized)."""
    import torch.distributed as dist  # noqa: PLC0415

    from repro_torch.launch.mesh import init_world, mesh_over  # noqa: PLC0415

    init_world(device)
    shape = largest_mesh_shape(dist.get_world_size(), model_axis)
    return mesh_over(device, shape, ("data", "model"))
