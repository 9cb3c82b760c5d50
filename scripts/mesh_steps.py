#!/usr/bin/env python3
"""The device mesh on the card, alone: ``chip_smoke.py``'s phase 14, then
the launcher.

Runs the smoke's ``mesh_gemma3_1b`` and ``mesh_arctic_480b`` (the LM
harness's train, prefill and decode steps on the host mesh, a world of one,
against the same steps without a mesh; the production mesh's refusal of one
card), then, with ``--launch``, its ``launch_gemma3_1b`` (the launcher in
single processes, without a mesh), with every check of the smoke.  Builds the
walk kernels first (the launcher's walk corpus runs them).

    python3 scripts/mesh_steps.py [--launch]

Prints the card's name and power limit, then one JSON line a phase.  Needs
a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke

    smoke = chip_smoke.Smoke()
    smoke.build.load()
    t0 = time.perf_counter()
    smoke.mesh_paths()
    chip_smoke._log(f"mesh phases in {time.perf_counter() - t0:.1f} s")
    if "--launch" in sys.argv[1:]:
        t0 = time.perf_counter()
        smoke.launch_path()
        chip_smoke._log(f"launcher in {time.perf_counter() - t0:.1f} s")
    print(chip_smoke._card_line())
    for row in smoke.paths:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
