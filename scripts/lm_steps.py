#!/usr/bin/env python3
"""The LM harness's phases on the card, alone: ``chip_smoke.py``'s ``lm``.

Builds the walk kernels (the walk corpora run them), then runs the smoke's
``lm_walk`` (the walk-corpus LM at ``--scale 100m``: corpus, 60 steps,
checkpoint restore and replay), ``lm_gemma3_1b`` (the full config's train,
prefill and decode steps, its f32 cross-checks) and the expert and
recurrent cells ``lm_xlstm_350m``, ``lm_recurrentgemma_9b`` and
``lm_arctic_480b`` with every check of the smoke, in a few minutes instead
of the smoke's quarter hour.

    python3 scripts/lm_steps.py

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
        print("lm_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke

    smoke = chip_smoke.Smoke()
    smoke.build.load()
    t0 = time.perf_counter()
    smoke.lm_paths()
    chip_smoke._log(f"lm phases in {time.perf_counter() - t0:.1f} s")
    print(chip_smoke._card_line())
    for row in smoke.paths:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
