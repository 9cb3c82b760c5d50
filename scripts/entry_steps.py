#!/usr/bin/env python3
"""The user entry points on the card, alone: ``chip_smoke.py``'s phase 14.

Builds the walk kernels, then runs the smoke's ``launch_gemma3_1b`` (the
training launcher as users run it, at the full gemma3_1b config on the walk
corpus: 4 steps straight, then 2 steps and a restart), ``graphsaint``,
``quickstart`` and ``serve_batch`` (the three sampling examples, each
against the CPU port) with every check of the smoke, in a few minutes
instead of the smoke's quarter hour.

    python3 scripts/entry_steps.py

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
        print("entry_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke

    smoke = chip_smoke.Smoke()
    smoke.build.load()
    t0 = time.perf_counter()
    smoke.entry_paths()
    chip_smoke._log(f"entry phases in {time.perf_counter() - t0:.1f} s")
    print(chip_smoke._card_line())
    for row in smoke.paths:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
