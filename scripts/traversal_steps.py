#!/usr/bin/env python3
"""Traversal sampling's ms a step on the card, for one checkout of this repo.

The four paths of ``chip_smoke.py``'s traversal phase, taken from it
(``traversal_cases`` on its R-MAT graph, seed and instance count):
a warm-up call, then three timed calls a path, each timed on the host's
clock around the call and a synchronize, as the smoke times its paths.

    python3 scripts/traversal_steps.py [CHECKOUT] [--label NAME]

``CHECKOUT`` (default: this one) is the root of a checkout whose ``src/``
is imported, so that two commits compare on one card by running the script
on each in turns (parent, change, change, parent).  The graph is built
once and cached under ``build/`` of this checkout.  Prints the card's name
and power limit, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("traversal_steps: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import algorithms as alg
    from repro_torch.core import engine as eng
    from repro_torch.core import rng
    from repro_torch.graph import csr_from_arrays, generators

    scale, seed = smoke.RMAT_SCALE, smoke.SEED
    cache = HERE / "build" / f"traversal_rmat{scale}.npz"
    if cache.exists():
        z = np.load(cache)
        g = csr_from_arrays(z["indptr"], z["indices"], z["weights"], device="cuda")
    else:
        g = generators.rmat_graph(scale, edge_factor=16, seed=seed, weighted=True, device="cuda")
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, indptr=g.indptr.cpu().numpy(), indices=g.indices.cpu().numpy(),
                 weights=g.weights.cpu().numpy())
    md, key = g.max_degree(), rng.PRNGKey(seed)
    out = {}
    for name, spec, seeds, depth, cap, mv in smoke.traversal_cases(alg, g):
        kw = dict(spec=spec, max_degree=md, pool_capacity=cap, max_vertices=mv, device="cuda")
        p = torch.from_numpy(seeds).cuda()
        eng.traversal_sample(g, p, key, depth=1, **kw)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t = time.perf_counter()
            eng.traversal_sample(g, p, key, depth=depth, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3 / depth)
        out[name] = ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({"label": args.label, "ms_per_step": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
