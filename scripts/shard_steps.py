#!/usr/bin/env python3
"""The sharded walk's time on the card, for one checkout of this repo.

``chip_smoke.py``'s ``shard`` path: ``sharded_random_walk`` of ``deepwalk``
over 4 shards of the card on its R-MAT graph, a walker a vertex, depth 40,
the default hub budget.  A warm-up call (the layout's build), then three
timed calls, each on the host's clock around the call and a synchronize, as
the smoke times its paths; then one torch.profiler trace of a call at depth
4: the device's busy time and its top kernels, and the host operators that
took the most time.

    python3 scripts/shard_steps.py [CHECKOUT] [--label NAME]

``CHECKOUT`` (default: this one) is the root of a checkout whose ``src/``
is imported, so that two commits compare on one card by running the script
on each in turns (parent, change, change, parent).  The graph is built once
and cached under ``build/`` of this checkout.  Prints the card's name and
power limit, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as smoke  # noqa: E402

SHARDS, DEPTH, TRACE_DEPTH, REPS = 4, 40, 4, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("shard_steps: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import algorithms as alg
    from repro_torch.core import rng
    from repro_torch.graph import csr_from_arrays, generators
    from repro_torch.shard import ShardMesh, sharded_random_walk

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
    mesh = ShardMesh.on("cuda", SHARDS)
    seeds = torch.arange(g.num_vertices, dtype=torch.int32, device="cuda")
    walk = dict(spec=alg.deepwalk(), max_degree=g.max_degree())
    key = rng.PRNGKey(seed)
    t0 = time.perf_counter()
    sharded_random_walk(mesh, g, seeds, key, depth=1, **walk)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = sharded_random_walk(mesh, g, seeds, key, depth=DEPTH, **walk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded_random_walk(mesh, g, seeds, key, depth=TRACE_DEPTH, **walk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda r: -r[1])
    busy = sum(r[1] for r in device)
    print(smoke._card_line())
    print(json.dumps(dict(
        label=args.label, checkout=str(Path(args.checkout).resolve()), shards=SHARDS,
        walkers=g.num_vertices, depth=DEPTH, warm_up_s=warm_s, seconds=times,
        ms_per_step=[1e3 * t / DEPTH for t in times], stats=res.stats,
        trace=dict(depth=TRACE_DEPTH, wall_ms=wall_ms, device_busy_ms=busy,
                   device_idle_share=1 - busy / wall_ms,
                   device_top=[[k[:70], ms, c] for k, ms, c in device[:12]],
                   host_top=[[k[:70], ms, c] for k, ms, c in host[:12]]),
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
