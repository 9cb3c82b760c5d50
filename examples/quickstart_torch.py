"""Quickstart on the PyTorch port: express and run sampling algorithms with
the C-SAW API (the counterpart of ``quickstart.py``).  Runs on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.api import EdgeCtx, SamplingSpec  # noqa: E402
from repro_torch.core.engine import random_walk, traversal_sample  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402
from repro_torch.graph.csr import resolve_device  # noqa: E402

BUILT_IN = ("deepwalk", "biased_rw", "node2vec")


def hot_edges(ctx: EdgeCtx) -> torch.Tensor:
    """A custom "temperature walk" bias: weight squared."""
    return ctx.weight ** 2


def run(device="cuda", *, num_seeds: int = 2048, num_pools: int = 512) -> dict:
    """Run the three parts and print what ``quickstart.py`` prints; returns
    ``{name: WalkResult}`` for the built-in algorithms and ``custom_hot``,
    and the neighbor sampling's ``SampleResult`` under ``neighbor``."""
    dev = resolve_device(device)
    g = powerlaw_graph(20_000, exponent=2.1, seed=0, weighted=True, device=dev)
    print(f"graph: V={g.num_vertices} E={g.num_edges} maxdeg={g.max_degree()} on {dev}")
    key = rng.PRNGKey(0)
    md = min(g.max_degree(), 512)
    out = {}

    # 1) built-in algorithms ---------------------------------------------------
    seeds = rng.randint(key, (num_seeds,), 0, g.num_vertices, device=dev)
    for name in BUILT_IN:
        spec = alg.ALGORITHMS[name]()
        t0 = time.perf_counter()
        res = random_walk(g, seeds, key, depth=32, spec=spec, max_degree=md, device=dev)
        edges = int(res.sampled_edges)  # waits for the walk
        secs = time.perf_counter() - t0
        print(f"{name:12s} SEPS={edges/secs:.3e}")
        out[name] = res

    # 2) traversal sampling ----------------------------------------------------
    pools = rng.randint(key, (num_pools, 1), 0, g.num_vertices, device=dev)
    res = traversal_sample(
        g, pools, key, depth=3, spec=alg.biased_neighbor_sampling(),
        max_degree=md, pool_capacity=256, max_vertices=g.num_vertices, device=dev,
    )
    print(f"neighbor sampling: {float(res.num_edges.float().mean()):.1f} edges/instance, "
          f"{int(res.iters)} retry iters (BRS)")
    out["neighbor"] = res

    # 3) a CUSTOM algorithm via the three-hook API (paper Fig. 2a) -------------
    #    "temperature walk": bias ∝ weight^2, restart at dead ends
    spec = SamplingSpec(edge_bias=hot_edges, name="custom_hot", track_visited=False)
    res = random_walk(g, seeds[:256], key, depth=16, spec=spec, max_degree=md, device=dev)
    print(f"custom algorithm: {int(res.sampled_edges)} edges sampled "
          f"(mean len {float(res.lengths.float().mean()):.1f})")
    out["custom_hot"] = res
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
