"""Batched serving demo on the PyTorch port: the multi-instance sampling
service (the counterpart of ``serve_batch.py``, with its five modes and
flags; ``--backend`` becomes ``--device``, ``cuda`` unless ``--device cpu``).

Spins up a :class:`repro_torch.serve.SamplingService` over a power-law graph
and feeds it a burst of concurrent, heterogeneous requests — mixed
algorithms (deepwalk / weighted / node2vec), mixed walk lengths, mixed
seed-set sizes — then drains them through fused launches and prints the
per-request results plus the batching stats (launches vs requests, padding
overhead).

    PYTHONPATH=src python examples/serve_batch_torch.py --requests 24
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

``--oom``: the graph as 8 host-resident vertex-range partitions (2 resident
at a time), every cohort routed through the §V frontier-queue drain.
``--sharded``: the graph range-sharded over a ``ShardMesh`` of 8 shards on
the one device, every cohort drained through the owner-routed frontier
exchange.  ``--stream --rate 80``: the always-on
:class:`repro_torch.serve.StreamingSamplingService` under open-loop Poisson
arrivals in three priority tiers, with per-tier p50 / p99 latency.
``--lm --arch gemma3-1b``: prefill and greedy decode with the KV / state
cache on the smoke config.
"""
import argparse
import collections
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import rng as crng  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402
from repro_torch.graph.csr import resolve_device  # noqa: E402

SHARDS = 8


def demo_graph(device):
    return powerlaw_graph(20_000, exponent=2.1, seed=0, weighted=True, device=device)


def request_burst(num: int, num_vertices: int) -> list:
    """``serve_batch.py``'s burst: ``(spec index, seeds, depth)`` a request,
    the specs ``(deepwalk, weighted, node2vec)`` in turn."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(num):
        n = int(rng.integers(16, 129))
        depth = int(rng.choice([8, 12, 16, 24, 32]))
        out.append((i % 3, rng.integers(0, num_vertices, n), depth))
    return out


def run_sampling_service(args):
    """Submit a burst of mixed requests, drain, report batching wins;
    returns the service, its results by request id and the tickets."""
    from repro_torch.graph.partition import partition_by_vertex_range
    from repro_torch.serve import SamplingService, ServiceConfig
    from repro_torch.shard import ShardMesh

    dev = resolve_device(args.device)
    g = demo_graph(dev)
    print(f"graph: V={g.num_vertices} E={g.num_edges} maxdeg={g.max_degree()}")
    if args.oom:
        parts = partition_by_vertex_range(g, 8)
        svc = SamplingService(
            partitions=parts, total_vertices=g.num_vertices,
            device=dev, oom_memory_capacity=2, oom_chunk=256,
        )
        print(f"mode: out-of-memory ({len(parts)} partitions, 2 resident)")
    elif args.sharded:
        mesh = ShardMesh.on(dev, SHARDS)
        svc = SamplingService(g, mesh=mesh, placement="sharded", device=dev)
        print(f"mode: mesh-sharded ({SHARDS} shards on {dev}, per-shard CSR ~1/{SHARDS})")
    else:
        svc = SamplingService(g, device=dev, config=ServiceConfig())
        print(f"mode: in-memory fused launches on {dev}")

    specs = [alg.deepwalk(), alg.weighted_random_walk(), alg.node2vec()]
    tickets = {}
    for which, seeds, depth in request_burst(args.requests, g.num_vertices):
        spec = specs[which]
        rid = svc.submit(seeds, depth=depth, spec=spec)
        tickets[rid] = (spec.name, len(seeds), depth)

    t0 = time.perf_counter()
    results = svc.drain()  # results on the host: the device work is done
    secs = time.perf_counter() - t0

    for rid in sorted(results)[:6]:
        name, n, depth = tickets[rid]
        r = results[rid]
        print(f"  req {rid:2d} {name:12s} {n:4d} walkers x depth {depth:3d} "
              f"-> mean len {r.lengths.mean():5.1f}, {r.sampled_edges} edges")
    if len(results) > 6:
        print(f"  ... {len(results) - 6} more requests")
    s = svc.stats
    launches = (
        s.oom_launches if args.oom
        else s.sharded_launches if args.sharded
        else s.launches
    )
    print(f"served {s.requests_served} requests / {s.walkers_served} walkers "
          f"in {launches} launches ({secs*1e3:.0f} ms)")
    print(f"padding overhead: {s.padded_walker_slots} ghost walker slots")
    return svc, results, tickets


def run_streaming_demo(args) -> list:
    """Open-loop streaming demo: Poisson arrivals against the always-on
    scheduler, mixed specs and priority tiers, per-tier latency report;
    returns the requests' futures."""
    from repro_torch.serve import (
        Priority,
        SamplingService,
        ServiceConfig,
        StreamConfig,
        StreamingSamplingService,
    )
    from repro_torch.serve.stream import percentile

    dev = resolve_device(args.device)
    g = demo_graph(dev)
    print(f"graph: V={g.num_vertices} E={g.num_edges} maxdeg={g.max_degree()}")

    depth, width, max_cohort = 8, 16, 16
    svc = SamplingService(
        g, device=dev, config=ServiceConfig(
            max_pending_requests=1 << 14, max_pending_walkers=1 << 20,
            max_requests_per_launch=max_cohort,
        ),
    )
    specs = [alg.deepwalk(), alg.weighted_random_walk()]
    print("prewarming launch plans (so no live request pays the set-up)...")
    for spec in specs:
        r = 1
        while r <= max_cohort:
            svc.prewarm(spec, depth=depth, width=width, requests=r)
            r *= 2

    tiers = {
        Priority.INTERACTIVE: ("interactive", 50.0),
        Priority.STANDARD: ("standard", None),
        Priority.BULK: ("bulk", 500.0),
    }
    rng = np.random.default_rng(7)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    print(f"mode: always-on streaming — {args.requests} Poisson arrivals at "
          f"{args.rate:.0f} req/s, 10 ms batching window")

    futs = []
    with StreamingSamplingService(
        svc, StreamConfig(max_batch_window_ms=10.0)
    ) as stream:
        t0 = time.perf_counter()
        for i, at in enumerate(arrivals):
            delay = t0 + at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tier = [Priority.INTERACTIVE, Priority.STANDARD, Priority.BULK,
                    Priority.STANDARD][i % 4]
            futs.append(stream.submit(
                rng.integers(0, g.num_vertices, int(rng.integers(9, width + 1))),
                depth=depth, spec=specs[i % 2],
                deadline_ms=tiers[tier][1], priority=tier,
            ))
        for f in futs:
            f.result(timeout=600)
        elapsed = time.perf_counter() - t0

    lats = [f.latency for f in futs]
    print(f"\nserved {len(futs)} requests in {elapsed:.2f}s "
          f"({len(futs) / elapsed:.0f} req/s sustained), "
          f"{svc.stats.stream_launches} launches, "
          f"{svc.stats.stream_deadline_misses} deadline misses")
    reasons = collections.Counter(lat.reason for lat in lats)
    print("launch triggers: " + ", ".join(f"{k}={v}" for k, v in reasons.most_common()))
    print(f"{'tier':>12s} {'n':>4s} {'p50 ms':>8s} {'p99 ms':>8s}")
    for tier, (name, deadline) in tiers.items():
        tl = [lat.total_ms for lat in lats if lat.tier == int(tier)]
        if tl:
            print(f"{name:>12s} {len(tl):4d} {percentile(tl, 50):8.1f} "
                  f"{percentile(tl, 99):8.1f}"
                  + (f"   (deadline {deadline:.0f} ms)" if deadline else ""))
    return futs


def run_lm_demo(args, model=None) -> np.ndarray:
    """LM serving demo: prefill + greedy decode with the KV/state cache on
    the smoke config; ``model`` defaults to ``DecoderLM(cfg, seed=0)``.
    Returns the decoded tokens, ``(batch, tokens)``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, init_cache
    from repro_torch.train.train_step import make_serve_step

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if model is None:
        model = DecoderLM(cfg, seed=0, device=dev)
    max_len = args.prompt_len + args.tokens
    serve = make_serve_step(cfg, args.batch, max_len, device=dev)

    prompts = crng.randint(crng.PRNGKey(1), (args.batch, args.prompt_len), 0,
                           cfg.vocab_size, device=dev)
    cache = init_cache(cfg, args.batch, max_len, device=dev)

    # prefill: feed prompt tokens through the decode path (recurrent archs
    # have O(1) state; attention archs fill the KV cache)
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        logits, cache = serve(model, cache, prompts[:, t : t + 1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0

    # decode: greedy continuation (each token read on the host)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        logits, cache = serve(model, cache, tok)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok.cpu().numpy())
    decode_s = time.perf_counter() - t0
    seqs = np.concatenate(out, axis=1)
    tput = args.batch * (args.tokens - 1) / decode_s
    print(f"arch={cfg.name} batch={args.batch} device={dev}")
    print(f"prefill: {args.prompt_len} steps in {prefill_s*1e3:.0f} ms")
    print(f"decode:  {args.tokens-1} steps in {decode_s*1e3:.0f} ms ({tput:.0f} tok/s)")
    print(f"sample continuation (request 0): {seqs[0][:16].tolist()}")
    return seqs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24,
                    help="number of concurrent sampling requests to submit")
    ap.add_argument("--device", default="cuda",
                    help="the device the service runs on: cuda (default) or cpu")
    ap.add_argument("--oom", action="store_true",
                    help="serve through the out-of-memory partition scheduler")
    ap.add_argument("--sharded", action="store_true",
                    help="serve over 8 shards of the device via the owner-routed "
                         "frontier exchange")
    ap.add_argument("--stream", action="store_true",
                    help="run the always-on streaming demo: open-loop "
                         "Poisson arrivals, priority tiers, per-tier p50/p99")
    ap.add_argument("--rate", type=float, default=80.0,
                    help="streaming demo offered load, requests/s")
    ap.add_argument("--lm", action="store_true",
                    help="run the language-model serving demo instead")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.lm:
        return run_lm_demo(args)
    if args.stream:
        return run_streaming_demo(args)
    return run_sampling_service(args)


if __name__ == "__main__":
    main()
