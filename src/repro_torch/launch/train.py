"""Training launcher: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 1000 \
        --batch 32 --seq 128 --ckpt-dir /ckpts/run1 [--data walks] [--smoke]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch gemma3-1b ...
    python -m repro_torch.launch.train --arch gemma3-1b --smoke --device cpu --steps 3

Composes the harness: the mesh (``--production-mesh [--multipod]``: the 16 ×
16 or 2 × 16 × 16 mesh, which needs a process group of 256 or 512 ranks;
else, under ``torchrun`` with more than one rank, the host mesh over them;
a single process runs the steps without a mesh, which equal the steps on a
mesh of one bit for bit without DTensor's dispatch), the config (``--smoke`` for the reduced one), synthetic or
C-SAW walk-corpus data (the corpus walked on the device by the step
kernels), the port's train step on the mesh (per-architecture sharding
rules, microbatching, ``--compressed`` int8 gradients over the pod axis,
the plain step without one),
async checkpoints with restart from the latest, and the straggler monitor.
Each rank reads the rows of its coordinate along the batch's mesh axes, so
ranks that differ only along ``model`` read the same rows.  Runs on the card
unless ``--device cpu`` (gloo); with no card and no ``--device cpu`` it
raises.

Where it differs from ``repro``'s launcher:

- The initial weights: ``build_model`` draws them with ``DecoderLM(cfg,
  seed=0)`` from a seeded ``torch.Generator``, which does not give
  ``repro``'s ``init_params(PRNGKey(0))``.  It is the one place the model is
  built, so a caller can replace it to start from other weights.
- A checkpoint is labelled with the number of updates it holds, so a run
  restarted from any checkpoint makes ``--steps`` updates in all, as an
  uninterrupted run does.  ``repro`` labels a checkpoint written inside the
  loop ``i`` though it holds ``i + 1`` updates (ROADMAP queue 3, item 7).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenPipeline, build_walk_corpus
from repro_torch.graph import powerlaw_graph
from repro_torch.graph.csr import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, world_size
from repro_torch.models import DecoderLM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import StepMonitor
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_step import (
    batch_rows, batch_specs, make_train_step, place_batch, shard_model)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 pod mesh (requires 256 ranks)")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--compressed", action="store_true",
                    help="int8 gradient reduction over the pod axis")
    ap.add_argument("--data", choices=("synthetic", "walks"), default="synthetic")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_model(cfg: ModelConfig, device) -> DecoderLM:
    """The model the run starts from."""
    return DecoderLM(cfg, seed=0, device=device)


def make_mesh(args: argparse.Namespace, kind: str):
    """The run's mesh: the production mesh on ``--production-mesh``, the
    host mesh when the run has more than one rank, else None."""
    if args.production_mesh:
        return make_production_mesh(multi_pod=args.multipod, device=kind)
    if world_size() > 1:
        return make_host_mesh(device=kind)
    return None


def main(argv=None) -> dict:
    """Run the launcher; returns the run's record: the step it started
    from, each step's ``loss`` and ``grad_norm``, the model, the optimizer
    state and the mesh (None in a single process)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_mesh(args, dev.type)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())  # the rank's card
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    where = "" if mesh is None else f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e9:.2f}B {where}device={dev}")

    corpus = None
    if args.data == "walks":
        t0 = time.perf_counter()
        g = powerlaw_graph(min(cfg.vocab_size, 20_000), seed=0, weighted=True, device=dev)
        corpus = build_walk_corpus(
            g, num_walks=4096, walk_length=args.seq, vocab_size=cfg.vocab_size,
            max_degree=min(g.max_degree(), 512), device=dev,
        )
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        print(f"walk corpus: {corpus.shape[0]} walks of {corpus.shape[1]} tokens in "
              f"{time.perf_counter() - t0:.2f} s, kernel launches {launched}")
    host_index, host_count = 0, 1
    if mesh is not None:
        bspecs = batch_specs(cfg, mesh, args.batch)
        host_index, host_count = batch_rows(mesh, bspecs["tokens"])
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, corpus=corpus,
                         host_index=host_index, host_count=host_count)

    ocfg = OptConfig(kind=cfg.optimizer, lr=args.lr)
    step_fn = make_train_step(cfg, ocfg, mesh, device=dev, compressed=args.compressed,
                              global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, fingerprint=cfg.name)
    monitor = StepMonitor()

    model = build_model(cfg, dev)
    if mesh is not None:
        model = shard_model(model, mesh)
    opt_state = opt_init(ocfg, dict(model.named_parameters()))
    step = start = 0
    if mgr.latest_step() is not None:
        (sd, opt_state), manifest = mgr.restore((model.state_dict(), opt_state))
        model.load_state_dict(sd)
        start = step = manifest["step"]
        pipe.load_state_dict(manifest["extra"]["pipeline"])
        print(f"restarted from step {start}")

    def save(done: int, write) -> None:
        write(done, (model.state_dict(), opt_state), extra={"pipeline": pipe.state_dict()})

    losses, grad_norms = [], []
    loss = float("nan")
    for i in range(start, args.steps):
        batch = pipe.next()
        if mesh is not None:
            batch = place_batch(batch, mesh, bspecs, local=True)
        t0 = time.perf_counter()
        opt_state, step, metrics = step_fn(model, opt_state, step, batch)
        loss = float(metrics["loss"])  # waits for the step
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if monitor.observe(i, time.perf_counter() - t0):
            print(f"step {i}: straggler — early checkpoint")
            save(step, mgr.save)
        if step % args.ckpt_every == 0 and step < args.steps:
            save(step, mgr.save_async)
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} gnorm {grad_norms[-1]:.3f} "
                  f"({monitor.median*1e3:.0f} ms/step)")
    mgr.wait()
    save(args.steps, mgr.save)
    print("step times (ms): " + ", ".join(f"{t * 1e3:.0f}" for t in monitor.durations))
    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")
    print(f"finished at step {args.steps}, loss {loss:.4f}{peak}")
    return {"start": start, "losses": losses, "grad_norms": grad_norms,
            "model": model, "opt_state": opt_state, "mesh": mesh}


if __name__ == "__main__":
    main()
