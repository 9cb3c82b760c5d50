"""End-to-end example on the PyTorch port: C-SAW random-walk corpus ->
decoder-LM pretraining (the counterpart of ``walk_corpus_lm.py``).

The paper's engine is the data plane (DESIGN.md §4): DeepWalk sequences over
a graph, walked by the port's step kernels, are the token stream a decoder
trains on.  Fault tolerance is live: checkpoints every N steps,
restart-from-latest, a step monitor, and an optional injected failure to
demonstrate recovery.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/walk_corpus_lm_torch.py --steps 300 --scale 100m
    PYTHONPATH=src python examples/walk_corpus_lm_torch.py --device cpu --scale tiny --steps 40

A checkpoint at step N holds the state after N steps (parameters, optimizer
moments, the pipeline's cursor); a restart resumes at step N.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import TokenPipeline, build_walk_corpus  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault import StepMonitor  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_init  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

SCALES = {
    # ~100M-param decoder (the "train a ~100M model" end-to-end run)
    "100m": dict(num_layers=8, d_model=640, num_heads=8, num_kv_heads=4,
                 head_dim=80, d_ff=2560),
    "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=1024),
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=512),
}
VOCAB = GRAPH_VERTICES = 20_000
NUM_WALKS = 4096
OPT = OptConfig(kind="adamw", lr=1e-3, warmup_steps=20)


def walk_lm_config(scale: str) -> ModelConfig:
    return ModelConfig(
        name=f"walklm-{scale}", family="dense", vocab_size=VOCAB,
        pattern=("global",), dtype="float32", param_dtype="float32",
        attn_chunk=64, remat="none", **SCALES[scale],
    )


def corpus_graph(device):
    return powerlaw_graph(GRAPH_VERTICES, exponent=2.1, seed=0, weighted=True, device=device)


def walk_corpus(graph, seq: int, device):
    """4,096 DeepWalk walks of ``seq`` steps: (4096, seq + 1) int32 tokens."""
    return build_walk_corpus(
        graph, num_walks=NUM_WALKS, walk_length=seq, algorithm="deepwalk", seed=1,
        vocab_size=VOCAB, max_degree=min(graph.max_degree(), 512), device=device,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", choices=SCALES, default="tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "csaw_lm_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # --- data plane: the paper's sampler --------------------------------------
    g = corpus_graph(args.device)
    corpus = walk_corpus(g, args.seq, args.device)
    print(f"walk corpus: {corpus.shape[0]} sequences × {corpus.shape[1]} tokens")

    cfg = walk_lm_config(args.scale)
    print(f"model: {cfg.param_count()/1e6:.0f}M params on {args.device}")
    step_fn = make_train_step(cfg, OPT, device=args.device)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, corpus=corpus)

    mgr = CheckpointManager(args.ckpt_dir, keep=2, fingerprint=cfg.name)
    monitor = StepMonitor()

    model = DecoderLM(cfg, seed=0, device=args.device)
    opt_state = opt_init(OPT, dict(model.named_parameters()))
    start = 0
    if mgr.latest_step() is not None:
        (sd, opt_state), manifest = mgr.restore((model.state_dict(), opt_state))
        model.load_state_dict(sd)
        start = manifest["step"]
        pipe.load_state_dict(manifest["extra"]["pipeline"])
        print(f"restored from checkpoint at step {start}")

    def save(done, sync=True):
        write = mgr.save if sync else mgr.save_async
        write(done, (model.state_dict(), opt_state), extra={"pipeline": pipe.state_dict()})

    step, loss = start, float("nan")
    for i in range(start, args.steps):
        if i == args.inject_failure_at:
            print("injected failure! restart this script to observe recovery.")
            raise SystemExit(17)
        t0 = time.perf_counter()
        opt_state, step, metrics = step_fn(model, opt_state, step, pipe.next())
        loss = float(metrics["loss"])  # waits for the step
        if monitor.observe(i, time.perf_counter() - t0):
            print(f"step {i}: straggler detected -> early checkpoint")
            save(step)
        if i % args.ckpt_every == 0 and i > start:
            save(step, sync=False)
        if i % 20 == 0:
            print(f"step {i:4d} loss {loss:.4f} ({monitor.median*1e3:.0f} ms/step)")
    mgr.wait()
    save(args.steps)
    print(f"done: final loss {loss:.4f}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
