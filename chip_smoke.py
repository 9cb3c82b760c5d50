#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card, at real sizes.

Drives the port's ``random_walk`` (the paper's MAIN loop) through every
transition-program mode and every hand-written CUDA kernel, and checks what
comes out.  One walk per vertex, depth 40 (DeepWalk's walk length):

1. main path — ``deepwalk``, auto plan (rejection in every cohort, rejection
   tail: one ``reject_step`` launch a step) on R-MAT scale 21, edge factor
   16: 2.1M vertices and about 60M CSR entries, the edge count of SNAP
   soc-LiveJournal1;
2. node2vec — ``node2vec()`` (p = 2, q = 0.5) on the same graph: window
   plan (128, 512) plus the chunked window tail, ``walk_step_window``, at
   depth ``NODE2VEC_DEPTH`` (the hook runs in plain PyTorch over every
   chunk of hub rows up to degree 102,664: seconds per step);
3. mhrw, jump (p = 0.15), restart_home (p = 0.15, back to the walk's seed)
   — flat uniform bias with the MH and teleport epilogues on the same
   graph, auto plan (rejection), at depth ``EPILOGUE_DEPTH``;
4. its — ``weighted_random_walk`` pinned to ITS on a 1M-vertex power-law
   graph (maximum degree about 1k, so the chunked ITS tail stays at two
   chunks or fewer): one ``walk_step`` launch a step;
5. alias — ``weighted_random_walk``, auto plan (alias in every cohort and
   the tail: one ``alias_step`` launch a step), on the same power-law graph;
6. opaque — ``weighted_random_walk`` with its flat form and program stripped
   (an arbitrary edge-bias hook) on the same power-law graph: the dense
   context and ``its_select`` with K = 1;
7. per kernel — each kernel against its plain PyTorch version on the card,
   on its path's first-step inputs, one entry per launch the step makes,
   with its time per step (``ms``: device time, launches back to back
   behind a device spin; ``loop_ms``: CUDA events around the launches from
   an idle device, which counts the host's time between launches when it is
   the longer), its bound and the plain version's time (``walk_step`` also
   with its word-by-word loads, from a bias off 16-byte alignment:
   ``word_loads_ms``).  The bound is the
   larger of the bytes over 3.35 TB/s (each input word once, however many
   walkers read it) and the operations over their rates: f32 operations
   over 67 TFLOP/s, and the counted hash's 32-bit integer operations
   (``reject_step``, ``walk_step``, ``alias_step``: 75 per uniform, the
   uniforms each walker hashes counted from the plain version's output)
   over the INT32 rate, 64
   lanes an SM at the SM clock that ``nvidia-smi --query-gpu=clocks.max.sm``
   reports.  ``its_select`` also at K = 8 with 32 rounds on the same rows,
   so collisions and region search run; ``walk_step_window``,
   ``walk_step``, ``reject_step`` and ``alias_step`` also on their path's
   last step (``later_step``), where walkers sit at vertices the walk
   reached;
8. cross-check — the first 4,096 walkers of each path, rerun on the CPU by
   the plain versions, equal the card's walks; every hop is a graph edge (or
   an MH stay, a jump to a valid vertex, a restart to the walk's seed);
9. the device hash — the kernels' threefry, alone, against ``rng.uniform``
   bit for bit, at the main path's W under its first step's 16 rejection
   round keys;
10. traversal sampling — ``traversal_sample`` on the R-MAT 21 graph at
   2,000 instances (the paper's count of sampling instances,
   ``benchmarks/fig09_seps.py``) with ``max_degree`` 102,664, so no row is
   cut: ``neighbor`` (``biased_neighbor_sampling(2, 8)``, one seed an
   instance, depth 3, pools of 64, a visited map of every vertex),
   ``snowball`` (``snowball_sampling(16, 8)``, the same pools, depth 2),
   ``layer`` (``layer_sampling(8, 8)``, depth 3: pooled rows of 821,376
   candidates) and ``mdrw`` (pools of 8 seeds, capacity 16, depth 16, as
   fig09).  Seeds are drawn from the vertices with an edge.  Each path must
   launch ``its_select`` and its wide kernel; every sampled edge must be a
   graph edge; 16 instances are rerun whole on the card and on the CPU, and
   every output (edges, counts, pools, ``iters``, ``searches``) must be
   equal.  Each path's first launch of each ``its_select`` kernel (the
   operands recorded during the warm-up, which runs the timed call's first
   step under the same key) is held against the plain version: the frontier
   selects under ``traversal`` in the ``its_select`` entry, the neighbor
   rows in ``its_select_wide`` (times per launch), with rows of P = 4,097
   at K = 33, with each of its four phases' device time in one traced
   call (``phase_ms``) and its scratch's bytes.  The wide kernel is also timed on the warp kernel's
   operands (``wide_ms``: the frontier selects, and the opaque path's rows);
11. segments — ``random_walk_segments``, R requests in one batch, each row
   under its own key: ``segments`` (R-MAT 21, ``deepwalk``, 64 rows of
   32,768 walkers, ``arange(V)`` reshaped, depth 40: one ``derive_keys``
   and one ``reject_step`` launch a step; rows 0, 31 and 63 equal
   standalone card walks under their keys, the first 4,096 walkers of row
   0 a CPU rerun), ``segments its`` and ``segments alias`` (the power-law
   graph, 64 rows of 15,625); each step kernel with its key table against
   its plain version at the call's first step (``<kernel>_rows`` entries)
   and ``derive_keys`` against ``threefry.fold_in``; the serving shape of
   ``benchmarks/bench_serve.py`` (64 requests of 9-16 seeds padded to 16,
   depth 16: one fused call against 64 standalone calls); node2vec
   (R-MAT) and the opaque hook (power-law) at 4 rows of 4,096, depth 4,
   against the CPU;
12. oom — ``oom_random_walk`` at ``benchmarks/fig13_oom.py``'s settings on
   the R-MAT graph (8 vertex-range partitions, ``biased_random_walk``,
   2,000 instances, depth ``OOM_DEPTH`` (fig13's 16, cut to 8), two
   partitions resident, two streams, chunks of 1,024): the four Fig. 13 configurations (base, +BA, +BA+WS,
   +BA+WS+BAL), then node2vec at 256 instances and depth 4, after a
   one-instance warm-up that builds the partitions' host plan and alias
   tables (``plan_s``).  Each reports
   seconds, SEPS, the ``OOMStats`` counters and the drain's ms a chunk;
   every hop must be an edge; the first 256 instances, traced on the card
   (idle share, from a trace of the card's events alone) and rerun on the
   CPU, must give equal walks and stats.
13. lm — the LM harness (after every sampling phase), two ``paths``
   entries.  ``lm_walk``: ``examples/walk_corpus_lm_torch.py --scale 100m``
   (8 layers, d_model 640, vocabulary 20,000, f32): its DeepWalk corpus
   (4,096 walks of 64 on a 20,000-vertex power-law graph) built on the
   card with the step kernels' launches counted (at least one must launch)
   and equal to a CPU rerun, then 60 AdamW steps at batch 8 × 64 (loss
   finite and falling), a checkpoint at step 30 restored into a fresh
   model, optimizer state and pipeline whose replay of steps 30-39 equals
   the uninterrupted run (1e-5 relative); ``kernels.ops``' two helpers
   against their plain versions.  ``lm_gemma3_1b``: ``get_config("gemma3_1b")``
   as it stands (26 layers, d_model 1,152, vocabulary 262,144, bf16,
   ``remat="full"``, 2 microbatches, about 1.0B parameters): 6 train steps
   on batch 8 × 1,024 of the reference's learnable pattern (loss finite,
   falling), prefill of 8 × 1,024 and 16 decode steps from a cache of
   1,024 + 16; then the weights cast to f32 (TF32 off): loss and logits on
   1 × 128 tokens against the CPU port (loss 1e-4 relative, logits 1e-4 of
   their scale), and 16 decode steps against the forward's logits at those
   positions (3e-3).  Each prints ms a step, tokens/s, peak GiB (and the
   corpus's seconds, the prefill's ms and the decode's ms a token) and a
   torch.profiler trace of one train step (gemma3_1b: and of one decode
   token): device busy ms, idle share, top kernels.  Then the expert and
   recurrent cells, each with the same steps, checks and row (the cuts in
   its ``cut``): ``lm_xlstm_350m`` (the full config, 24 layers, d_model
   1,024, bf16, ``reduce_dtype="bf16"``; 6 AdamW steps on one batch of the
   launcher's ``--data walks`` corpus, 4,096 walks of 1,024 drawn on the
   card, ``reject_step`` launched; its train trace the card's events
   alone), ``lm_recurrentgemma_9b`` (serving at all 38 layers, 9.4B
   parameters; training 5 layers at full width) and ``lm_arctic_480b`` (one
   layer: serving with its 128 experts, 14.1B parameters, on tokens drawn
   from the vocabulary, with the share of (token, choice) pairs that
   capacity dropped in prefill; training with 16 experts, Adafactor, 4
   microbatches).  The f32 check's bounds are the larger of the fixed ones
   and four times what the CPU's result moves under a 1e-7 jitter of the
   weights; an expert config's decode is held against a forward whose
   capacity drops nothing.  No new kernel: the LM path's products,
   attention, experts and recurrent cells are torch ops.
   ``scripts/lm_steps.py`` runs this phase alone.
14. the device mesh: ``make_host_mesh()`` on the card (NCCL, a world of
   one, mesh (1, 1)); ``make_production_mesh()`` must refuse one card,
   naming its 256 ranks.  ``mesh_gemma3_1b``: ``lm_gemma3_1b``'s config and
   shapes (bf16, remat, 2 microbatches, 8 × 1,024): a fresh seed-0 model's
   prefill of 8 × 1,024 and 16 greedy decode tokens at batch 8, then
   ``MESH_GEMMA_STEPS`` AdamW steps, once without a mesh and once with the
   model placed on the mesh (``shard_model``, ``shard_cache``, the steps
   built with the mesh): losses, gradient norms, the prefill's argmax and
   the decoded tokens must be equal; ms a step and peak GiB both ways (the
   difference is DTensor's dispatch on the host).  ``mesh_arctic_480b``:
   ``lm_arctic_480b``'s training layer (1 layer, 16 experts, Adafactor, 4
   microbatches), ``MESH_ARCTIC_STEPS`` steps both ways, equal; it runs the
   experts' local dispatch region on the card.  The world of one is
   destroyed after them.  ``scripts/mesh_steps.py`` runs this phase and the
   launcher alone.
15. the user entry points, last: ``launch_gemma3_1b`` runs
   ``python -m repro_torch.launch.train`` in child processes as users run
   it, without a mesh (a single process; a mesh needs ``torchrun`` or
   ``--production-mesh``;
   ``LAUNCH_ARGS``: the full gemma3_1b config, batch 8 × 1,024 on the
   ``--data walks`` corpus, whose ``reject_step`` launches the child
   prints): 4 steps, whose checkpoints after step 2 are then removed, and a
   rerun in the same directory that restarts at 2, whose losses at steps 2-3 must be within
   ``LAUNCH_RESTART_RTOL`` of the straight run's (ms a step: the median of
   a process's steps after its first; tokens/s, peak GiB); ``graphsaint``
   trains ``examples/graphsaint_gcn_torch.py``'s GCN for 40 rounds at 16
   and 2,000 instances (accuracy above 0.6; the first 3 rounds' sampled
   vertex sets equal to the CPU port's); ``quickstart`` runs
   ``examples/quickstart_torch.py`` (the first 256 walks of each algorithm
   and the neighbor sample equal to the CPU port's); ``serve_batch`` runs
   ``examples/serve_batch_torch.py``'s five modes (in memory, ``--oom`` and
   ``--sharded`` equal to the CPU port's service request for request; no
   streamed request fails; ``--lm`` decodes).  Each records its kernels'
   launches.  ``scripts/entry_steps.py`` runs this phase alone.

Each path runs with the kernels' launch counts set to 0 just before and read
just after; a kernel its path never launched fails the run, and a flat
path (segments too) must launch each of its methods' kernels once a step.

Each path also records its counted-RNG time per step (flat paths: the host's
key derivation and the draws the step still makes outside a kernel; CUDA
events from an idle device, as ``loop_ms``), and a torch.profiler trace of
two-step walks, repeated until the trace spans 20 ms: device busy time,
idle share and the kernels that took the most device time.

Usage, from the root of a checkout (builds the kernels into build/kernels/):

    python3 chip_smoke.py

Prints a ``paths`` line (SEPS and ms per step per path, timed after a
one-step warm-up call; a traversal path's SEPS is its sampled edges over
the call, beside its ``iters``, ``searches``, launches, peak memory and idle
share; a flat path's walk again as ``steady_*``, with the
allocator's pool already grown by the first; ``plan_s``, the host's plan
and table build, which on the alias path is the alias build; the device
hash check), a ``kernels`` line (per kernel: ms per step, bound,
``x_bound``, plain ms, all measured in this run), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: 32-bit integer lanes of an SM (Hopper: 16 INT32 lanes in each of 4
#: partitions); the rate is these times the SMs times the SM clock
INT32_LANES_PER_SM = 64
#: 32-bit integer operations of one counted uniform (threefry2x32: 2 key
#: adds, 20 rounds of add, rotate and XOR, 5 key injections of 2 adds; the
#: XOR of the two words, the shift and the OR of the bits)
HASH_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3

RMAT_SCALE = 21
POWERLAW_VERTICES = 1_000_000
SEED = 7
DEPTH = 40
NODE2VEC_DEPTH = 3  # cut from 40 (10 until the segment and OOM paths came, 5 until the mesh)
EPILOGUE_DEPTH = 40
CHECK_WALKERS = 4096
TELEPORT_PROB = 0.15
#: its_select's collision check: K draws, ITERS rounds
SELECT_K, SELECT_ITERS = 8, 32
TIMING_REPS = 20
PROFILE_MIN_S = 0.02  # the shortest trace
#: a trace of at most this many device events is also summed through
#: ``key_averages`` (half a millisecond an event), as a cross-check
PROFILE_CROSSCHECK_EVENTS = 5000
PLAIN_CHUNK = 1 << 18  # walkers per plain-version call (bounds its temporaries)
#: traversal sampling: the paper's count of sampling instances
#: (benchmarks/fig09_seps.py), the instances rerun on the CPU, the retry
#: budget of a selection, MDRW's pools (fig09: 8 seeds, capacity 16, depth 16)
TRAVERSAL_INSTANCES = 2000
TRAVERSAL_CHECK = 16
SELECT_BUDGET = 32
MDRW_SEEDS, MDRW_CAPACITY, MDRW_DEPTH = 8, 16, 16
POOL_CAPACITY = 64
#: the segment walk (many requests in one batch): R rows of W walkers
#: (``arange(V)`` reshaped, one walker a vertex), the serving shape of
#: ``benchmarks/bench_serve.py`` (R rows of 16 walkers, each request 9-16
#: seeds, depth 16), and the small window and opaque checks against the CPU
SEGMENT_ROWS = 64
SERVE_WIDTH, SERVE_DEPTH = 16, 16
SEGMENT_CHECK_ROWS, SEGMENT_CHECK_WIDTH, SEGMENT_CHECK_DEPTH = 4, 4096, 4
#: serving at ``benchmarks/bench_serve.py``'s traffic: requests a mix, the
#: skewed mix's depths and their odds, timed drains a service (the unfused
#: one is slower), the OOM placement's depths, and the open-loop population
#: of the streaming service (requests, depth, width bucket, largest cohort,
#: batching window)
SERVE_REQUESTS, SERVE_REPS, SERVE_SEQ_REPS = 64, 5, 2
SKEWED_DEPTHS, SKEWED_P = (4, 8, 16, 32, 64), (0.35, 0.3, 0.2, 0.1, 0.05)
OOM_SERVE_DEPTHS = (4, 8, 16)
#: the sharded phases: shards on the one card, and each path's walkers,
#: depth and exchange slots
SHARDS = 4
SHARD_CHECK_DEPTH = 8
SHARD_MIXED_WALKERS, SHARD_MIXED_DEPTH, SHARD_MIXED_SLOTS = 65_536, 16, 4_096
SHARD_PL_WALKERS, SHARD_PL_DEPTH, SHARD_PL_SLOTS = 1_000_000, 16, 65_536
SHARD_SMALL_WALKERS, SHARD_SMALL_DEPTH = 4_096, 8
SHARD_OPAQUE_WALKERS, SHARD_OPAQUE_DEPTH = 1_024, 4
STREAM_REQUESTS, STREAM_DEPTH, STREAM_WIDTH = 150, 8, 16
STREAM_MAX_COHORT, STREAM_WINDOW_MS = 16, 10.0
#: the out-of-memory walk at ``benchmarks/fig13_oom.py``'s settings, and the
#: instances rerun on the CPU
OOM_PARTITIONS, OOM_INSTANCES, OOM_DEPTH = 8, 2000, 8  # fig13's depth 16, cut for the mesh
OOM_CHECK, OOM_WINDOW_DEPTH = 256, 4
OOM_CONFIGS = {
    "base": dict(batched=False, workload_aware=False, balance=False),
    "+BA": dict(batched=True, workload_aware=False, balance=False),
    "+BA+WS": dict(batched=True, workload_aware=True, balance=False),
    "+BA+WS+BAL": dict(batched=True, workload_aware=True, balance=True),
}
#: the wide its_select kernel's phases, in launch order, by their kernels
WIDE_PHASES = {"totals": "its_select_chunk_kernel", "prefixes": "its_select_prefix_kernel",
               "envelope": "its_select_envelope_kernel", "rounds": "its_select_rounds_kernel"}
#: the LM phases: the walk LM's scale, batch, sequence, steps, the
#: checkpoint step and the steps replayed after it; gemma3_1b's batch,
#: sequence, train steps, decode tokens and the f32 cross-check's tokens
LM_WALK_SCALE, LM_WALK_BATCH, LM_WALK_SEQ, LM_WALK_STEPS = "100m", 8, 64, 60
LM_WALK_CKPT, LM_WALK_REPLAY, LM_WARMUP_STEPS = 30, 10, 5
LM_BATCH, LM_SEQ, LM_TRAIN_STEPS, LM_DECODE, LM_CHECK_SEQ = 8, 1024, 6, 16, 128
#: the f32 check's weight jitters, and its bound for a recurrent cell alone
LM_JITTERS, LM_CELL_TOL = 3, 1e-4
#: the expert and recurrent LM phases: xLSTM's corpus (the launcher's
#: ``--data walks``: a power-law graph of up to 20,000 vertices, 4,096 walks
#: of LM_SEQ), recurrentgemma's training depth (one pattern repetition and
#: the two tail RG-LRU layers), arctic's depth and its training experts
XLSTM_GRAPH_VERTICES, XLSTM_WALKS = 20_000, 4096
RGEMMA_TRAIN_LAYERS = 5
ARCTIC_LAYERS, ARCTIC_TRAIN_EXPERTS = 1, 16
#: the mesh phases: train steps of gemma3_1b and arctic's training layer on
#: the host mesh (a world of one) and without it; both must give equal
#: losses, gradient norms and greedy tokens (on a mesh of one every
#: placement is whole, and the mesh step runs the same kernels in the same
#: order: bit-equal is the bound)
MESH_GEMMA_STEPS, MESH_ARCTIC_STEPS = 3, 2
#: the user entry points: the launcher's arguments (the full gemma3_1b
#: config on the walk corpus), its straight run's steps and the step the
#: restarted run resumes at, and the bound on the restarted run's losses
#: against the straight run's (relative; the log prints four decimals);
#: GraphSAINT's instance counts (the example's default and fig09's count),
#: the rounds and the first rounds held against the CPU; the walkers and
#: the neighbor-sampling pools of the quickstart held against the CPU
LAUNCH_BATCH, LAUNCH_SEQ = 8, 1024
LAUNCH_ARGS = ("--arch", "gemma3-1b", "--batch", str(LAUNCH_BATCH), "--seq", str(LAUNCH_SEQ),
               "--data", "walks", "--ckpt-every", "2", "--log-every", "1")
LAUNCH_STEPS, LAUNCH_RESUME, LAUNCH_RESTART_RTOL = 4, 2, 1e-3
SAINT_INSTANCES, SAINT_ROUNDS, SAINT_CHECK_ROUNDS = (16, 2000), 40, 3
QUICK_CHECK_WALKERS, QUICK_POOLS = 256, 512
KERNELS = ("reject_step", "alias_step", "walk_step", "walk_step_window", "its_select",
           "its_select_wide", "reject_step_rows", "alias_step_rows", "walk_step_rows",
           "derive_keys", "reject_step_entries", "alias_step_entries", "walk_step_entries")


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", file=sys.stderr, flush=True)


def _require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


class Smoke:
    def __init__(self):
        import torch

        from repro_torch import kernels
        from repro_torch.core import (
            algorithms, backend, engine, methods, oom, rng, select, transition)
        from repro_torch.graph import generators, partition
        from repro_torch import serve, shard
        from repro_torch.graph import csr
        from repro_torch.kernels import _build, ref, threefry
        from repro_torch.serve.stream import percentile

        self.torch, self.kernels, self.alg = torch, kernels, algorithms
        self.bk, self.eng, self.mt, self.rng, self.tp = backend, engine, methods, rng, transition
        self.sel, self.oom, self.partition = select, oom, partition
        self.its_mod = importlib.import_module("repro_torch.kernels.its_select")
        self.gen, self.build, self.ref, self.threefry = generators, _build, ref, threefry
        self.serve, self.percentile = serve, percentile
        self.shard, self.csr = shard, csr
        self.shard_walk = importlib.import_module("repro_torch.shard.walk")
        self.card = _card_line()
        self.dev = torch.device("cuda")
        self.key = rng.PRNGKey(SEED)
        self.paths: list[dict] = []
        self.kernel_rows: dict[str, dict] = {}
        self.hash_row: dict = {}
        self.wide_entries: dict[str, dict] = {}
        self.narrow_entries: dict[str, dict] = {}
        self.traversal_launches: dict[str, dict] = {}
        self._cpu_graphs: dict = {}
        self.sm_clock_mhz = _max_sm_clock_mhz()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.int32_ops_per_s = sms * INT32_LANES_PER_SM * self.sm_clock_mhz * 1e6

    # -- helpers -----------------------------------------------------------

    def sync(self):
        self.torch.cuda.synchronize()

    def loop_ms(self, fn, reps: int) -> float:
        """Ms per call of ``fn``: CUDA events around ``reps`` calls after a
        warm-up call, from an idle device.  Where the host takes longer to
        issue a call than the device to run it, the host's time counts: what
        a caller pays."""
        torch = self.torch
        fn()
        self.sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        self.sync()
        return start.elapsed_time(end) / reps

    def device_ms(self, fn, reps: int, loop_ms: float) -> float:
        """Ms per call of ``fn`` on the device alone: CUDA events around
        ``reps`` calls queued behind a device spin (``torch.cuda._sleep``)
        twice as long as :meth:`loop_ms` says the host needs to queue them,
        so the calls run back to back."""
        torch = self.torch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * reps * loop_ms * 1e-3 * self.sm_clock_mhz * 1e6))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        self.sync()
        return start.elapsed_time(end) / reps

    def cpu_graph(self, g):
        """One CPU copy per graph, shared by its paths' cross-checks."""
        if g.uid not in self._cpu_graphs:
            self._cpu_graphs = {g.uid: g.to("cpu")}
        return self._cpu_graphs[g.uid]

    def check_walks(self, g, res, seeds, depth, hop_rule):
        """Every hop is an edge, or what the path's epilogue allows instead:
        an MH stay (``"stay"``), a jump to any vertex (``"any"``), a restart
        to the walk's seed (``"seed"``).  Walks start at their seeds; no
        walker revives.  Returns (hops, hops that are not edges)."""
        torch = self.torch
        walks = res.walks
        _require(walks.shape == (seeds.shape[0], depth + 1), f"walks of shape {walks.shape}")
        _require(torch.equal(walks[:, 0], seeds), "walks do not start at their seeds")
        alive = walks >= 0
        _require(not (alive[:, 1:] & ~alive[:, :-1]).any(), "a walker came back to life")
        v = g.num_vertices
        a, b = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
        hop = b >= 0
        a, b = a[hop], b[hop]
        is_edge = self.is_edge(g, a, b)
        ok = is_edge
        if hop_rule == "stay":
            ok = ok | (b == a)
        elif hop_rule == "any":
            ok = ok | (b < v)
        elif hop_rule == "seed":
            home = seeds.long()[:, None].expand(-1, depth).reshape(-1)[hop]
            ok = ok | (b == home)
        bad = int((~ok).sum())
        _require(bad == 0, f"{bad} hops are neither edges nor allowed by the epilogue")
        _require(int(res.sampled_edges) == int(hop.sum()), "sampled_edges disagrees with the walks")
        return int(hop.sum()), int((~is_edge).sum())

    def is_edge(self, g, a, b):
        """Whether each ``(a, b)`` (vertex ids >= 0) is an edge of ``g``."""
        torch = self.torch
        v = g.num_vertices
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        row = torch.repeat_interleave(torch.arange(v, device=g.device), deg)
        edge_key = row * v + g.indices.long()  # ascending: rows are sorted
        q = a * v + b
        pos = torch.searchsorted(edge_key, q).clamp(max=edge_key.shape[0] - 1)
        return edge_key[pos] == q

    # -- one path ----------------------------------------------------------

    def run_path(self, name, g, spec, kernel_name, gen_s, *, expect_plan=None, depth=DEPTH,
                 hop_rule=None):
        torch, bk = self.torch, self.bk
        program = self.tp.lower(spec)
        max_degree = g.max_degree()
        methods, tables, buckets = (), None, ()
        t0 = time.perf_counter()
        if program.mode == "flat":
            methods, tables = self.eng.flat_method_plan(g, program, max_degree)
            buckets, use_chunked = bk.walk_bucket_plan(max_degree)
            plan = self.mt.describe_plan(methods, buckets, use_chunked)
            _require(methods == expect_plan, f"{name}: planned {methods}, expected {expect_plan}")
            _require(use_chunked, f"{name}: the graph has no huge-degree tail")
        elif program.mode == "window":
            buckets, use_chunked = bk.walk_bucket_plan_window(max_degree)
            plan = {"window_buckets": list(buckets), "chunked_window_tail": use_chunked}
        else:
            plan = {"dense_width": max_degree, "its_select_width": -(-max_degree // bk.LANES) * bk.LANES}
        plan_s = time.perf_counter() - t0
        _log(f"[{name}] V={g.num_vertices} E={g.num_edges} max_degree={max_degree} plan={plan}")

        seeds = torch.arange(g.num_vertices, dtype=torch.int32, device=self.dev)
        walk = dict(depth=depth, spec=spec, max_degree=max_degree, device=self.dev)
        self.eng.random_walk(g, seeds, self.key, **dict(walk, depth=1))  # warm-up
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = self.eng.random_walk(g, seeds, self.key, **walk)
        self.sync()
        seconds = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steady_s = None
        if methods:  # a flat walk again, the allocator's pool grown by the first
            t0 = time.perf_counter()
            self.eng.random_walk(g, seeds, self.key, **walk)
            self.sync()
            steady_s = time.perf_counter() - t0
        _require(launches[kernel_name] > 0, f"{name}: {kernel_name} never launched: {launches}")
        if methods:  # one launch per method and step
            for k in _step_kernels(methods, len(buckets)):
                _require(launches[k] == depth, f"{name}: {launches[k]} {k} launches in {depth} steps")
        edges, off_edge = self.check_walks(g, res, seeds, depth, hop_rule)
        row = dict(
            path=name, spec=spec.name, mode=program.mode, method=program.method,
            vertices=g.num_vertices, csr_entries=g.num_edges, max_degree=max_degree,
            walkers=g.num_vertices, depth=depth, plan=plan, launches=launches,
            sampled_edges=edges, off_edge_hops=off_edge, seconds=seconds,
            seps=edges / seconds, ms_per_step=1e3 * seconds / depth,
            steady_seps=edges / steady_s if steady_s else None,
            steady_ms_per_step=1e3 * steady_s / depth if steady_s else None,
            peak_gib=peak_gib, graph_s=gen_s, plan_s=plan_s,
        )
        _log(f"[{name}] {json.dumps(row)}")

        # cross-check: the first walkers again, on the CPU, by the plain versions
        n = min(CHECK_WALKERS, g.num_vertices)
        t0 = time.perf_counter()
        cpu = self.eng.random_walk(self.cpu_graph(g), seeds[:n].cpu(), self.key,
                                   **dict(walk, device="cpu"))
        same = torch.equal(cpu.walks, res.walks[:n].cpu())
        _require(same, f"{name}: card walks differ from the CPU walks of the first {n} walkers")
        row["cpu_check_walkers"] = n
        row["cpu_check_s"] = time.perf_counter() - t0
        row["rng_ms_per_step"] = self.rng_ms(g, methods, buckets) if methods else None
        self.paths.append(row)
        last = res.walks[:, depth - 2:depth].clone() if depth >= 2 else None  # (prev, cur)
        del res, cpu

        if kernel_name not in self.kernel_rows:
            later = None
            if kernel_name == "walk_step_window":
                seeds_prev = torch.full_like(seeds, -1)
                entries = self.measure_window(name, g, spec, seeds, seeds_prev, 0)
                later = self.measure_window(name, g, spec, last[:, 1], last[:, 0], depth - 1)
            elif kernel_name == "its_select":
                entries = self.measure_select(name, g, spec)
            else:
                flat = lambda cur, step: self.measure_flat(  # noqa: E731
                    name, g, spec, methods, tables, buckets, kernel_name, cur, step)
                entries = flat(seeds, 0)
                later = flat(last[:, 1].contiguous(), depth - 1)
            self.kernel_row(kernel_name, name, entries)
            if kernel_name == "its_select":  # the wide kernel on the same rows
                self.kernel_rows[kernel_name]["wide_ms"] = sum(e["wide_ms"] for e in entries)
                self.kernel_rows[kernel_name]["traversal"] = self.narrow_entries
            if later is not None:
                ms, bound = sum(e["ms"] for e in later), sum(e["bound_ms"] for e in later)
                self.kernel_rows[kernel_name]["later_step"] = dict(
                    step=depth - 1, ms=ms, bound_ms=bound, x_bound=ms / bound, cohorts=later)
            row["kernel_ms_per_step"] = self.kernel_rows[kernel_name]["ms"]
        del last
        row.update(self.profile(
            name, lambda: self.eng.random_walk(g, seeds, self.key, **dict(walk, depth=2))))
        return row

    def rng_ms(self, g, methods, buckets):
        """Ms of one step's counted RNG outside the kernels at W walkers
        (one a vertex), as ``walk_step_adaptive`` runs it: the host's key
        derivation, and an ITS tail's uniforms for its walkers alone.  The
        three step kernels hash theirs in the kernel."""
        torch, rng = self.torch, self.rng
        deg = g.indptr[1:] - g.indptr[:-1]
        huge = torch.nonzero(deg > buckets[-1]).squeeze(1)
        tail = methods[len(buckets)]

        def draws():
            kf = rng.fold_in(rng.fold_in(self.key, 0), 1)
            if "its" in methods[:len(buckets)]:
                rng.fold_in(kf, 0)
            if "rejection" in methods:
                kb = rng.fold_in(kf, 2)
                for t in range(2 * self.ref.REJECT_ITERS):
                    rng.fold_in(kb, t)
            if "alias" in methods:
                rng.fold_in(kf, 0), rng.fold_in(kf, 1)
            if tail == "its":
                rng.uniform_at(rng.fold_in(kf, 1), huge)

        return self.loop_ms(draws, 5)

    # -- per-kernel comparison, time and bound ------------------------------

    def compare(self, path, kernel_name, label, launch, plain, work, **extra):
        """Run a kernel and its plain version on the same inputs, count the
        mismatches (must be 0), and time both.  ``work(want)`` gives the
        bytes, f32 operations and 32-bit integer operations of the bound
        from the plain version's output, so the bound never rests on what
        the kernel under test returned."""
        got, want = launch(), plain()
        self.sync()
        if isinstance(got, tuple):  # its_select: (idx, stats)
            mismatches = sum(int((a != b).sum()) for a, b in zip(got, want))
            err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
            iters, searches = want[1].double().mean(dim=0).tolist()
            extra.update(mean_iters=iters, mean_searches=searches)
        else:
            mismatches = int((got != want).sum())
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        _require(mismatches == 0, f"{path}/{kernel_name} {label}: {mismatches} mismatches")
        nbytes, nops, nint = work(want)
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, self.ops_s(nops, nint)
        loop_ms = self.loop_ms(launch, TIMING_REPS)
        entry = dict(
            cohort=label, mismatches=mismatches, max_abs_err=err,
            ms=self.device_ms(launch, TIMING_REPS, loop_ms), loop_ms=loop_ms,
            plain_ms=self.loop_ms(plain, 2),
            bound_ms=max(by_bytes, by_ops) * 1e3,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=nbytes, ops=nops, int_ops=nint, **extra,
        )
        _log(f"[{path}] {kernel_name} {json.dumps(entry)}")
        return entry

    def chunked(self, fn, w):
        """A plain version over W walkers, in chunks (bounds its temporaries)."""
        torch = self.torch

        def run():
            outs = [fn(slice(i, i + PLAIN_CHUNK)) for i in range(0, w, PLAIN_CHUNK)]
            if isinstance(outs[0], tuple):
                return tuple(torch.cat(parts) for parts in zip(*outs))
            return torch.cat(outs)

        return run

    def ops_s(self, nops, nint):
        """Seconds the card needs for ``nops`` f32 and ``nint`` 32-bit
        integer operations at their peak rates."""
        return nops / F32_OPS_PER_S + nint / self.int32_ops_per_s

    def measure_flat(self, path, g, spec, methods, tables, buckets, kernel_name, cur, step,
                     key=None):
        """Step ``step`` of the path for walkers at ``cur``, as
        ``walk_step_adaptive`` runs it: one launch of ``kernel_name`` for
        all the cohorts of its method.  ``key`` (the segment walk's
        ``RowKeys``) launches the kernel with a table of each row's keys."""
        torch, rng, ref, K = self.torch, self.rng, self.ref, self.kernels
        bias = self.tp.lower(spec).bias.fn(g)
        w = cur.shape[0]
        kf = rng.fold_in(rng.fold_in(self.key if key is None else key, step), 1)
        plan = dict(buckets=buckets, use_chunked=True, methods=methods)
        _, _, deg = ref.walker_rows(g.indptr, cur)
        cohort = ref.walker_cohorts(deg, buckets, True)
        by_cohort = {f"seg={s}" if k < len(buckets) else "tail": int((cohort == k).sum())
                     for k, s in enumerate((*buckets, None))}
        out = torch.full_like(cur, -1)
        if kernel_name == "walk_step":
            launch = lambda: K.walk_step(kf, g.indptr, g.indices, bias, cur, out=out, **plan)  # noqa: E731
            plain_fn = lambda: ref.walk_step_ref(kf, g.indptr, g.indices, bias, cur, **plan)  # noqa: E731
        elif kernel_name == "reject_step":
            launch = lambda: K.reject_step(kf, g.indptr, g.indices, bias, tables.row_max, cur,  # noqa: E731
                                           out=out, **plan)
            plain_fn = lambda: ref.reject_step_ref(kf, g.indptr, g.indices, bias,  # noqa: E731
                                                   tables.row_max, cur, **plan)
        else:
            launch = lambda: K.alias_step(kf, g.indptr, g.indices, tables.prob, tables.alias,  # noqa: E731
                                          cur, out=out, **plan)
            plain_fn = lambda: ref.alias_step_ref(kf, g.indptr, g.indices, tables.prob,  # noqa: E731
                                                  tables.alias, cur, **plan)
        work = lambda want: self.work(kernel_name, g, cur, want, bias, tables, kf, plan)  # noqa: E731
        entry = self.compare(path, kernel_name, f"step={step}", launch, plain_fn, work, walkers=w,
                             live=int((deg > 0).sum()), walkers_by_cohort=by_cohort)
        if kernel_name == "walk_step" and key is None:
            # the same step from a bias 4 bytes off 16-byte alignment: the
            # kernel's word-by-word loads, which must pick as the 16-byte ones
            shifted = torch.empty(bias.shape[0] + 1, dtype=bias.dtype, device=self.dev)[1:]
            shifted.copy_(bias)
            out_s = torch.full_like(cur, -1)
            run = lambda: K.walk_step(kf, g.indptr, g.indices, shifted, cur, out=out_s, **plan)  # noqa: E731
            _require(torch.equal(run(), out), f"{path}: walk_step's word loads pick otherwise")
            entry["word_loads_ms"] = self.device_ms(run, TIMING_REPS, self.loop_ms(run, TIMING_REPS))
            del shifted
        return [entry]

    def work(self, kernel_name, g, cur, out, bias, tables, kf, plan):
        """Bytes, f32 and 32-bit integer operations this launch needs on
        this data: each output written once, each input word read once
        however many walkers read it (walkers at one vertex share its row
        offsets, envelope, bias row and ids); a rejection draw counts the
        rounds up to its acceptance, each two hashed uniforms; an ITS draw
        hashes one uniform when its row has mass, scans each capped row once
        and compares each walker's uniform with its row's prefixes; an alias
        draw hashes one uniform (two in the tail), reads one table entry
        (its prob and alias words) and does 3 f32 operations."""
        torch, ref = self.torch, self.ref
        buckets, methods = plan["buckets"], plan["methods"]
        w = cur.shape[0]
        safe, starts, deg = ref.walker_rows(g.indptr, cur)
        cohort = ref.walker_cohorts(deg, buckets, plan["use_chunked"])
        cap = deg
        for k, seg in enumerate(buckets):
            cap = torch.where(cohort == k, torch.clamp(deg, max=seg), cap)

        def words(*parts):  # 4 bytes for each distinct index
            return 4 * int(torch.unique(torch.cat([p.long() for p in parts])).numel())

        method = {"walk_step": "its", "reject_step": "rejection", "alias_step": "alias"}[kernel_name]
        served = torch.zeros_like(cur, dtype=torch.bool)
        for k, m in enumerate(methods):
            if m == method and (k < len(buckets) or method != "its"):
                served |= cohort == k
        n_served = int(served.sum())
        picked = served & (out >= 0)
        n_picked = int(picked.sum())
        live = cur >= 0
        # cur; row offsets; out; ids (one per distinct (vertex, pick))
        nbytes = (4 * w + words(safe[live], safe[live] + 1) + 4 * n_served
                  + words(safe[picked] * g.num_vertices + out[picked].long()))
        if kernel_name == "walk_step":
            row_cap = torch.zeros(g.num_vertices, dtype=torch.int64, device=cur.device)
            row_cap[safe[served]] = cap[served].long()  # a vertex's cap is its cohort's
            rows = int(row_cap.sum())
            entries = int(cap[served].long().sum())
            # each row once, per entry the in-block add and the prefix add; per
            # walker and entry the compare; the uniform of each row with mass
            return nbytes + 4 * rows, 2 * rows + entries, HASH_INT_OPS * n_picked
        if kernel_name == "alias_step":
            idx = torch.nonzero(served).squeeze(1)
            in_tail = cohort[idx] == len(buckets)
            r = torch.where(in_tail, self.rng.uniform_at(self.rng.fold_in(kf, 1), idx),
                            self.rng.uniform_at(self.rng.fold_in(kf, 0), idx))
            c = cap[idx]
            slot = torch.minimum((r * c.float()).int(), c - 1)
            # the table entries the draws read, 8 bytes each
            return (nbytes + 2 * words(starts[idx] + slot), 3 * n_served,
                    HASH_INT_OPS * (n_served + int(in_tail.sum())))
        rm = tables.row_max[safe]
        rej = ref.rejection_randoms(self.rng.fold_in(kf, 2), (w,), device=self.dev)
        hi = torch.clamp(cap - 1, min=0)
        todo = served & (rm > 0)
        rounds, reached = torch.zeros_like(cap), []
        for t in range(rej.shape[1]):
            slot = torch.minimum((rej[:, t, 0] * cap.float()).int(), hi)
            pos = (starts + slot).long().clamp(max=bias.shape[0] - 1)
            acc = rej[:, t, 1] * rm < bias[pos]
            reached.append(pos[todo])
            rounds += todo.int()
            todo = todo & ~acc
        n_rounds = int(rounds.long().sum())
        del rej
        # the envelopes; the bias words the rounds reach; per round 3 f32
        # operations and 2 uniforms
        return (nbytes + words(safe[served]) + words(*reached), 3 * n_rounds,
                2 * HASH_INT_OPS * n_rounds)

    def measure_window(self, path, g, spec, cur, prev, step):
        """``walk_step_window`` on step ``step``'s cohorts of walkers at
        ``cur`` (``prev`` before them), built as ``walk_step_bucketed_window``
        builds them: members only, their bias rows from the node2vec hook,
        the step's own uniforms."""
        torch, rng, bk, ref, K = self.torch, self.rng, self.bk, self.ref, self.kernels
        w = g.num_vertices
        md = g.max_degree()
        program = self.tp.lower(spec)
        bias_of = self.eng._window_bias_fn(g, program, cur, prev, step, md)
        kf = rng.fold_in(rng.fold_in(self.key, step), 1)
        r = rng.uniform(rng.fold_in(kf, 0), (w,), device=self.dev)
        safe = torch.clamp(cur, min=0).long()
        starts = g.indptr[safe]
        deg = torch.where(cur >= 0, g.indptr[safe + 1] - starts, 0)
        buckets, use_chunked = bk.walk_bucket_plan_window(md)
        entries, lo = [], 0
        for i, seg in enumerate(buckets):
            absorb = i == len(buckets) - 1 and not use_chunked
            rows = torch.nonzero((deg > lo) & ((deg <= seg) | absorb)).squeeze(1)
            lo = seg
            st, dg = starts[rows], torch.clamp(deg[rows], max=seg)
            bias = bk.window_bias_rows(g.indices, g.weights, st, dg, rows, bias_of, seg)
            rr = r[rows]
            launch = lambda st=st, dg=dg, bias=bias, rr=rr, seg=seg: K.walk_step_window(
                st, dg, g.indices, bias, rr, max_seg=seg)
            plain_fn = lambda s, st=st, dg=dg, bias=bias, rr=rr, seg=seg: ref.walk_step_window_block_ref(
                st[s], dg[s], g.indices, bias[s], rr[s], seg=seg)
            work = lambda want, st=st, dg=dg: self.window_work(st, dg, want)  # noqa: E731
            entries.append(self.compare(path, "walk_step_window", f"step={step} seg={seg}", launch,
                                        self.chunked(plain_fn, rows.shape[0]), work,
                                        walkers=rows.shape[0], live=rows.shape[0],
                                        mean_degree=float(dg.float().mean()) if rows.numel() else 0.0))
            del bias
        return entries

    def window_work(self, st, dg, out):
        """``walk_step_window``'s bytes and operations on this data: per
        walker its start, degree, uniform and output, one id word for each
        distinct (row, pick), and per entry of the walker's own bias row one
        word and the in-block add, the prefix add and the compare."""
        w = dg.shape[0]
        entries = int(dg.long().sum())
        picked = out >= 0
        pairs = st[picked].long() * 2**31 + out[picked].long()
        ids = 4 * int(self.torch.unique(pairs).numel())
        return 8 * w + 8 * w + ids + 4 * entries, 3 * entries, 0

    def measure_select(self, path, g, spec):
        """``its_select`` on the opaque path's first-step rows (the dense
        context's masked biases, padded to 128 lanes), in the engine's
        blocks: at K = 1 with the step's uniforms, and at K = 8 with 32
        rounds of a counted budget, so collisions and region search run, and
        at K = 8 with the first of those rounds alone, which parts the first
        round's cost from the later rounds'."""
        torch, rng, bk, ref, K = self.torch, self.rng, self.bk, self.ref, self.kernels
        w = g.num_vertices
        md = g.max_degree()
        cur = torch.arange(w, dtype=torch.int32, device=self.dev)
        kf = rng.fold_in(rng.fold_in(self.key, 0), 1)
        r = rng.uniform(kf, (w, 1, 1), device=self.dev)
        entries = []
        for b, s in enumerate(range(0, w, self.eng.GATHER_BLOCK)):
            blk = slice(s, s + self.eng.GATHER_BLOCK)
            ctx, mask = self.eng._edge_ctx(g, cur[blk], torch.full_like(cur[blk], -1), 0, md,
                                           spec.needs_prev_neighbors)
            biases = bk.pad_lanes(bk._masked(torch.where(mask, spec.edge_bias(ctx), 0.0), mask))
            biases = biases.contiguous()
            del ctx, mask
            n, p = biases.shape
            rr = r[blk].contiguous()
            r8 = rng.uniform(rng.fold_in(kf, 100 + b), (n, SELECT_ITERS, SELECT_K), device=self.dev)
            k8 = {}
            for key, rk in (("k8", r8), ("k8_1round", r8[:, :1].contiguous())):
                run = self.compare(
                    path, "its_select", f"block={b} K={SELECT_K} rounds={rk.shape[1]}",
                    lambda biases=biases, rk=rk: K.its_select(biases, rk),
                    self.chunked(lambda s, biases=biases, rk=rk: ref.its_select_ref(biases[s], rk[s]), n),
                    lambda want, n=n, p=p: self.select_work(n, p, SELECT_K, want[1]))
                k8.update({f"{key}_{m}": run[m] for m in (
                    "ms", "plain_ms", "bound_ms", "mismatches", "mean_iters", "mean_searches")})
                k8[f"{key}_x_bound"] = run["ms"] / run["bound_ms"]
            entries.append(self.compare(
                path, "its_select", f"block={b} K=1",
                lambda biases=biases, rr=rr: K.its_select(biases, rr),
                self.chunked(lambda s, biases=biases, rr=rr: ref.its_select_ref(biases[s], rr[s]), n),
                lambda want, n=n, p=p: self.select_work(n, p, 1, want[1]),
                walkers=n, width=p, **k8))
            entries[-1].update(self.time_wide(path, biases, rr))
            del biases, r8
        return entries

    @staticmethod
    def select_work(n, p, k, stats):
        """its_select's bytes and operations on this data, from the plain
        version's counters ``stats`` (rounds, searches per instance): the bias rows, one uniform
        per search (a region search reuses its draw's uniform, so this counts
        the uniforms read from above), indices and stats; the scan's adds and
        each search's divides and compares."""
        searches = int(stats[:, 1].long().sum())
        nbytes = 4 * n * p + 4 * searches + 4 * n * k + 8 * n
        nops = n * p + 2 * searches * max(1, (p - 1).bit_length())
        return nbytes, nops, 0

    def kernel_row(self, kernel_name, path, entries, launches=None):
        K = self.kernels
        total = lambda k: sum(e[k] for e in entries)  # noqa: E731
        by_bytes = sum(e["bytes"] for e in entries) / HBM_BYTES_PER_S
        by_ops = self.ops_s(sum(e["ops"] for e in entries), sum(e["int_ops"] for e in entries))
        src = {
            "reject_step": "src/repro/kernels/walk_step.py:267",
            "alias_step": "src/repro/kernels/alias_select.py:66",
            "walk_step": "src/repro/kernels/walk_step.py:158",
            "walk_step_window": "src/repro/kernels/walk_step.py:211",
            "its_select": "src/repro/kernels/its_select.py:113",
            "its_select_wide": "src/repro/kernels/its_select.py:113",
            "reject_step_rows": "src/repro/kernels/walk_step.py:267",
            "alias_step_rows": "src/repro/kernels/alias_select.py:66",
            "walk_step_rows": "src/repro/kernels/walk_step.py:158",
            "reject_step_entries": "src/repro/kernels/walk_step.py:267",
            "alias_step_entries": "src/repro/kernels/alias_select.py:66",
            "walk_step_entries": "src/repro/kernels/walk_step.py:158",
            # no TPU kernel: the per-row key derivation of jax.vmap in
            # random_walk_segments
            "derive_keys": "src/repro/core/engine.py:535",
        }
        self.kernel_rows[kernel_name] = dict(
            name=kernel_name, route="cuda", source="src/repro_torch/kernels/csrc/walk_kernels.cu",
            replaces=src[kernel_name], path=path,
            launches=self.paths[-1]["launches"][kernel_name] if launches is None else launches,
            launches_per_step=len(entries), mismatches=total("mismatches"),
            max_abs_err=max(e["max_abs_err"] for e in entries),
            ms=total("ms"), loop_ms=total("loop_ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=None,
            x_bound=total("ms") / total("bound_ms"),
            int32_ops_per_s=self.int32_ops_per_s, sm_clock_mhz=self.sm_clock_mhz,
            cohorts=entries,
        )
        # comparison launches are not the main path's: only the path's count stays
        K.reset_launch_counts()

    # -- traversal sampling ---------------------------------------------------

    def traversal_paths(self, g, gen_s):
        """Phase 10: the frontier-pool algorithms on the walk paths' graph,
        at ``TRAVERSAL_INSTANCES`` instances, seeds drawn from the vertices
        with at least one edge.  Every neighbor selection reads the whole
        row of a frontier vertex, ``max_degree`` wide, so none is cut."""
        for name, spec, seeds, depth, cap, mv in traversal_cases(self.alg, g):
            self.run_traversal(name, g, spec, seeds, depth, cap, mv, gen_s)
        self.wide_entries["check"] = self.measure_wide_check()
        wide = [self.wide_entries[k] for k in ("layer", "snowball", "neighbor", "mdrw", "check")]
        layer = self.traversal_launches["layer"]
        self.kernel_row("its_select_wide", "layer", wide, launches=layer["launches"])
        row = self.kernel_rows["its_select_wide"]
        row["launches_by_path"] = {k: v["launches"] for k, v in self.traversal_launches.items()}
        row["launches_per_step"] = layer["launches"] / layer["depth"]
        # the row's times are the layer path's first launch (one block of rows)
        for key in ("ms", "loop_ms", "plain_ms", "bound_ms", "phase_ms", "scratch_bytes"):
            row[key] = wide[0][key]
        row["x_bound"] = row["ms"] / row["bound_ms"]
        row["bound_by"] = wide[0]["bound_by"]

    def run_traversal(self, name, g, spec, seeds, depth, capacity, max_vertices, gen_s):
        torch, eng, K = self.torch, self.eng, self.kernels
        md = g.max_degree()
        fs, ns = spec.frontier_size, spec.neighbor_size
        kw = dict(spec=spec, max_degree=md, pool_capacity=capacity, max_vertices=max_vertices)
        pools = torch.from_numpy(seeds).to(self.dev)
        width = fs * md if not spec.per_vertex else md
        _log(f"[{name}] V={g.num_vertices} instances={seeds.shape[0]} seeds={seeds.shape[1]} "
             f"fs={fs} ns={ns} depth={depth} select_width={width}")
        # warm-up: the timed call's first step under the same key, which
        # records the operands of its first launch of each its_select kernel
        first = self.first_selects(lambda: eng.traversal_sample(
            g, pools, self.key, depth=1, device=self.dev, **kw))
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.traversal_sample(g, pools, self.key, depth=depth, device=self.dev, **kw)
        self.sync()
        seconds = time.perf_counter() - t0
        launches = K.launch_counts()
        wide = K.its_select.wide_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _require(launches["its_select"] > 0 and wide > 0,
                 f"{name}: its_select launched {launches['its_select']} times, {wide} wide")
        self.traversal_launches[name] = dict(launches=wide, depth=depth)
        edges = self.check_samples(g, res, seeds, spec.track_visited and max_vertices > 0,
                                   spec.per_vertex, name)
        row = dict(
            path=name, spec=spec.name, instances=seeds.shape[0], seeds=seeds.shape[1],
            depth=depth, pool_capacity=capacity, max_vertices=max_vertices, frontier_size=fs,
            neighbor_size=ns, max_degree=md, select_width=-(-width // self.bk.LANES) * self.bk.LANES,
            sampled_edges=edges, seconds=seconds, seps=edges / seconds,
            ms_per_step=1e3 * seconds / depth, iters=int(res.iters), searches=int(res.searches),
            launches=launches, its_select_wide_launches=wide, peak_gib=peak_gib, graph_s=gen_s,
        )
        _log(f"[{name}] {json.dumps(row)}")

        # cross-check: the first instances again, whole, on the card and on
        # the CPU; an instance's draws do not depend on the batch, so they
        # are also the full run's first instances
        n = TRAVERSAL_CHECK
        t0 = time.perf_counter()
        small = eng.traversal_sample(g, pools[:n], self.key, depth=depth, device=self.dev, **kw)
        cpu = eng.traversal_sample(self.cpu_graph(g), seeds[:n], self.key, depth=depth,
                                   device="cpu", **kw)
        for field, a, b in zip(cpu._fields, cpu, small):
            _require(torch.equal(a, b.cpu()), f"{name}: card {field} differs from the CPU's")
        for field in ("edges_src", "edges_dst", "num_edges", "frontier_pool"):
            _require(torch.equal(getattr(res, field)[:n].cpu(), getattr(cpu, field)),
                     f"{name}: the full run's first {n} instances differ in {field}")
        row["cpu_check_instances"] = n
        row["cpu_check_s"] = time.perf_counter() - t0
        self.paths.append(row)
        del res, small, cpu
        _require(set(first) == {"narrow", "wide"},
                 f"{name}: the first step launched only {sorted(first)} its_select kernels")
        biases, rands = first["narrow"]
        self.narrow_entries[name] = self.measure_first_select(name, "its_select", biases, rands,
                                                              with_wide=True)
        biases, rands = first["wide"]
        self.wide_entries[name] = self.measure_first_select(name, "its_select_wide", biases, rands)
        del first, biases, rands
        row.update(self.profile(name, lambda: eng.traversal_sample(
            g, pools, self.key, depth=2, device=self.dev, **kw)))
        return row

    def check_samples(self, g, res, seeds, tracked, per_vertex, name):
        """Every sampled edge is a graph edge out of a sampled vertex and the
        counts match the edges; with the visited map no instance samples
        its seed, and with per-vertex pools no vertex twice (a pooled row
        may hold one neighbor of two frontier vertices, and the reference
        may take both edges).  Returns the sampled edges."""
        torch = self.torch
        src, dst = res.edges_src.long(), res.edges_dst.long()
        hop = dst >= 0
        _require(bool((src[hop] >= 0).all()), f"{name}: a sampled edge without a source")
        bad = int((~self.is_edge(g, src[hop], dst[hop])).sum())
        _require(bad == 0, f"{name}: {bad} sampled edges are not graph edges")
        _require(torch.equal(res.num_edges.long(), hop.sum(dim=1)), f"{name}: num_edges")
        if tracked and per_vertex:
            d = torch.sort(torch.where(hop, dst, -1 - torch.arange(dst.shape[1], device=dst.device)),
                           dim=1).values
            _require(not bool((d[:, 1:] == d[:, :-1]).any()), f"{name}: a vertex sampled twice")
        if tracked:
            home = torch.from_numpy(seeds).to(dst.device).long()
            _require(not bool((dst[:, :, None] == home[:, None, :]).any()),
                     f"{name}: an instance sampled its own seed")
        return int(hop.sum())

    def first_selects(self, call):
        """Run ``call`` with the engine's ``its_select`` calls observed, and
        return the operands ``(biases, rands)`` of the first call that went
        to each kernel, keyed ``narrow`` (the warp kernel) and ``wide``."""
        bk, its = self.bk, self.its_mod
        first = {}

        def observed(biases, rands):
            narrow = rands.shape[2] <= its.MAX_K and biases.shape[1] <= its.MAX_P
            first.setdefault("narrow" if narrow else "wide", (biases, rands))
            return its.its_select(biases, rands)

        bk.its_select = observed
        try:
            call()
        finally:
            bk.its_select = its.its_select
        return first

    def measure_first_select(self, path, kernel_name, biases, rands, with_wide=False):
        """``its_select`` on the operands of one of the path's launches,
        against its plain version.  ``with_wide`` also runs the wide kernel
        on the warp kernel's operands, which must agree, and times it
        (``wide_ms``, ``wide_loop_ms``)."""
        K, ref = self.kernels, self.ref
        n, p = biases.shape
        k = rands.shape[2]
        entry = self.compare(
            path, kernel_name, f"step=0 first launch P={p} K={k}",
            lambda: K.its_select(biases, rands),
            self.chunked(lambda s: ref.its_select_ref(biases[s], rands[s]), n),
            lambda want: self.select_work(n, p, k, want[1]), rows=n, width=p, k=k)
        if with_wide:
            entry.update(self.time_wide(path, biases, rands))
        if kernel_name == "its_select_wide":
            entry.update(self.wide_phases(biases, rands))
        return entry

    def time_wide(self, path, biases, rands):
        """The wide kernel launched on operands the shape gives the warp
        kernel: its result must equal the plain version's; its device and
        loop times."""
        torch, ref = self.torch, self.ref
        launch = lambda: self.its_mod._launch(biases, rands, wide=True)  # noqa: E731
        got = launch()
        want = self.chunked(lambda s: ref.its_select_ref(biases[s], rands[s]), biases.shape[0])()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        _require(same, f"{path}: the wide its_select kernel differs from the plain version")
        loop_ms = self.loop_ms(launch, TIMING_REPS)
        return dict(wide_ms=self.device_ms(launch, TIMING_REPS, loop_ms), wide_loop_ms=loop_ms)

    def wide_phases(self, biases, rands):
        """The wide kernel's phases (chunk sums, prefix tables, envelope,
        rounds): each one's device time a call (``phase_ms``), from the
        card's events of ``TIMING_REPS`` whole calls in one trace, and the
        scratch's bytes."""
        from torch.profiler import ProfilerActivity, profile

        torch, its = self.torch, self.its_mod
        its._launch(biases, rands, wide=True)
        self.sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMING_REPS):
                its._launch(biases, rands, wide=True)
            self.sync()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        phase_ms = {}
        for ph, kernel in WIDE_PHASES.items():
            us = [e.self_device_time_total for e in events if kernel in e.key]
            _require(us, f"its_select_wide: the trace shows no {kernel}")
            phase_ms[ph] = sum(us) / 1e3 / TIMING_REPS
        n, p = biases.shape
        words = self.build.load().its_select_wide_scratch_words(n, p, rands.shape[2])
        return dict(phase_ms=phase_ms, scratch_bytes=4 * words)

    def measure_wide_check(self):
        """The wide kernel just past the warp kernel's shapes (P = 4,097,
        K = 33) on rows of few candidates (dense collisions), against its
        plain version."""
        torch, K = self.torch, self.kernels
        n, p, k = TRAVERSAL_INSTANCES, 4097, 33
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        biases = torch.rand((n, p), generator=gen, device=self.dev)
        biases = torch.where(torch.rand((n, p), generator=gen, device=self.dev) < 0.02, biases, 0.0)
        rands = torch.rand((n, SELECT_BUDGET, k), generator=gen, device=self.dev)
        entry = self.compare(
            "check", "its_select_wide", f"P={p} K={k}", lambda: K.its_select(biases, rands),
            self.chunked(lambda s: self.ref.its_select_ref(biases[s], rands[s]), n),
            lambda want: self.select_work(n, p, k, want[1]), rows=n, width=p, k=k)
        entry.update(self.wide_phases(biases, rands))
        return entry

    # -- the segment walk (R requests in one batch) ----------------------------

    def row_keys(self, rows, width, device=None):
        """The keys ``fold_in(PRNGKey(SEED), r)`` of ``rows`` rows of
        ``width`` walkers: ``(RowKeys on the device, (rows, 2) words)``."""
        words = np.stack([self.rng.fold_in(self.key, r) for r in range(rows)])
        base = self.torch.from_numpy(words.view(np.int32).copy()).to(device or self.dev)
        return self.rng.RowKeys(base, width), words

    def run_segments(self, name, g, spec, kernel_name, *, expect_plan, depth=DEPTH,
                     check_rows=(0, SEGMENT_ROWS // 2 - 1, SEGMENT_ROWS - 1)):
        """``random_walk_segments`` over SEGMENT_ROWS rows of ``V // R``
        walkers (``arange`` reshaped, one walker a vertex), each row under
        its own key: SEPS, ms a step, launches a step (one per method and
        one ``derive_keys`` for each), peak memory, idle share; rows
        ``check_rows`` must equal standalone card walks under their keys and
        the first CHECK_WALKERS walkers of row 0 a CPU rerun.  Then the
        step kernel with the key table at the call's first step against its
        plain version (the ``<kernel>_rows`` entry)."""
        torch, bk = self.torch, self.bk
        program = self.tp.lower(spec)
        md = g.max_degree()
        methods, tables = self.eng.flat_method_plan(g, program, md)
        buckets, use_chunked = bk.walk_bucket_plan(md)
        _require(methods == expect_plan, f"{name}: planned {methods}, expected {expect_plan}")
        rows = SEGMENT_ROWS
        width = g.num_vertices // rows
        seeds = torch.arange(rows * width, dtype=torch.int32, device=self.dev).reshape(rows, width)
        rk, words = self.row_keys(rows, width)
        walk = dict(depth=depth, spec=spec, max_degree=md, device=self.dev)
        _log(f"[{name}] rows={rows} width={width} depth={depth} plan={methods}")
        self.eng.random_walk_segments(g, seeds, words, **dict(walk, depth=1))  # warm-up
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = self.eng.random_walk_segments(g, seeds, words, **walk)
        self.sync()
        seconds = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        want = _step_kernels(methods, len(buckets))
        for k in want:
            _require(launches[k] == depth, f"{name}: {launches[k]} {k} launches in {depth} steps")
        _require(launches["derive_keys"] >= depth * len(want),
                 f"{name}: {launches['derive_keys']} key derivations in {depth} steps")
        flat = self.eng.WalkResult(res.walks.reshape(-1, depth + 1), res.lengths.reshape(-1),
                                   res.sampled_edges.sum())
        edges, off_edge = self.check_walks(g, flat, seeds.reshape(-1), depth, None)
        t0 = time.perf_counter()
        for r in check_rows:
            solo = self.eng.random_walk(g, seeds[r], words[r], **walk)
            _require(torch.equal(solo.walks, res.walks[r]),
                     f"{name}: row {r} differs from its standalone walk")
        n = min(CHECK_WALKERS, width)
        cpu = self.eng.random_walk(self.cpu_graph(g), seeds[0, :n].cpu(), words[0],
                                   **dict(walk, device="cpu"))
        _require(torch.equal(cpu.walks, res.walks[0, :n].cpu()),
                 f"{name}: row 0's first {n} walkers differ from the CPU walks")
        row = dict(
            path=name, spec=spec.name, mode=program.mode, method=program.method, rows=rows,
            width=width, walkers=rows * width, depth=depth, plan=list(methods), launches=launches,
            launches_per_step={k: v / depth for k, v in launches.items() if v},
            sampled_edges=edges, off_edge_hops=off_edge, seconds=seconds, seps=edges / seconds,
            ms_per_step=1e3 * seconds / depth, peak_gib=peak_gib,
            standalone_rows_checked=list(check_rows), cpu_check_walkers=n,
            check_s=time.perf_counter() - t0,
        )
        _log(f"[{name}] {json.dumps(row)}")
        self.paths.append(row)
        del res, flat, cpu
        entries = self.measure_flat(name, g, spec, methods, tables, buckets, kernel_name,
                                    seeds.reshape(-1), 0, key=rk)
        self.kernel_row(f"{kernel_name}_rows", name, entries, launches=launches[kernel_name])
        self.kernel_rows[f"{kernel_name}_rows"].update(rows=rows, width=width)
        if kernel_name == "reject_step":
            self.derive_row(name, rk, launches["derive_keys"])
        row.update(self.profile(name, lambda: self.eng.random_walk_segments(
            g, seeds, words, **dict(walk, depth=2))))
        return row

    def derive_row(self, path, rk, launches):
        """``derive_keys`` on the main segment walk's first rejection step
        (its 16 round keys a row), against its plain version and against
        ``threefry.fold_in`` along each path on the host."""
        torch, th = self.torch, self.threefry
        kf = self.rng.fold_in(self.rng.fold_in(rk, 0), 1)
        paths = [kf.path + (2, t) for t in range(2 * self.ref.REJECT_ITERS)]
        got = th.derive_keys(rk.base, paths)
        words = rk.base.cpu().numpy().view(np.uint32)
        got = got.cpu().numpy().view(np.uint32)
        for r in range(rk.rows):
            for p, fold in enumerate(paths):
                k = words[r]
                for d in fold:
                    k = th.fold_in(k, d)
                _require(np.array_equal(got[r, p], k),
                         f"derive_keys: row {r} path {p} differs from fold_in")
        n_keys = rk.rows * len(paths)
        work = lambda want: (8 * rk.rows + 8 * n_keys, 0,  # noqa: E731
                             HASH_INT_OPS * n_keys * len(paths[0]))
        entry = self.compare(path, "derive_keys", f"rows={rk.rows} keys={len(paths)}",
                             lambda: th.derive_keys(rk.base, paths),
                             lambda: th.derive_keys_ref(rk.base, paths), work,
                             rows=rk.rows, keys=len(paths), depth=len(paths[0]))
        self.kernel_row("derive_keys", path, [entry], launches=launches)

    def serve_shape(self, g, spec):
        """``bench_serve.py``'s shape: SEGMENT_ROWS requests of 9-16 seeds
        (vertices with an edge), padded to SERVE_WIDTH, depth SERVE_DEPTH:
        one fused call against one standalone call a request; every row
        equal."""
        torch = self.torch
        rng = np.random.default_rng(SEED)
        deg = (g.indptr[1:] - g.indptr[:-1]).cpu().numpy()
        live = np.nonzero(deg > 0)[0]
        fill = rng.integers(9, SERVE_WIDTH + 1, SEGMENT_ROWS)
        seeds_np = np.full((SEGMENT_ROWS, SERVE_WIDTH), -1, np.int32)
        for r, k in enumerate(fill):
            seeds_np[r, :k] = rng.choice(live, k)
        seeds = torch.from_numpy(seeds_np).to(self.dev)
        _, words = self.row_keys(SEGMENT_ROWS, SERVE_WIDTH)
        walk = dict(depth=SERVE_DEPTH, spec=spec, max_degree=g.max_degree(), device=self.dev)
        fused = lambda: self.eng.random_walk_segments(g, seeds, words, **walk)  # noqa: E731
        solo = lambda: [self.eng.random_walk(g, seeds[r], words[r], **walk)  # noqa: E731
                        for r in range(SEGMENT_ROWS)]
        fused(), solo()  # warm-up
        self.sync()
        t0 = time.perf_counter()
        res = fused()
        self.sync()
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = solo()
        self.sync()
        solo_s = time.perf_counter() - t0
        for r, one in enumerate(alone):
            _require(torch.equal(one.walks, res.walks[r]), f"serve shape: row {r} differs")
        row = dict(rows=SEGMENT_ROWS, width=SERVE_WIDTH, depth=SERVE_DEPTH,
                   seeds=int(fill.sum()), fused_ms=1e3 * fused_s, standalone_ms=1e3 * solo_s,
                   standalone_over_fused=solo_s / fused_s)
        _log(f"[serve_shape] {json.dumps(row)}")
        return row

    def segments_vs_cpu(self, name, g, spec, kernel_name):
        """A small segment walk (SEGMENT_CHECK_ROWS rows of
        SEGMENT_CHECK_WIDTH walkers, depth SEGMENT_CHECK_DEPTH) on the card
        and on the CPU: every row equal, and ``kernel_name`` launched under
        the row axis."""
        torch = self.torch
        rows, width, depth = SEGMENT_CHECK_ROWS, SEGMENT_CHECK_WIDTH, SEGMENT_CHECK_DEPTH
        seeds = torch.arange(rows * width, dtype=torch.int32).reshape(rows, width)
        _, words = self.row_keys(rows, width)
        walk = dict(depth=depth, spec=spec, max_degree=g.max_degree())
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = self.eng.random_walk_segments(g, seeds.to(self.dev), words, device=self.dev,
                                             **walk)
        self.sync()
        card_s = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        _require(launches[kernel_name] > 0, f"{name}: {kernel_name} never launched: {launches}")
        t0 = time.perf_counter()
        cpu = self.eng.random_walk_segments(self.cpu_graph(g), seeds, words, device="cpu", **walk)
        cpu_s = time.perf_counter() - t0
        _require(torch.equal(cpu.walks, card.walks.cpu()), f"{name}: card rows differ from CPU")
        row = dict(path=name, spec=spec.name, rows=rows, width=width, depth=depth,
                   seconds=card_s, ms_per_step=1e3 * card_s / depth, cpu_check_s=cpu_s,
                   launches=launches, sampled_edges=int(card.sampled_edges.sum()))
        _log(f"[{name}] {json.dumps(row)}")
        return row

    # -- the out-of-memory walk ----------------------------------------------

    def oom_paths(self, g):
        """``oom_random_walk`` at ``benchmarks/fig13_oom.py``'s settings on
        the R-MAT graph: 8 vertex-range partitions, ``biased_random_walk``,
        2,000 instances, depth ``OOM_DEPTH``, two partitions resident, two streams,
        chunks of 1,024; the four Fig. 13 configurations, then node2vec."""
        t0 = time.perf_counter()
        parts = self.partition.partition_by_vertex_range(g, OOM_PARTITIONS)
        part_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        seeds = rng.integers(0, g.num_vertices, OOM_INSTANCES)
        kw = dict(depth=OOM_DEPTH, spec=self.alg.biased_random_walk(),
                  max_degree=min(g.max_degree(), 512), memory_capacity=2, num_streams=2,
                  chunk=1024)
        # warm-up: one instance, one step, which reads the partitions' local
        # biases back and builds their alias tables (cached across calls)
        t0 = time.perf_counter()
        self.oom.oom_random_walk(parts, g.num_vertices, seeds[:1], self.key, device=self.dev,
                                 **dict(kw, depth=1))
        plan_s = time.perf_counter() - t0
        rows = {}
        for cname, flags in OOM_CONFIGS.items():
            rows[cname] = self.run_oom(f"oom {cname}", g, parts, seeds, dict(kw, **flags))
        rows["node2vec"] = self.run_oom("oom node2vec", g, parts, seeds[:OOM_CHECK],
                                        dict(kw, spec=self.alg.node2vec(), depth=OOM_WINDOW_DEPTH))
        base = rows["base"]["seconds"]
        for cname in OOM_CONFIGS:
            rows[cname]["speedup_vs_base"] = base / rows[cname]["seconds"]
        self.paths.append(dict(path="oom", partitions=OOM_PARTITIONS, partition_s=part_s,
                               plan_s=plan_s, configs=rows))
        return parts

    def run_oom(self, name, g, parts, seeds, kw):
        """One out-of-memory walk on the card, timed whole (transfers and
        table builds included), its drain calls counted; every hop must be
        an edge and nothing dropped; then the first OOM_CHECK instances
        again on the card, traced (idle share), and on the CPU: walks and
        every ``OOMStats`` field equal."""
        torch, oom = self.torch, self.oom
        drain, calls = oom._drain, []

        def counted(*args, **dkw):
            t0 = time.perf_counter()
            out = drain(*args, **dkw)
            calls.append((dkw["n_chunks"], time.perf_counter() - t0))
            return out

        run = lambda sd, dev: oom.oom_random_walk(  # noqa: E731
            parts, g.num_vertices, sd, self.key, device=dev, **kw)
        self.kernels.reset_launch_counts()
        oom._drain = counted
        try:
            t0 = time.perf_counter()
            walks, stats = run(seeds, self.dev)
            seconds = time.perf_counter() - t0
        finally:
            oom._drain = drain
        launches = self.kernels.launch_counts()
        _require(sum(launches.values()) > 0, f"{name}: no kernel launched")
        _require(stats.frontier_dropped == 0, f"{name}: {stats.frontier_dropped} entries dropped")
        w = torch.from_numpy(walks).to(self.dev).long()
        a, b = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
        hop = b >= 0
        _require(bool((a[hop] >= 0).all()), f"{name}: a walker came back to life")
        bad = int((~self.is_edge(g, a[hop], b[hop])).sum())
        _require(bad == 0, f"{name}: {bad} hops are not edges")
        _require(int(hop.sum()) == stats.sampled_edges, f"{name}: sampled_edges")
        chunks = sum(c for c, _ in calls)
        row = dict(
            path=name, spec=kw["spec"].name, instances=len(seeds), depth=kw["depth"],
            flags={k: kw[k] for k in ("batched", "workload_aware", "balance") if k in kw},
            seconds=seconds, seps=stats.sampled_edges / seconds,
            sampled_edges=stats.sampled_edges, kernel_launches=stats.kernel_launches,
            partition_transfers=stats.partition_transfers,
            bytes_transferred=stats.bytes_transferred,
            kernel_time_std=stats.kernel_time_std(), frontier_dropped=stats.frontier_dropped,
            drain_calls=len(calls), drain_chunks=chunks,
            drain_ms_per_chunk=1e3 * seconds / chunks,
            drain_host_ms_per_chunk=1e3 * sum(t for _, t in calls) / chunks,
            launches=launches,
        )
        del w, a, b, hop
        # the check: the first instances again, traced on the card (the run
        # above, when it had no more), and on the CPU
        check = seeds[:OOM_CHECK]
        got = [(walks, stats)]
        if len(seeds) > len(check):
            got = []
            row.update(self.profile(name, lambda: got.append(run(check, self.dev)),
                                    host_events=False))
        t0 = time.perf_counter()
        cpu_walks, cpu_stats = run(check, "cpu")
        row["cpu_check_s"] = time.perf_counter() - t0
        row["cpu_check_instances"] = len(check)
        _require(np.array_equal(got[0][0], cpu_walks), f"{name}: card walks differ from the CPU's")
        _require(dataclasses.asdict(got[0][1]) == dataclasses.asdict(cpu_stats),
                 f"{name}: card OOMStats differ from the CPU's")
        _log(f"[{name}] {json.dumps(row)}")
        return row

    # -- serving ----------------------------------------------------------------

    def live_vertices(self, g):
        """The vertices with an edge, on the host (serving draws its seeds
        there)."""
        deg = (g.indptr[1:] - g.indptr[:-1]).cpu().numpy()
        return np.nonzero(deg > 0)[0]

    def kernels_of(self, g, spec, md):
        """The kernels a walk of ``spec`` launches every step, from its plan."""
        program = self.tp.lower(spec)
        if program.mode == "window":
            return {"walk_step_window"}
        if program.mode == "opaque":
            return {"its_select"}
        methods, _ = self.eng.flat_method_plan(g, program, md)
        return _step_kernels(methods, len(self.bk.walk_bucket_plan(md)[0]))

    def serve_mixes(self, path, g, mixes):
        """``serve`` / ``serve_mixed``: each mix of ``(spec, seeds, depth)``
        requests through ``SamplingService(fuse=True)`` and ``fuse=False``,
        each after one warm drain, every request under the key
        ``fold_in(PRNGKey(7), i)``: cohorts, launches, padding, fused and
        sequential ms, the service's own cost over direct
        ``random_walk_segments`` calls on its packed cohorts, and the
        checks (fused = unfused for every request, hops are edges, the
        first request of each program = a CPU rerun)."""
        S = self.serve
        md = g.max_degree()
        rows = {}
        for mix, requests in mixes.items():
            keys = [self.rng.fold_in(self.rng.PRNGKey(SEED), i) for i in range(len(requests))]

            def submit(svc):
                return [svc.submit(seeds, depth=d, spec=spec, key=k)
                        for (spec, seeds, d), k in zip(requests, keys)]

            def serve_once(svc):
                ids = submit(svc)
                return ids, svc.drain()

            fused = S.SamplingService(g, device=self.dev, max_degree=md)
            seq = S.SamplingService(g, device=self.dev, max_degree=md,
                                    config=S.ServiceConfig(fuse=False))
            serve_once(fused), serve_once(seq)  # warm drains
            before = dataclasses.replace(fused.stats)
            self.kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ids, got = serve_once(fused)
            fused_times = [time.perf_counter() - t0]
            launches = self.kernels.launch_counts()
            cohorts = fused.stats.launches - before.launches
            padded = fused.stats.padded_walker_slots - before.padded_walker_slots
            for _ in range(SERVE_REPS - 1):
                t0 = time.perf_counter()
                serve_once(fused)
                fused_times.append(time.perf_counter() - t0)
            want_kernels = set().union(*(self.kernels_of(g, s, md) for s, _, _ in requests))
            for k in want_kernels | {"derive_keys"}:
                _require(launches[k] > 0, f"{path} {mix}: {k} never launched: {launches}")
            before_seq = seq.stats.launches
            seq_times = []
            for _ in range(SERVE_SEQ_REPS):
                t0 = time.perf_counter()
                seq_ids, seq_got = serve_once(seq)
                seq_times.append(time.perf_counter() - t0)
            seq_launches = (seq.stats.launches - before_seq) // SERVE_SEQ_REPS
            _require(len(got) == len(requests) == len(seq_got), f"{path} {mix}: results missing")
            for rid, sid in zip(ids, seq_ids):
                _require(np.array_equal(got[rid].walks, seq_got[sid].walks)
                         and got[rid].sampled_edges == seq_got[sid].sampled_edges,
                         f"{path} {mix}: request {rid} differs between fused and unfused")
            hops = bad = 0
            for rid in ids:
                w = self.torch.from_numpy(got[rid].walks).to(self.dev).long()
                a, b = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
                hop = b >= 0
                hops += int(hop.sum())
                bad += int((~self.is_edge(g, a[hop], b[hop])).sum())
            _require(bad == 0, f"{path} {mix}: {bad} hops are not edges")
            # the service's own cost: the same cohorts packed as the service
            # packs them, run as direct random_walk_segments calls
            probe = S.SamplingService(g, device=self.dev, max_degree=md)
            submit(probe)
            packed = [(c, *probe._pack(c)) for c in probe._queue.take_cohorts()]
            _require(len(packed) == cohorts, f"{path} {mix}: {len(packed)} != {cohorts} cohorts")

            def direct():
                for c, seeds, kw, _ in packed:
                    self.eng.random_walk_segments(g, seeds, kw, depth=c.depth,
                                                  spec=c.requests[0].spec, max_degree=md,
                                                  device=self.dev)
                self.sync()

            direct()
            direct_times = []
            for _ in range(SERVE_REPS):
                t0 = time.perf_counter()
                direct()
                direct_times.append(time.perf_counter() - t0)
            # the first request of each program, rerun by a CPU service
            firsts, seen = [], set()
            for i, (spec, _, _) in enumerate(requests):
                if S.cohort_key(spec) not in seen:
                    seen.add(S.cohort_key(spec))
                    firsts.append(i)
            t0 = time.perf_counter()
            cpu = S.SamplingService(self.cpu_graph(g), device="cpu", max_degree=md)
            cpu_ids = [cpu.submit(requests[i][1], depth=requests[i][2], spec=requests[i][0],
                                  key=keys[i]) for i in firsts]
            cpu_got = cpu.drain()
            for i, cid in zip(firsts, cpu_ids):
                _require(np.array_equal(cpu_got[cid].walks, got[ids[i]].walks),
                         f"{path} {mix}: request {ids[i]} differs from its CPU rerun")
            cpu_s = time.perf_counter() - t0
            fused_ms = 1e3 * float(np.median(fused_times))
            seq_ms = 1e3 * float(np.median(seq_times))
            direct_ms = 1e3 * float(np.median(direct_times))
            walker_steps = sum(len(s) * d for _, s, d in requests)
            row = dict(
                path=path, mix=mix, requests=len(requests),
                walkers=sum(len(s) for _, s, _ in requests), walker_steps=walker_steps,
                specs=sorted({s.name for s, _, _ in requests}), cohorts=cohorts,
                fused_launches=cohorts, sequential_launches=seq_launches,
                padded_walker_slots=padded, launches=launches, fused_ms=fused_ms,
                fused_ms_reps=[1e3 * t for t in fused_times], sequential_ms=seq_ms,
                sequential_ms_reps=[1e3 * t for t in seq_times],
                sequential_over_fused=seq_ms / fused_ms, requests_per_s=len(requests) / (
                    fused_ms / 1e3), walker_steps_per_s=walker_steps / (fused_ms / 1e3),
                direct_segments_ms=direct_ms, service_overhead_ms=fused_ms - direct_ms,
                hops=hops, cpu_checked_requests=[ids[i] for i in firsts], cpu_check_s=cpu_s,
                card=self.card,
            )
            row.update(self.profile(f"{path} {mix}", lambda: serve_once(fused)))
            row["profile_drains"] = row.pop("profile_steps") // 2  # a call is a drain here
            _log(f"[{path} {mix}] {json.dumps(row)}")
            rows[mix] = row
        self.paths.append(dict(path=path, vertices=g.num_vertices, csr_entries=g.num_edges,
                               mixes=rows, card=self.card))
        return rows

    def serve_path(self, g):
        """``serve``: bench_serve.py's ``uniform`` (64 requests of 16 seeds,
        depth 16, deepwalk) and ``skewed_lengths`` (depths 4-64, p = .35 /
        .3 / .2 / .1 / .05) mixes on the R-MAT graph, in memory."""
        rng = np.random.default_rng(SEED)
        live = self.live_vertices(g)
        dw = self.alg.deepwalk()
        uniform = [(dw, rng.choice(live, SERVE_WIDTH), SERVE_DEPTH)
                   for _ in range(SERVE_REQUESTS)]
        depths = rng.choice(SKEWED_DEPTHS, size=SERVE_REQUESTS, p=SKEWED_P)
        skewed = [(dw, rng.choice(live, SERVE_WIDTH), int(d)) for d in depths]
        return self.serve_mixes("serve", g, {"uniform": uniform, "skewed_lengths": skewed})

    def serve_mixed_path(self, g):
        """``serve_mixed``: bench_serve.py's ``mixed_specs`` mix on the
        power-law graph (deepwalk, node2vec, weighted, deepwalk in turn,
        node2vec from one factory call; 9-16 seeds; depth 8 or 16)."""
        rng = np.random.default_rng(SEED)
        live = self.live_vertices(g)
        specs = [self.alg.deepwalk(), self.alg.node2vec(), self.alg.weighted_random_walk(),
                 self.alg.deepwalk()]
        mixed = [(specs[i % 4], rng.choice(live, int(rng.integers(9, SERVE_WIDTH + 1))),
                  int(rng.choice([8, 16]))) for i in range(SERVE_REQUESTS)]
        return self.serve_mixes("serve_mixed", g, {"mixed_specs": mixed})

    def serve_oom_path(self, g, parts):
        """``serve_oom``: the OOM placement on ``oom_paths``' partitions.
        Prewarm ``biased_random_walk()`` at depth 16, width 16, 64 requests;
        then 64 requests of 16 seeds at depths from {4, 8, 16}: one cohort,
        one ``oom_random_walk`` call of 1,024 instances, each request equal
        to its slice of a direct call under the same launch key and depth
        limits."""
        S, rng_mod = self.serve, self.rng
        spec = self.alg.biased_random_walk()
        svc = S.SamplingService(partitions=parts, total_vertices=g.num_vertices, device=self.dev,
                                key=self.key, oom_chunk=1024)
        t0 = time.perf_counter()
        svc.prewarm(spec, depth=SERVE_DEPTH, width=SERVE_WIDTH, requests=SERVE_REQUESTS)
        prewarm_s = time.perf_counter() - t0
        _require(svc.stats.oom_launches == 0, "serve_oom: the prewarm launch was counted")
        rng = np.random.default_rng(SEED)
        live = self.live_vertices(g)
        reqs = [(rng.choice(live, SERVE_WIDTH), int(rng.choice(OOM_SERVE_DEPTHS)))
                for _ in range(SERVE_REQUESTS)]
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ids = [svc.submit(s, depth=d, spec=spec) for s, d in reqs]
        got = svc.drain()
        seconds = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        _require(svc.stats.oom_launches == 1, f"serve_oom: {svc.stats.oom_launches} OOM launches")
        _require(launches["alias_step"] > 0, f"serve_oom: alias_step never launched: {launches}")
        seeds = np.concatenate([s for s, _ in reqs]).astype(np.int32)
        limits = np.concatenate([np.full(len(s), d, np.int32) for s, d in reqs])
        _require(len(seeds) >= 128 and len(seeds) & (len(seeds) - 1) == 0,
                 f"serve_oom: {len(seeds)} instances are padded (the direct call takes them bare)")
        launch_key = rng_mod.fold_in(rng_mod.split(self.key)[1], 1)
        t0 = time.perf_counter()
        walks, stats = self.oom.oom_random_walk(
            parts, g.num_vertices, seeds, launch_key, depth=max(OOM_SERVE_DEPTHS), spec=spec,
            max_degree=svc.max_degree, depth_limits=limits, memory_capacity=2, num_streams=2,
            chunk=1024, device=self.dev)
        direct_s = time.perf_counter() - t0
        at = 0
        for rid, (s, d) in zip(ids, reqs):
            _require(np.array_equal(got[rid].walks, walks[at:at + len(s), :d + 1]),
                     f"serve_oom: request {rid} differs from its slice of the direct call")
            at += len(s)
        sampled = sum(got[rid].sampled_edges for rid in ids)
        _require(sampled == stats.sampled_edges, "serve_oom: sampled edges disagree")
        _require(stats.frontier_dropped == 0, "serve_oom: entries dropped")
        row = dict(
            path="serve_oom", spec=spec.name, partitions=len(parts), requests=len(reqs),
            instances=len(seeds), depths=list(OOM_SERVE_DEPTHS), prewarm_s=prewarm_s,
            seconds=seconds, seps=sampled / seconds, sampled_edges=sampled,
            direct_s=direct_s, service_overhead_s=seconds - direct_s,
            oom_launches=svc.stats.oom_launches, padded_walker_slots=svc.stats.padded_walker_slots,
            oom_stats={k: v for k, v in dataclasses.asdict(stats).items()
                       if k != "entries_per_kernel"} | {"kernel_time_std": stats.kernel_time_std()},
            launches=launches, card=self.card,
        )
        _log(f"[serve_oom] {json.dumps(row)}")
        self.paths.append(row)
        return row

    def stream_path(self, g):
        """``stream``: the streaming service in thread mode on the power-law
        graph under bench_serve.py's open-loop population (150 requests,
        deepwalk and weighted in turn, 9-16 seeds, depth 8, width bucket 16,
        at most 16 requests a cohort, a 10 ms window; tiers interactive (50
        ms) / standard / bulk (500 ms); keys ``fold_in(PRNGKey(23), i)``),
        Poisson arrivals at the capacity proxy (1e3 over the ms of one
        single-request launch at that geometry), batching on and off over
        the same schedule; every streamed result must equal the unfused
        service's."""
        S, pct = self.serve, self.percentile
        rng = np.random.default_rng(29)
        live = self.live_vertices(g)
        md = g.max_degree()
        specs = [self.alg.deepwalk(), self.alg.weighted_random_walk()]
        tiers = {0: (S.Priority.INTERACTIVE, 50.0), 2: (S.Priority.BULK, 500.0)}
        pop = []
        for i in range(STREAM_REQUESTS):
            tier, deadline = tiers.get(i % 4, (S.Priority.STANDARD, None))
            pop.append((specs[i % 2], rng.choice(live, int(rng.integers(9, STREAM_WIDTH + 1))),
                        tier, deadline, self.rng.fold_in(self.rng.PRNGKey(23), i)))
        cfg = S.ServiceConfig(max_pending_requests=1 << 15, max_pending_walkers=1 << 22,
                              max_requests_per_launch=STREAM_MAX_COHORT)
        # the capacity proxy: one single-request launch at the serving geometry
        seeds = np.full((1, STREAM_WIDTH), -1, np.int32)
        seeds[0, :12] = live[:12]
        keys = np.stack([self.rng.PRNGKey(0)])
        single = lambda: self.eng.random_walk_segments(  # noqa: E731
            g, seeds, keys, depth=STREAM_DEPTH, spec=specs[0], max_degree=md,
            device=self.dev).walks.cpu()
        single()
        times = []
        for _ in range(SERVE_REPS):
            t0 = time.perf_counter()
            single()
            times.append(time.perf_counter() - t0)
        single_ms = 1e3 * float(np.median(times))
        rate = 1e3 / single_ms
        arrivals = np.cumsum(np.random.default_rng(100).exponential(1.0 / rate, len(pop)))
        legs, served = {}, {}
        for batching in (True, False):
            mode = "batching" if batching else "per_request"
            svc = S.SamplingService(g, device=self.dev, max_degree=md,
                                    key=self.rng.PRNGKey(3), config=cfg)
            t0 = time.perf_counter()
            for spec in specs:
                r = 1
                while r <= STREAM_MAX_COHORT:
                    svc.prewarm(spec, depth=STREAM_DEPTH, width=STREAM_WIDTH, requests=r)
                    r *= 2
            prewarm_s = time.perf_counter() - t0
            self.kernels.reset_launch_counts()
            futs, rejected = [], 0
            stream_cfg = S.StreamConfig(max_batch_window_ms=STREAM_WINDOW_MS, batching=batching)
            with S.StreamingSamplingService(svc, stream_cfg) as stream:
                t0 = time.perf_counter()
                for (spec, sd, tier, deadline, key), at in zip(pop, arrivals):
                    delay = t0 + at - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    try:
                        futs.append(stream.submit(sd, depth=STREAM_DEPTH, spec=spec, key=key,
                                                  deadline_ms=deadline, priority=tier))
                    except S.AdmissionError:
                        rejected += 1
                failed = [f.request_id for f in futs if f.exception(timeout=600) is not None]
                t1 = time.perf_counter()
            launches = self.kernels.launch_counts()
            _require(rejected == 0, f"stream {mode}: {rejected} admission rejections")
            _require(not failed and svc.stats.stream_failed_requests == 0,
                     f"stream {mode}: futures failed: {failed}")
            want = set().union(*(self.kernels_of(g, s, md) for s in specs))
            for k in want:
                _require(launches[k] > 0, f"stream {mode}: {k} never launched: {launches}")
            lats = [f.latency for f in futs]
            per_tier = {}
            for tier, tname in ((0, "interactive"), (1, "standard"), (2, "bulk")):
                tl = [lat.total_ms for lat in lats if lat.tier == tier]
                per_tier[tname] = dict(
                    n=len(tl), p50_ms=pct(tl, 50),
                    p99_ms=pct(tl, 99),
                    deadline_misses=sum(lat.deadline_met is False for lat in lats
                                        if lat.tier == tier))
            reasons = {}
            for lat in lats:
                reasons[lat.reason] = reasons.get(lat.reason, 0) + 1
            legs[mode] = dict(
                mode=mode, requests=len(futs), rejected=rejected, failed=len(failed),
                offered_rps=rate, sustained_rps=len(futs) / (t1 - t0),
                stream_launches=svc.stats.stream_launches, cohort_launches=svc.stats.launches,
                requests_by_reason=reasons, deadline_misses=svc.stats.stream_deadline_misses,
                p50_ms=pct([lat.total_ms for lat in lats], 50),
                p99_ms=pct([lat.total_ms for lat in lats], 99),
                mean_launch_ms=float(np.mean([lat.launch_ms for lat in lats])),
                tiers=per_tier, prewarm_s=prewarm_s, launches=launches,
            )
            _log(f"[stream {mode}] {json.dumps(legs[mode])}")
            served[mode] = [f.result() for f in futs]
        base = S.SamplingService(g, device=self.dev, max_degree=md,
                                 config=dataclasses.replace(cfg, fuse=False))
        ids = [base.submit(sd, depth=STREAM_DEPTH, spec=spec, key=key)
               for spec, sd, _, _, key in pop]
        want = base.drain()
        for mode, results in served.items():
            for res, rid in zip(results, ids):
                _require(np.array_equal(res.walks, want[rid].walks),
                         f"stream {mode}: request {res.request_id} differs from the unfused"
                         " service")
        row = dict(path="stream", requests=len(pop), depth=STREAM_DEPTH, width=STREAM_WIDTH,
                   max_cohort=STREAM_MAX_COHORT, window_ms=STREAM_WINDOW_MS,
                   single_launch_ms=single_ms, capacity_proxy_rps=rate, legs=legs,
                   card=self.card)
        self.paths.append(row)
        return row

    # -- the device hash ------------------------------------------------------

    # -- the sharded engine (4 shards on one card) ----------------------------

    @contextlib.contextmanager
    def step_spy(self, record=False):
        """Count the sharded drain's step dispatches (``walk_step_adaptive``
        and ``walk_step_bucketed_window`` calls: one a shard and
        sub-round); with ``record`` also each flat batch's distinct depths
        (a sync a call) and the operands of the first batch and of the first
        batch that mixes depths.  Yields a dict."""
        torch, bk = self.torch, self.bk
        real, real_window = bk.walk_step_adaptive, bk.walk_step_bucketed_window
        seen = dict(calls=0, mixed=0, first=None, mixed_batch=None)

        def spy(key, indptr, indices, bias, cur, **kw):
            seen["calls"] += 1
            if record:
                depths = int(torch.unique(key.depth[key.inst >= 0]).numel())
                seen["mixed"] += depths > 1
                slot = "first" if seen["first"] is None else (
                    "mixed_batch" if depths > 1 and seen["mixed_batch"] is None else None)
                if slot:
                    seen[slot] = dict(
                        key=key.with_entries(key.depth.clone(), key.inst.clone()),
                        indptr=indptr, indices=indices, bias=bias, cur=cur.clone(),
                        depths=depths, **kw)
            return real(key, indptr, indices, bias, cur, **kw)

        def window_spy(*args, **kw):
            seen["calls"] += 1
            return real_window(*args, **kw)

        bk.walk_step_adaptive, bk.walk_step_bucketed_window = spy, window_spy
        try:
            yield seen
        finally:
            bk.walk_step_adaptive, bk.walk_step_bucketed_window = real, real_window

    def sharded(self, name, g, spec, seeds, depth, kernel_name, *, check="card", **opts):
        """One timed ``sharded_random_walk`` over SHARDS shards of the card
        after a warm-up (the layout's build and the kernels' first
        launches; it records the first and a mixed-depth batch), held
        against the card's ``random_walk`` under the same key: seconds,
        SEPS, ms a round, rounds, blocks, the drain's stats, launches, peak
        memory.  Returns ``(row, recorded batches)``."""
        torch, S = self.torch, self.shard
        mesh = S.ShardMesh.on(self.dev, SHARDS)
        md = g.max_degree()
        walk = dict(depth=depth, spec=spec, max_degree=md, **opts)
        t0 = time.perf_counter()
        with self.step_spy(record=True) as rec:
            S.sharded_random_walk(mesh, g, seeds, self.key, **dict(walk, depth=min(depth, 4)))
        self.sync()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        self.kernels.reset_launch_counts()
        with self.step_spy() as count:
            t0 = time.perf_counter()
            res = S.sharded_random_walk(mesh, g, seeds, self.key, **walk)
            self.sync()
            seconds = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for k in ({kernel_name} - {None}) | self.kernels_of(g, spec, md):
            _require(launches[k] > 0, f"{name}: {k} never launched: {launches}")
        t0 = time.perf_counter()
        want = self.eng.random_walk(g, seeds, self.key, depth=depth, spec=spec, max_degree=md,
                                    device=self.dev)
        _require(torch.equal(res.walks, want.walks),
                 f"{name}: the sharded walks differ from the card's random_walk")
        edges = int(res.sampled_edges)
        _require(edges == int(want.sampled_edges), f"{name}: sampled edges differ")
        rounds = count["calls"] / (SHARDS * res.stats["sub_rounds"])
        row = dict(
            path=name, spec=spec.name, shards=SHARDS, walkers=int(seeds.shape[0]), depth=depth,
            options={k: v for k, v in opts.items()}, launches=launches, sampled_edges=edges,
            seconds=seconds, seps=edges / seconds, rounds=rounds,
            ms_per_round=1e3 * seconds / max(rounds, 1), peak_gib=peak_gib, warm_up_s=warm_s,
            reference_check_s=time.perf_counter() - t0, card=self.card,
            mixed_depth_batches_in_warm_up=rec["mixed"], **res.stats,
        )
        del res, want
        return row, rec

    def entry_row(self, kernel_name, path, batches, launches):
        """Rows 1e-3e: a step kernel under per-entry keys (``EntryKeys``) on
        batches the drain recorded, against its plain version on the same
        operands: 0 mismatches, ms behind a spin, the bound."""
        torch, ref, K = self.torch, self.ref, self.kernels
        entries = []
        for label, b in batches:
            key, cur, tables = b["key"], b["cur"], b["tables"]
            indptr, indices, bias = b["indptr"], b["indices"], b["bias"]
            plan = dict(buckets=b["buckets"], use_chunked=b["use_chunked"], methods=b["methods"])
            out = torch.full_like(cur, -1)
            if kernel_name == "reject_step":
                launch = lambda: K.reject_step(key, indptr, indices, bias, tables.row_max, cur,  # noqa: E731
                                               out=out, **plan)
                plain = lambda: ref.reject_step_ref(key, indptr, indices, bias,  # noqa: E731
                                                    tables.row_max, cur, **plan)
            elif kernel_name == "alias_step":
                launch = lambda: K.alias_step(key, indptr, indices, tables.prob, tables.alias,  # noqa: E731
                                              cur, out=out, **plan)
                plain = lambda: ref.alias_step_ref(key, indptr, indices, tables.prob,  # noqa: E731
                                                   tables.alias, cur, **plan)
            else:
                launch = lambda: K.walk_step(key, indptr, indices, bias, cur, out=out, **plan)  # noqa: E731
                plain = lambda: ref.walk_step_ref(key, indptr, indices, bias, cur, **plan)  # noqa: E731
            local = self.csr.CSRGraph(indptr=indptr, indices=indices, weights=bias)
            work = lambda want: self.work(kernel_name, local, cur, want, bias, tables, key, plan)  # noqa: E731
            entries.append(self.compare(
                path, f"{kernel_name}_entries", label, launch, plain, work, walkers=cur.shape[0],
                live=int((cur >= 0).sum()), depths=b["depths"]))
        name = f"{kernel_name}_entries"
        self.kernel_row(name, path, entries, launches=launches)

    def shard_path(self, g):
        """``shard``: deepwalk over 4 shards of the R-MAT graph on the card,
        a walker a vertex, depth 40, the default hub budget; then the CPU
        cross-check (the first CHECK_WALKERS seeds at depth
        SHARD_CHECK_DEPTH over 4 CPU shards: walks and stats equal) and
        ``shard_mixed`` (SHARD_MIXED_WALKERS walkers, depth
        SHARD_MIXED_DEPTH, two sub-rounds, SHARD_MIXED_SLOTS slots: batches
        of several depths), row 1e from both, and ``serve_shard``."""
        torch, S = self.torch, self.shard
        dw = self.alg.deepwalk()
        seeds = torch.arange(g.num_vertices, dtype=torch.int32, device=self.dev)
        row, rec = self.sharded("shard", g, dw, seeds, DEPTH, "reject_step")
        _require(row["exchanged_entries"] > 0 and row["hub_hops"] > 0,
                 f"shard: no exchange or hub traffic: {row}")
        mesh = S.ShardMesh.on(self.dev, SHARDS)
        md = g.max_degree()
        row.update(self.profile("shard", lambda: S.sharded_random_walk(
            mesh, g, seeds, self.key, depth=2, spec=dw, max_degree=md)))
        first = rec["first"]
        launches = row["launches"]["reject_step"]

        _log(f"[shard] {json.dumps(row)}")
        self.paths.append(row)

        step = g.num_vertices // SHARD_MIXED_WALKERS
        mseeds = seeds[::step][:SHARD_MIXED_WALKERS].contiguous()
        mrow, mrec = self.sharded("shard_mixed", g, dw, mseeds, SHARD_MIXED_DEPTH, "reject_step",
                                  sub_rounds=2, exchange_slots=SHARD_MIXED_SLOTS)
        _require(mrow["blocks"] > 1 or mrow["mixed_depth_batches_in_warm_up"] > 0,
                 f"shard_mixed: nothing deferred: {mrow}")
        with self.step_spy(record=True) as mixed:
            S.sharded_random_walk(mesh, g, mseeds, self.key, depth=SHARD_MIXED_DEPTH, spec=dw,
                                  max_degree=md, sub_rounds=2,
                                  exchange_slots=SHARD_MIXED_SLOTS)
        mrow["batches"] = mixed["calls"]
        mrow["mixed_depth_batches"] = mixed["mixed"]
        _require(mixed["mixed_batch"] is not None, "shard_mixed: no batch mixed depths")
        _log(f"[shard_mixed] {json.dumps(mrow)}")
        self.paths.append(mrow)
        self.entry_row("reject_step", "shard", [("shard round 1", first),
                                                 ("shard_mixed mixed depths",
                                                  mixed["mixed_batch"])], launches)
        del rec, mrec, mixed, first
        self.serve_shard_path(g)

        # the CPU cross-check last: its layout is the cache's second entry
        n = CHECK_WALKERS
        t0 = time.perf_counter()
        kw = dict(depth=SHARD_CHECK_DEPTH, spec=dw, max_degree=md)
        card = S.sharded_random_walk(mesh, g, seeds[:n], self.key, **kw)
        cpu = S.sharded_random_walk(S.ShardMesh.on("cpu", SHARDS), self.cpu_graph(g),
                                    seeds[:n].cpu(), self.key, **kw)
        _require(torch.equal(card.walks.cpu(), cpu.walks) and card.stats == cpu.stats,
                 f"shard: card and CPU differ on the first {n} walkers: {card.stats} {cpu.stats}")
        row.update(cpu_check_walkers=n, cpu_check_depth=SHARD_CHECK_DEPTH,
                   cpu_check_s=time.perf_counter() - t0, cpu_check_stats=cpu.stats)
        _log(f"[shard cpu check] {json.dumps(row['cpu_check_stats'])} {row['cpu_check_s']:.1f} s")
        del card, cpu
        self.shard_walk.clear_layout_cache()

    def serve_shard_path(self, g):
        """``serve_shard``: bench_serve.py's ``uniform`` mix through the
        sharded placement over 4 shards of the card, after a prewarm: every
        launch equals the card's single-device ``random_walk`` of its packed
        seeds under its launch key (each request is a slice of one), and
        every request its own shape."""
        torch, S = self.torch, self.serve
        rng = np.random.default_rng(SEED)
        live = self.live_vertices(g)
        dw = self.alg.deepwalk()
        reqs = [(rng.choice(live, SERVE_WIDTH), SERVE_DEPTH) for _ in range(SERVE_REQUESTS)]
        svc_mod = importlib.import_module("repro_torch.serve.service")
        real = svc_mod.sharded_random_walk
        calls = []

        def spy(mesh, graph, seeds, key, **kw):
            res = real(mesh, graph, seeds, key, **kw)
            calls.append((seeds, key, kw, res.walks))
            return res

        mesh = self.shard.ShardMesh.on(self.dev, SHARDS)
        svc = S.SamplingService(g, mesh=mesh, placement="sharded", key=self.key)
        t0 = time.perf_counter()
        svc.prewarm(dw, depth=SERVE_DEPTH, width=SERVE_WIDTH, requests=SERVE_REQUESTS)
        prewarm_s = time.perf_counter() - t0
        svc_mod.sharded_random_walk = spy
        try:
            self.kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ids = [svc.submit(s, depth=d, spec=dw) for s, d in reqs]
            got = svc.drain()
            seconds = time.perf_counter() - t0
            launches = self.kernels.launch_counts()
        finally:
            svc_mod.sharded_random_walk = real
        md = g.max_degree()
        for seeds, key, kw, walks in calls:
            want = self.eng.random_walk(g, seeds, key, depth=kw["depth"], spec=dw, max_degree=md,
                                        device=self.dev).walks
            lim = torch.as_tensor(kw["depth_limits"], device=self.dev)
            want = torch.where(torch.arange(kw["depth"] + 1, device=self.dev)[None, :]
                               <= lim[:, None], want, -1)
            _require(torch.equal(walks, want), "serve_shard: a launch differs from random_walk")
        for rid, (s, d) in zip(ids, reqs):
            _require(got[rid].walks.shape == (len(s), d + 1), f"serve_shard: request {rid}")
        _require(svc.stats.sharded_launches == len(calls) >= 1, "serve_shard: launches")
        walkers = sum(len(s) for s, _ in reqs)
        edges = sum(r.sampled_edges for r in got.values())
        row = dict(path="serve_shard", mix="uniform", shards=SHARDS, requests=len(reqs),
                   walkers=walkers, depth=SERVE_DEPTH, sharded_launches=svc.stats.sharded_launches,
                   padded_walker_slots=svc.stats.padded_walker_slots, prewarm_s=prewarm_s,
                   seconds=seconds, seps=edges / seconds, launches=launches, card=self.card)
        _log(f"[serve_shard] {json.dumps(row)}")
        self.paths.append(row)

    def shard_pl_path(self, g):
        """``shard_pl``: the power-law graph over 4 shards of the card:
        ``weighted_random_walk`` (alias in every cohort) and the same pinned
        to ITS at SHARD_PL_WALKERS walkers, depth SHARD_PL_DEPTH (two
        sub-rounds, SHARD_PL_SLOTS slots, so batches mix depths), node2vec
        and MH at SHARD_SMALL_WALKERS, each equal to the card's
        ``random_walk``; ``replicated_psum_walk`` (an opaque spec) and
        ``instance_parallel_walk`` equal to the CPU port on the same
        inputs; rows 2e and 3e from the alias and ITS runs' batches."""
        torch, S, alg = self.torch, self.shard, self.alg
        md = g.max_degree()
        seeds = torch.arange(SHARD_PL_WALKERS, dtype=torch.int32, device=self.dev)
        its = dataclasses.replace(alg.weighted_random_walk(), selection_method="its")
        opts = dict(sub_rounds=2, exchange_slots=SHARD_PL_SLOTS)
        for label, spec, kernel_name in [("alias", alg.weighted_random_walk(), "alias_step"),
                                         ("its", its, "walk_step")]:
            row, rec = self.sharded(f"shard_pl {label}", g, spec, seeds, SHARD_PL_DEPTH,
                                    kernel_name, **opts)
            _log(f"[shard_pl {label}] {json.dumps(row)}")
            self.paths.append(row)
            _require(rec["mixed_batch"] is not None, f"shard_pl {label}: no batch mixed depths")
            self.entry_row(kernel_name, f"shard_pl {label}",
                           [("round 1", rec["first"]), ("mixed depths", rec["mixed_batch"])],
                           row["launches"][kernel_name])
            del rec
        small = seeds[:SHARD_SMALL_WALKERS]
        for label, spec, kernel_name in [("node2vec", alg.node2vec(), "walk_step_window"),
                                         ("mhrw", alg.metropolis_hastings_walk(), None)]:
            row, _ = self.sharded(f"shard_pl {label}", g, spec, small, SHARD_SMALL_DEPTH,
                                  kernel_name)
            _log(f"[shard_pl {label}] {json.dumps(row)}")
            self.paths.append(row)
        self.shard_walk.clear_layout_cache()

        gc = self.cpu_graph(g)
        mesh, cpu_mesh = S.ShardMesh.on(self.dev, SHARDS), S.ShardMesh.on("cpu", SHARDS)
        opaque = dataclasses.replace(alg.weighted_random_walk(), transition=None,
                                     flat_edge_bias=None)
        oseeds = seeds[:SHARD_OPAQUE_WALKERS]
        kw = dict(depth=SHARD_OPAQUE_DEPTH, spec=opaque, max_degree=md)
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = S.replicated_psum_walk(mesh, g, oseeds, self.key, **kw)
        self.sync()
        rep_s = time.perf_counter() - t0
        rep_launches = self.kernels.launch_counts()
        cpu = S.replicated_psum_walk(cpu_mesh, gc, oseeds.cpu(), self.key, **kw)
        _require(torch.equal(card.cpu(), cpu), "shard_pl replicated: card and CPU differ")
        _require(rep_launches["its_select"] > 0, "shard_pl replicated: its_select never launched")
        dist = importlib.import_module("repro_torch.core.distributed")
        iseeds = seeds[:CHECK_WALKERS]
        kw = dict(depth=SHARD_PL_DEPTH, spec=alg.weighted_random_walk(), max_degree=md)
        t0 = time.perf_counter()
        ip = dist.instance_parallel_walk(mesh, g, iseeds, self.key, **kw)
        self.sync()
        ip_s = time.perf_counter() - t0
        ipc = dist.instance_parallel_walk(cpu_mesh, gc, iseeds.cpu(), self.key, **kw)
        _require(torch.equal(ip.walks.cpu(), ipc.walks)
                 and int(ip.sampled_edges) == int(ipc.sampled_edges),
                 "shard_pl instance_parallel: card and CPU differ")
        row = dict(path="shard_pl fallbacks", card=self.card,
                   replicated=dict(walkers=SHARD_OPAQUE_WALKERS, depth=SHARD_OPAQUE_DEPTH,
                                   seconds=rep_s, launches=rep_launches),
                   instance_parallel=dict(walkers=CHECK_WALKERS, depth=SHARD_PL_DEPTH,
                                          seconds=ip_s, sampled_edges=int(ip.sampled_edges)))
        _log(f"[shard_pl fallbacks] {json.dumps(row)}")
        self.paths.append(row)

    def hash_check(self, w):
        """The kernels' threefry alone (``threefry.hash_uniform``) against
        ``rng.uniform``'s tensor hash, bit for bit, for W counters under the
        16 rejection round keys of the main path's first step."""
        torch, rng = self.torch, self.rng
        kb = rng.fold_in(rng.fold_in(rng.fold_in(self.key, 0), 1), 2)
        keys = np.stack([rng.fold_in(kb, t) for t in range(2 * self.ref.REJECT_ITERS)])
        counters = torch.arange(w, dtype=torch.int64, device=self.dev)
        launch = lambda: self.threefry.hash_uniform(keys, counters)  # noqa: E731
        plain = lambda: rng.uniform_many(keys, w, device=self.dev)  # noqa: E731
        got, want = launch(), plain()
        self.sync()
        mismatches = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        _require(mismatches == 0, f"device hash: {mismatches} of {got.numel()} uniforms differ")
        n = got.numel()
        loop_ms = self.loop_ms(launch, 5)
        self.hash_row = dict(
            keys=keys.shape[0], counters=w, uniforms=n, mismatches=mismatches,
            ms=self.device_ms(launch, 5, loop_ms), loop_ms=loop_ms, plain_ms=self.loop_ms(plain, 2),
            bound_ms=max(4 * n / HBM_BYTES_PER_S, HASH_INT_OPS * n / self.int32_ops_per_s) * 1e3,
        )
        _log(f"[hash] {json.dumps(self.hash_row)}")
        del got, want

    # -- profile ------------------------------------------------------------

    def profile(self, name, call, host_events=True, steps_per_call=2) -> dict:
        """Trace ``call`` (a path's run at depth 2), again until the trace
        spans ``PROFILE_MIN_S`` (a fast path's two steps alone take a
        fraction of a millisecond); device time from the card's own events.
        ``host_events=False`` traces the card alone: a long host-bound call
        (the OOM drain's thousands of chunks) then costs seconds, not
        minutes, to summarize.  The device events are summed raw
        (``key_averages`` takes minutes over a step of 150k launches); a
        trace of at most ``PROFILE_CROSSCHECK_EVENTS`` of them is summed
        through ``key_averages`` as well."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.sync()
        walks = 0
        activities = [ProfilerActivity.CPU] if host_events else []
        with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while not walks or time.perf_counter() - t0 < PROFILE_MIN_S:
                call()
                self.sync()
                walks += 1
            wall = time.perf_counter() - t0
        # device-side events only: the aten ops on the host carry their
        # kernels' time too, and would count it twice.  Summed from the raw
        # events: ``key_averages`` parses each event into Python first, which
        # takes minutes for a step of 150k launches and more (the xLSTM's)
        agg: dict = {}
        for e in prof.profiler.kineto_results.events():
            us = e.duration_ns() / 1e3
            if (e.device_type() == torch.autograd.DeviceType.CUDA and us > 0
                    and not e.name().startswith("Activity Buffer")):
                total, count = agg.get(e.name(), (0.0, 0))
                agg[e.name()] = (total + us, count + 1)
        rows = sorted(((k, us, c) for k, (us, c) in agg.items()), key=lambda x: -x[1])
        busy_ms = sum(r[1] for r in rows) / 1e3
        if busy_ms <= 0:
            kinds = sorted({str(e.device_type) for e in prof.key_averages()})
            _log(f"[{name}] trace of {walks} walks: {len(prof.key_averages())} keys, {kinds}")
        _require(busy_ms > 0, f"{name}: the trace shows no device time")
        out = dict(
            profile_steps=steps_per_call * walks, profile_wall_ms=wall * 1e3, profile_device_busy_ms=busy_ms,
            device_idle_share=1 - busy_ms / (wall * 1e3),
            profile_top=[[k[:60], us / 1e3, c] for k, us, c in rows[:8]],
        )
        if sum(r[2] for r in rows) <= PROFILE_CROSSCHECK_EVENTS:
            out["profile_device_busy_ms_key_averages"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")) / 1e3
        return out

    # -- the LM harness ------------------------------------------------------

    def lm_paths(self):
        """Phase 13: ``lm_walk``, ``lm_gemma3_1b``, then the expert and
        recurrent cells ``lm_xlstm_350m``, ``lm_recurrentgemma_9b`` and
        ``lm_arctic_480b``."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
        from repro_torch.configs import get_config

        self.lm_walk_path()
        self.lm_gemma_path(get_config("gemma3_1b"))
        self.lm_xlstm_path(get_config("xlstm_350m"))
        self.lm_rgemma_path(get_config("recurrentgemma_9b"))
        self.lm_arctic_path(get_config("arctic_480b"))

    def lm_train(self, model, step_fn, ostate, step, batches, times=None, norms=None):
        """Run ``step_fn`` over ``batches``; each step's loss (a float: the
        step waits for the card), its seconds into ``times``, its gradient's
        global norm into ``norms``."""
        losses = []
        for b in batches:
            t0 = time.perf_counter()
            ostate, step, m = step_fn(model, ostate, step, b)
            losses.append(float(m["loss"]))
            if times is not None:
                times.append(time.perf_counter() - t0)
            if norms is not None:
                norms.append(float(m["grad_norm"]))
        return ostate, step, losses

    def lm_walk_path(self):
        """``lm_walk``: the example at ``--scale 100m`` on its walk corpus."""
        from repro_torch.data import TokenPipeline
        from repro_torch.models import model as lm
        from repro_torch.train import checkpoint, optimizer, train_step

        torch, kernels = self.torch, self.kernels
        ex = _load_example("walk_corpus_lm_torch")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = ex.corpus_graph(self.dev)
        graph_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        corpus = ex.walk_corpus(g, LM_WALK_SEQ, self.dev)
        corpus_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        step_launches = {k: launches[k] for k in ("reject_step", "alias_step", "walk_step")}
        _require(sum(step_launches.values()) > 0,
                 f"lm_walk: the corpus launched no step kernel: {launches}")
        cpu_corpus = ex.walk_corpus(g.to("cpu"), LM_WALK_SEQ, "cpu")
        _require(np.array_equal(corpus, cpu_corpus), "lm_walk: card and CPU corpora differ")
        ops_check = self.ops_check(g)

        cfg = ex.walk_lm_config(LM_WALK_SCALE)
        step_fn = train_step.make_train_step(cfg, ex.OPT, device=self.dev)
        model = lm.DecoderLM(cfg, seed=0, device=self.dev)
        ostate = optimizer.opt_init(ex.OPT, dict(model.named_parameters()))
        pipe = TokenPipeline(cfg.vocab_size, LM_WALK_BATCH, LM_WALK_SEQ, corpus=corpus)
        times: list = []
        with tempfile.TemporaryDirectory() as ckdir:
            mgr = checkpoint.CheckpointManager(ckdir, keep=1, fingerprint=cfg.name)
            ostate, step, losses = self.lm_train(
                model, step_fn, ostate, 0, (pipe.next() for _ in range(LM_WALK_CKPT)), times)
            mgr.save(step, (model.state_dict(), ostate), extra={"pipeline": pipe.state_dict()})
            ostate, step, more = self.lm_train(
                model, step_fn, ostate, step,
                (pipe.next() for _ in range(LM_WALK_STEPS - LM_WALK_CKPT)), times)
            losses += more
            fresh = lm.DecoderLM(cfg, seed=1, device=self.dev)
            template = (fresh.state_dict(),
                        optimizer.opt_init(ex.OPT, dict(fresh.named_parameters())))
            (sd, fresh_state), manifest = mgr.restore(template)
        fresh.load_state_dict(sd)
        fresh_pipe = TokenPipeline(cfg.vocab_size, LM_WALK_BATCH, LM_WALK_SEQ, corpus=corpus)
        fresh_pipe.load_state_dict(manifest["extra"]["pipeline"])
        _, _, replay = self.lm_train(fresh, step_fn, fresh_state, manifest["step"],
                                     (fresh_pipe.next() for _ in range(LM_WALK_REPLAY)))
        prof = self.profile("lm_walk", lambda: step_fn(fresh, fresh_state, LM_WALK_STEPS,
                                                       fresh_pipe.next()), steps_per_call=1)
        want = np.array(losses[LM_WALK_CKPT:LM_WALK_CKPT + LM_WALK_REPLAY])
        replay_err = float(np.max(np.abs(np.array(replay) - want) / np.abs(want)))
        _require(np.isfinite(losses).all(), f"lm_walk: a loss is not finite: {losses}")
        _require(losses[-1] < losses[0], f"lm_walk: the loss did not fall: {losses}")
        _require(manifest["step"] == LM_WALK_CKPT and replay_err <= 1e-5,
                 f"lm_walk: replay after restore differs by {replay_err:.3g}: {replay} vs {want}")
        ms = float(np.median(times[LM_WARMUP_STEPS:])) * 1e3
        row = dict(path="lm_walk", scale=LM_WALK_SCALE, params=cfg.param_count(),
                   layers=cfg.num_layers, d_model=cfg.d_model, batch=LM_WALK_BATCH,
                   seq=LM_WALK_SEQ, steps=LM_WALK_STEPS, graph_s=graph_s, corpus_s=corpus_s,
                   corpus_shape=list(corpus.shape), corpus_launches=step_launches,
                   ms_per_step=ms, tokens_per_s=LM_WALK_BATCH * LM_WALK_SEQ / (ms * 1e-3),
                   first_loss=losses[0], last_loss=losses[-1], replay_max_rel_err=replay_err,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, ops=ops_check,
                   card=self.card, **prof)
        _log(f"[lm_walk] {json.dumps(row)}")
        self.paths.append(row)
        del model, fresh, ostate, fresh_state, sd, template, g
        torch.cuda.empty_cache()

    def ops_check(self, g):
        """``kernels.ops``' helpers on the card against their plain versions
        on the CPU, under one key, at one small shape each."""
        torch = self.torch
        ops = importlib.import_module("repro_torch.kernels.ops")
        key = self.rng.PRNGKey(SEED)
        rs = np.random.default_rng(SEED)
        b = rs.random((64, 300)).astype(np.float32) * (rs.random((64, 300)) > 0.3)
        card = ops.its_select(key, torch.from_numpy(b).to(self.dev), 8, iters=8)
        cpu = ops.its_select(key, torch.from_numpy(b), 8, iters=8)
        _require(torch.equal(card.cpu(), cpu), "ops.its_select: card and CPU differ")
        md = g.max_degree()
        seg = -(-md // 128) * 128
        _require(seg <= 512, f"ops.walk_step: max degree {md} above 512")
        cur = torch.from_numpy(rs.integers(-1, g.num_vertices, 4096).astype(np.int32))
        card = ops.walk_step(key, g, cur.to(self.dev), max_seg=seg)
        cpu = ops.walk_step(key, g.to("cpu"), cur, max_seg=seg)
        _require(torch.equal(card.cpu(), cpu), "ops.walk_step: card and CPU differ")
        return dict(its_select=[64, 300, 8], walk_step=[4096, seg], equal=True)

    def lm_gemma_path(self, cfg):
        """``lm_gemma3_1b``: the full config's train, prefill and decode
        steps in bf16, then its f32 cross-checks."""
        from repro_torch.train import optimizer

        ocfg = optimizer.OptConfig(kind="adamw", lr=1e-3, warmup_steps=2)
        self.lm_decoder_path("lm_gemma3_1b", cfg, cfg, ocfg, [_learnable_batch()] * LM_TRAIN_STEPS)

    def lm_xlstm_path(self, cfg):
        """``lm_xlstm_350m``: the full config on the launcher's ``--data
        walks`` corpus, drawn on the card by the walk kernels."""
        from repro_torch.data import TokenPipeline, build_walk_corpus
        from repro_torch.train import optimizer

        kernels = self.kernels
        t0 = time.perf_counter()
        g = self.gen.powerlaw_graph(min(cfg.vocab_size, XLSTM_GRAPH_VERTICES), seed=0,
                                    weighted=True, device=self.dev)
        graph_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        corpus = build_walk_corpus(g, num_walks=XLSTM_WALKS, walk_length=LM_SEQ,
                                   vocab_size=cfg.vocab_size,
                                   max_degree=min(g.max_degree(), 512), device=self.dev)
        corpus_s = time.perf_counter() - t0
        _log(f"[lm_xlstm_350m] corpus {corpus.shape} in {corpus_s:.2f} s")
        launches = kernels.launch_counts()
        step_launches = {k: launches[k] for k in ("reject_step", "alias_step", "walk_step")}
        _require(launches["reject_step"] > 0,
                 f"lm_xlstm_350m: the corpus launched no reject_step: {launches}")
        _require(corpus.shape == (XLSTM_WALKS, LM_SEQ + 1) and corpus.min() >= 0
                 and corpus.max() < g.num_vertices,
                 f"lm_xlstm_350m: corpus of shape {corpus.shape}, ids {corpus.min()}..{corpus.max()}")
        del g
        # one batch of walks, repeated (a memorizable corpus, as
        # test_feeds_lm_training's), and no global-norm clip: at these widths
        # the sLSTM's gradient grows with the sequence, in ``repro`` as in the
        # port (test_torch_recurrent.py's test_gradient_at_1024_tokens_...:
        # the cell's norm 1.3e5 at 1,024 tokens on both sides, 1.1e4 at 128),
        # and the row's ``grad_norms`` read the model's; a clip to 1 scales
        # most entries below Adam's eps, and six steps do not move the loss
        batch = TokenPipeline(cfg.vocab_size, LM_BATCH, LM_SEQ, corpus=corpus).next()
        ocfg = optimizer.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=2,
                                   grad_clip=float("inf"))
        # the sLSTM loop launches over 150k kernels a step: its trace keeps
        # the card's events alone, as the OOM drain's does (recording each
        # host op as well adds to a step of that many launches)
        self.lm_decoder_path("lm_xlstm_350m", cfg, cfg, ocfg, [batch] * LM_TRAIN_STEPS,
                             trace_host=False,
                             extra=dict(graph_s=graph_s, corpus_s=corpus_s,
                                        corpus_shape=list(corpus.shape),
                                        corpus_launches=step_launches))

    def lm_rgemma_path(self, cfg):
        """``lm_recurrentgemma_9b``: serving at full depth; training at
        ``RGEMMA_TRAIN_LAYERS`` (one pattern repetition and the two tail
        RG-LRU layers), every width kept."""
        from repro_torch.train import optimizer

        train_cfg = dataclasses.replace(cfg, num_layers=RGEMMA_TRAIN_LAYERS)
        ocfg = optimizer.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=2)
        self.lm_decoder_path("lm_recurrentgemma_9b", cfg, train_cfg, ocfg,
                             [_learnable_batch()] * LM_TRAIN_STEPS,
                             cut=[f"train depth {RGEMMA_TRAIN_LAYERS} of {cfg.num_layers}"])

    def lm_arctic_path(self, cfg):
        """``lm_arctic_480b``: serving one layer with all its experts;
        training one layer of ``ARCTIC_TRAIN_EXPERTS`` experts (Adafactor, 4
        microbatches).  Prints the share of (token, choice) pairs that
        capacity dropped in prefill."""
        from repro_torch.train import optimizer

        serve_cfg = dataclasses.replace(cfg, num_layers=ARCTIC_LAYERS)
        train_cfg = dataclasses.replace(serve_cfg, num_experts=ARCTIC_TRAIN_EXPERTS)
        ocfg = optimizer.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=2)
        # serving takes tokens drawn from the vocabulary: the learnable
        # pattern's 7 distinct tokens route to a few experts, and capacity
        # then drops most choices (87.7 % of them at one layer)
        tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ))
        self.lm_decoder_path("lm_arctic_480b", serve_cfg, train_cfg, ocfg,
                             [_learnable_batch()] * LM_TRAIN_STEPS, serve_tokens=tokens,
                             cut=[f"depth {ARCTIC_LAYERS} of {cfg.num_layers}",
                                  f"train experts {ARCTIC_TRAIN_EXPERTS} of {cfg.num_experts}"])

    @contextlib.contextmanager
    def route_spy(self):
        """Records each ``moe._route`` call's picks ``idx`` and group length
        while the block is open."""
        moe = importlib.import_module("repro_torch.models.moe")
        real, calls = moe._route, []

        def spy(params, cfg, x, key):
            out = real(params, cfg, x, key)
            calls.append((out[1].detach(), x.shape[1]))
            return out

        moe._route = spy
        try:
            yield calls
        finally:
            moe._route = real

    def drop_share(self, cfg, calls) -> float:
        """The share of (token, choice) pairs past their expert's capacity
        over the recorded routes, reckoned as ``moe_apply`` places them."""
        moe = importlib.import_module("repro_torch.models.moe")
        torch = self.torch
        dropped = total = 0
        for idx, s in calls:
            g = idx.shape[0]
            counts = torch.zeros((g, cfg.num_experts), dtype=torch.int64, device=idx.device)
            counts.scatter_add_(1, idx.reshape(g, -1), torch.ones_like(idx.reshape(g, -1)))
            dropped += int(torch.clamp(counts - moe.capacity(cfg, s), min=0).sum())
            total += idx.numel()
        return dropped / total

    def lm_decoder_path(self, name, cfg, train_cfg, ocfg, batches, cut=(), extra=None,
                        trace_host=True, serve_tokens=None):
        """One LM cell: ``len(batches)`` train steps of ``train_cfg`` (loss
        finite and falling), its f32 cross-checks, then prefill of 8 ×
        1,024 ``serve_tokens`` (the learnable pattern by default) and 16
        decode tokens of ``cfg`` (the same model where the two configs are
        one).  Each model is freed before the next is built."""
        from repro_torch.models import model as lm
        from repro_torch.train import optimizer
        from repro_torch.train import train_step as steps

        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = lm.DecoderLM(train_cfg, seed=0, device=self.dev)
        init_s = time.perf_counter() - t0
        train_params = sum(p.numel() for p in model.parameters())
        ostate = optimizer.opt_init(ocfg, dict(model.named_parameters()))
        times: list = []
        norms: list = []
        step_fn = steps.make_train_step(train_cfg, ocfg, device=self.dev)
        ostate, _, losses = self.lm_train(model, step_fn, ostate, 0, batches, times, norms)
        _log(f"[{name}] {len(batches)} train steps: {[round(t, 3) for t in times]} s, "
             f"losses {losses}, gradient norms {norms}")
        _require(np.isfinite(losses).all() and losses[-1] < losses[0],
                 f"{name}: the loss is not finite or did not fall: {losses}")
        train_ms = float(np.median(times[2:])) * 1e3
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        train_prof = self.profile(f"{name} train", lambda: step_fn(
            model, ostate, len(batches), batches[-1]), host_events=trace_host, steps_per_call=1)
        _log(f"[{name}] train traced: idle {train_prof['device_idle_share']:.3f}")
        del ostate, step_fn
        if train_cfg != cfg:
            check = self.lm_f32_check(name, train_cfg, model)
            _log(f"[{name}] f32 check: {check}")
            del model
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = lm.DecoderLM(cfg, seed=0, device=self.dev)
            init_s += time.perf_counter() - t0

        tokens = _learnable_batch()["tokens"] if serve_tokens is None else serve_tokens
        prefill = steps.make_prefill(cfg, device=self.dev)
        pre = self.loop_ms(lambda: prefill(model, {"tokens": tokens}), 3)
        with self.route_spy() as calls:
            last = prefill(model, {"tokens": tokens})
        _require(bool(torch.isfinite(last.float()).all())
                 and tuple(last.shape) == (LM_BATCH, cfg.vocab_size),
                 f"{name}: prefill gave {tuple(last.shape)} or non-finite logits")
        serve = steps.make_serve_step(cfg, LM_BATCH, LM_SEQ + LM_DECODE, device=self.dev)
        cache = lm.init_cache(cfg, LM_BATCH, LM_SEQ + LM_DECODE, device=self.dev)
        tok = torch.from_numpy(tokens[:, :1]).to(self.dev)
        dec_times = []
        for _ in range(LM_DECODE):
            t0 = time.perf_counter()
            lg, cache = serve(model, cache, tok)
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
            self.sync()
            dec_times.append(time.perf_counter() - t0)
        _require(cache["index"] == LM_DECODE and bool(torch.isfinite(lg.float()).all())
                 and tuple(lg.shape) == (LM_BATCH, 1, cfg.vocab_size),
                 f"{name}: decode gave {tuple(lg.shape)} or non-finite logits")
        decode_ms = float(np.median(dec_times[1:])) * 1e3
        _log(f"[{name}] prefill {pre:.1f} ms, decode {decode_ms:.2f} ms a token")
        decode_prof = self.profile(f"{name} decode", lambda: serve(model, cache, tok),
                                   steps_per_call=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del cache, lg, last
        if train_cfg == cfg:
            check = self.lm_f32_check(name, cfg, model)
        row = dict(path=name, params=sum(p.numel() for p in model.parameters()),
                   layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
                   dtype=cfg.dtype, remat=cfg.remat, microbatches=cfg.microbatches,
                   batch=LM_BATCH, seq=LM_SEQ, init_s=init_s, train_steps=len(batches),
                   losses=losses, grad_norms=norms,
                   grad_clip=ocfg.grad_clip if np.isfinite(ocfg.grad_clip) else None,
                   train_ms_per_step=train_ms,
                   train_tokens_per_s=LM_BATCH * LM_SEQ / (train_ms * 1e-3),
                   train_peak_gib=train_peak, prefill_ms=pre,
                   prefill_tokens_per_s=LM_BATCH * LM_SEQ / (pre * 1e-3),
                   decode_ms_per_token=decode_ms, decode_batch=LM_BATCH,
                   decode_cache=LM_SEQ + LM_DECODE, peak_gib=peak, f32_check=check,
                   train_profile=train_prof, decode_profile=decode_prof, card=self.card)
        if train_cfg != cfg:
            row.update(cut=list(cut), train_layers=train_cfg.num_layers,
                       train_experts=train_cfg.num_experts, train_params=train_params,
                       optimizer=ocfg.kind)
        if cfg.num_experts:
            row.update(experts=cfg.num_experts, prefill_drop_share=self.drop_share(cfg, calls))
        row.update(extra or {})
        _log(f"[{name}] {json.dumps(row)}")
        self.paths.append(row)
        del model
        torch.cuda.empty_cache()

    def lm_f32_check(self, name, cfg, model):
        """The weights cast to f32: loss and logits on 1 × 128 tokens against
        the CPU port, and 16 decode steps against the forward.  A decode step
        routes one token a group, which never drops a choice, so for an
        expert config the forward it is held against has room for every
        choice too.  Each bound is the larger of a fixed one (loss 1e-4
        relative, logits 1e-4 of their scale, decode 3e-3) and twice the
        most the CPU's own result moves over ``LM_JITTERS`` jitters of the
        weights by 1e-7 relative (last bits, as the card's association moves
        them; one jitter where it moves the logits by less than a tenth of
        the fixed bound): an ill-conditioned model (the xLSTM's sLSTM at full
        width) moves by more than the fixed bounds.  Where that widens the logits'
        bound, the card's logits with TF32 products, a control, must fall
        outside it.  The recurrent cells are then held alone under the fixed
        bound (:meth:`lm_cell_check`)."""
        from repro_torch.models import model as lm

        torch = self.torch
        # all f32: the sLSTM's bf16 recurrent product (``reduce_dtype``) would
        # round card and CPU values that differ in their last bits apart
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                    reduce_dtype="f32")
        m32 = lm.DecoderLM(cfg32, seed=0, device=self.dev)
        m32.load_state_dict(model.state_dict())  # copy_ widens bf16 exactly
        rs = np.random.default_rng(SEED)
        toks = torch.from_numpy(rs.integers(0, cfg.vocab_size, (1, LM_CHECK_SEQ)))
        labels = torch.roll(toks, -1, dims=1)
        with torch.no_grad():
            card_loss = float(lm.loss_fn(m32, toks.to(self.dev), labels.to(self.dev)))
            card_logits, _ = lm.forward(m32, toks.to(self.dev))
            with self.tf32():
                tf32_logits = lm.forward(m32, toks.to(self.dev))[0].cpu()
            full = card_logits
            if cfg.num_experts:
                wide = lm.DecoderLM(dataclasses.replace(
                    cfg32, capacity_factor=float(cfg.num_experts)), device=self.dev)
                wide.load_state_dict(m32.state_dict())
                full, _ = lm.forward(wide, toks.to(self.dev))
                del wide
            cache = lm.init_cache(cfg32, 1, LM_DECODE, device=self.dev)
            dec = torch.cat([lm.decode_step(m32, toks[:, t:t + 1].to(self.dev), cache)[0]
                             for t in range(LM_DECODE)], dim=1)
            dec_err = float((dec - full[:, :LM_DECODE]).abs().max())
            card_logits = card_logits.cpu()
            del cache, dec, full
            m32.to("cpu")
            torch.cuda.empty_cache()
            cpu_loss = float(lm.loss_fn(m32, toks, labels))
            cpu_logits, _ = lm.forward(m32, toks)
            ce = lambda lg: float(torch.nn.functional.cross_entropy(lg[0], labels[0]))
            scale = float(cpu_logits.abs().max())
            params = list(m32.parameters())
            weights = [p.clone() for p in params]
            spreads, loss_spreads = [], []
            for seed in range(LM_JITTERS):
                gen = torch.Generator().manual_seed(SEED + seed)
                for p, w in zip(params, weights):
                    p.copy_(w * (1 + 1e-7 * torch.randn(p.shape, generator=gen)))
                jit_logits, _ = lm.forward(m32, toks)
                spreads.append(float((jit_logits - cpu_logits).abs().max()))
                loss_spreads.append(abs(ce(jit_logits) - ce(cpu_logits)) / abs(ce(cpu_logits)))
                if 2 * spreads[-1] < 1e-5 * scale:  # a tenth of the fixed bound: well conditioned
                    break
        del m32, params, weights
        spread = max(spreads)
        logits_err = float((card_logits - cpu_logits).abs().max())
        tf32_err = float((tf32_logits - cpu_logits).abs().max())
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        bounds = dict(loss_bound=max(1e-4, 2 * max(loss_spreads)),
                      logits_bound=max(1e-4 * scale, 2 * spread),
                      decode_bound=max(3e-3, 2 * spread))
        _require(loss_rel <= bounds["loss_bound"],
                 f"{name} f32: loss {card_loss} on the card, {cpu_loss} on the CPU")
        _require(logits_err <= bounds["logits_bound"],
                 f"{name} f32: logits differ by {logits_err:.3g} (scale {scale:.3g}, "
                 f"jitter spreads {spreads})")
        _require(dec_err <= bounds["decode_bound"],
                 f"{name} f32: decode differs from forward by {dec_err:.3g}")
        _require(bounds["logits_bound"] == 1e-4 * scale or tf32_err > bounds["logits_bound"],
                 f"{name} f32: TF32 logits differ by {tf32_err:.3g}, inside the widened "
                 f"bound {bounds['logits_bound']:.3g}: the check cannot see a TF32 product")
        return dict(tokens=LM_CHECK_SEQ, card_loss=card_loss, cpu_loss=cpu_loss,
                    loss_rel_err=loss_rel, logits_max_abs_err=logits_err, logits_scale=scale,
                    jitter_logits_spreads=spreads, jitter_loss_spreads=loss_spreads,
                    tf32_logits_max_abs_err=tf32_err,
                    decode_vs_forward_max_abs_err=dec_err, cells=self.lm_cell_check(name, cfg),
                    **bounds)

    @contextlib.contextmanager
    def tf32(self):
        """f32 products in TF32 while the block is open (a control)."""
        matmul = self.torch.backends.cuda.matmul
        matmul.allow_tf32 = True
        try:
            yield
        finally:
            matmul.allow_tf32 = False

    def lm_cell_check(self, name, cfg) -> dict:
        """Each recurrent cell kind of ``cfg`` alone, at its full widths in
        f32 on weights of the port's init: its train form on 1 × 128 inputs
        on the card against the CPU, within ``LM_CELL_TOL`` of the output's
        scale; and with TF32 products, the control, read beside it."""
        from repro_torch.models import layers
        from repro_torch.models import recurrent as rec

        torch = self.torch
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                    reduce_dtype="f32")
        x = np.random.default_rng(SEED).standard_normal((1, LM_CHECK_SEQ, cfg.d_model))
        x = torch.from_numpy((x * 0.5).astype(np.float32))
        out = {}
        for kind in ("rglru", "mlstm", "slstm"):
            if kind not in cfg.layer_kinds():
                continue
            cell = layers.ParamTree(getattr(rec, f"{kind}_defs")(cfg32), torch.float32,
                                    torch.device("cpu"))
            cell.init_from(torch.Generator().manual_seed(SEED))
            params = cell.tree()
            card_params = {k: v.to(self.dev) for k, v in params.items()}
            train = getattr(rec, f"{kind}_train")
            with torch.no_grad():
                want = train(params, cfg32, x)
                got = train(card_params, cfg32, x.to(self.dev)).cpu()
                with self.tf32():
                    tf32 = train(card_params, cfg32, x.to(self.dev)).cpu()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            out[kind] = dict(max_abs_err=err, scale=scale, bound=LM_CELL_TOL * scale,
                             tf32_max_abs_err=float((tf32 - want).abs().max()))
            _require(err <= LM_CELL_TOL * scale,
                     f"{name} f32 {kind} cell: card and CPU differ by {err:.3g} (scale {scale:.3g})")
        return out

    # -- the user entry points --------------------------------------------------

    # -- the device mesh -----------------------------------------------------

    def mesh_paths(self):
        """Phase 14: the LM harness on the host mesh (``make_host_mesh()``:
        NCCL, a world of one, mesh (1, 1)) against the same steps without a
        mesh: ``mesh_gemma3_1b`` (train, prefill, decode) and
        ``mesh_arctic_480b`` (train, the experts' local dispatch region).
        The production mesh must refuse one card, naming its 256 ranks.  The
        world of one is destroyed at the end."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_host_mesh()
        try:
            _require(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
                     f"mesh: the host mesh of one card is {mesh}")
            try:
                make_production_mesh()
                refused = None
            except RuntimeError as e:
                refused = str(e)
            _require(refused is not None and "needs 256 ranks" in refused,
                     f"mesh: the production mesh on one card did not refuse: {refused}")
            cfg = get_config("gemma3_1b")
            self.mesh_path("mesh_gemma3_1b", mesh, cfg, MESH_GEMMA_STEPS, serve=True,
                           extra=dict(production_mesh_refused=refused))
            arctic = get_config("arctic_480b")
            train_cfg = dataclasses.replace(arctic, num_layers=ARCTIC_LAYERS,
                                            num_experts=ARCTIC_TRAIN_EXPERTS)
            self.mesh_path("mesh_arctic_480b", mesh, train_cfg, MESH_ARCTIC_STEPS,
                           extra=dict(cut=[f"depth {ARCTIC_LAYERS} of {arctic.num_layers}",
                                           f"experts {ARCTIC_TRAIN_EXPERTS} of "
                                           f"{arctic.num_experts}"]))
        finally:
            torch.distributed.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()

    def mesh_run(self, cfg, mesh, steps: int, serve: bool) -> dict:
        """``steps`` train steps of a seed-0 model of ``cfg`` (placed on
        ``mesh`` unless it is None) on the learnable batch, after, with
        ``serve``, the fresh model's prefill of 8 × 1,024 and 16 greedy
        decode tokens at batch 8: losses, gradient norms, each step's
        seconds, the prefill's argmax and the decoded tokens, peak GiB."""
        from repro_torch.models import model as lm
        from repro_torch.train import optimizer
        from repro_torch.train import train_step as steps_mod

        torch = self.torch
        whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = lm.DecoderLM(cfg, seed=0, device=self.dev)
        if mesh is not None:
            model = steps_mod.shard_model(model, mesh)
        out: dict = {}
        if serve:
            tokens = _learnable_batch()["tokens"]
            prefill = steps_mod.make_prefill(cfg, mesh, device=self.dev)
            t0 = time.perf_counter()
            last = whole(prefill(model, {"tokens": tokens}))
            self.sync()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            _require(bool(torch.isfinite(last.float()).all())
                     and tuple(last.shape) == (LM_BATCH, cfg.vocab_size),
                     f"mesh: prefill gave {tuple(last.shape)} or non-finite logits")
            out["prefill_argmax"] = torch.argmax(last.float(), dim=-1).tolist()
            cache = lm.init_cache(cfg, LM_BATCH, LM_SEQ + LM_DECODE, device=self.dev)
            if mesh is not None:
                cache = steps_mod.shard_cache(cache, mesh)
            serve_fn = steps_mod.make_serve_step(cfg, LM_BATCH, LM_SEQ + LM_DECODE, mesh,
                                                 device=self.dev)
            tok = torch.from_numpy(tokens[:, :1]).to(self.dev)
            decoded, dec_times = [], []
            for _ in range(LM_DECODE):
                t0 = time.perf_counter()
                lg, cache = serve_fn(model, cache, tok)
                tok = torch.argmax(whole(lg)[:, -1], dim=-1, keepdim=True)
                decoded.append(tok[:, 0].tolist())
                self.sync()
                dec_times.append(time.perf_counter() - t0)
            out["decoded"] = decoded
            out["decode_ms_per_token"] = float(np.median(dec_times[1:])) * 1e3
            del cache, lg, last
        ocfg = optimizer.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=2)
        ostate = optimizer.opt_init(ocfg, dict(model.named_parameters()))
        step_fn = steps_mod.make_train_step(cfg, ocfg, mesh, device=self.dev)
        times, norms = [], []
        _, _, losses = self.lm_train(model, step_fn, ostate, 0, [_learnable_batch()] * steps,
                                     times, norms)
        out.update(losses=losses, grad_norms=norms, step_s=times,
                   ms_per_step=float(np.median(times[1:])) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, ostate, step_fn
        return out

    def mesh_path(self, name, mesh, cfg, steps: int, serve=False, extra=None):
        """One mesh cell: :meth:`mesh_run` without the mesh, then on it;
        every loss, gradient norm and token equal."""
        t0 = time.perf_counter()
        plain = self.mesh_run(cfg, None, steps, serve)
        meshed = self.mesh_run(cfg, mesh, steps, serve)
        _require(np.isfinite(plain["losses"]).all(), f"{name}: a loss is not finite: {plain}")
        for key in ("losses", "grad_norms", "prefill_argmax", "decoded"):
            _require(plain.get(key) == meshed.get(key),
                     f"{name}: {key} differ on the mesh: {meshed.get(key)} vs {plain.get(key)}")
        row = dict(path=name, mesh=list(mesh.shape), params=cfg.param_count(),
                   layers=cfg.num_layers, experts=cfg.num_experts, dtype=cfg.dtype,
                   remat=cfg.remat, microbatches=cfg.microbatches, optimizer=cfg.optimizer,
                   batch=LM_BATCH, seq=LM_SEQ, train_steps=steps, losses=plain["losses"],
                   grad_norms=plain["grad_norms"], equal=True,
                   ms_per_step=meshed["ms_per_step"], plain_ms_per_step=plain["ms_per_step"],
                   step_s=meshed["step_s"], plain_step_s=plain["step_s"],
                   peak_gib=meshed["peak_gib"], plain_peak_gib=plain["peak_gib"],
                   seconds=time.perf_counter() - t0, card=self.card)
        if serve:
            row.update(decode_tokens=LM_DECODE, prefill_ms=meshed["prefill_ms"],
                       plain_prefill_ms=plain["prefill_ms"],
                       decode_ms_per_token=meshed["decode_ms_per_token"],
                       plain_decode_ms_per_token=plain["decode_ms_per_token"])
        row.update(extra or {})
        _log(f"[{name}] {json.dumps(row)}")
        self.paths.append(row)

    def entry_paths(self):
        """Phase 15: the training launcher as users run it, then the
        GraphSAINT, quickstart and batched-serving examples."""
        gc.collect()
        self.torch.cuda.empty_cache()
        self.launch_path()
        self.graphsaint_path()
        self.quickstart_path()
        self.serve_batch_path()

    def entry_launches(self) -> dict:
        """Each kernel wrapper's launches since the last reset, and the wide
        ``its_select`` kernels' among them."""
        return dict(self.kernels.launch_counts(),
                    its_select_wide=self.kernels.its_select.wide_launches)

    def launcher(self, ckpt_dir, steps: int) -> dict:
        """``python -m repro_torch.launch.train`` with ``LAUNCH_ARGS`` in a
        child process; what its log says: each step's loss, the last median
        ms a step, the corpus's kernel launches, the restart and the peak."""
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
        argv = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
                "--steps", str(steps), "--ckpt-dir", str(ckpt_dir)]
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        secs = time.perf_counter() - t0
        _log(f"[launch] {' '.join(argv[3:])}: exit {out.returncode} in {secs:.1f} s\n"
             + out.stdout.strip())
        _require(out.returncode == 0, f"launcher exited {out.returncode}: {out.stderr[-3000:]}")
        log = out.stdout
        steps_seen = re.findall(r"^step\s+(\d+) loss (\S+) gnorm (\S+) \((\d+) ms/step\)$",
                                log, re.M)
        restarted = re.search(r"^restarted from step (\d+)$", log, re.M)
        corpus = re.search(r"^walk corpus: .* in (\S+) s, kernel launches (\{.*\})$", log, re.M)
        times = re.search(r"^step times \(ms\): (.*)$", log, re.M)
        finished = re.search(r"^finished at step (\d+), loss (\S+?)(, peak (\S+) GiB)?$", log,
                             re.M)
        _require(steps_seen and corpus and times and finished,
                 f"launcher log not understood:\n{log}")
        return dict(seconds=secs, losses={int(i): float(x) for i, x, _, _ in steps_seen},
                    grad_norms=[float(g) for _, _, g, _ in steps_seen],
                    median_ms=float(steps_seen[-1][3]),
                    step_ms=[float(t) for t in times.group(1).split(", ")],
                    restarted=int(restarted.group(1)) if restarted else None,
                    corpus_s=float(corpus.group(1)),
                    corpus_launches=ast.literal_eval(corpus.group(2)),
                    peak_gib=float(finished.group(4)) if finished.group(4) else None)

    def launch_path(self):
        """``launch_gemma3_1b``: the launcher at the full gemma3_1b config,
        4 steps straight; then a restart from its checkpoint at step 2 that
        runs steps 2-3, whose losses must follow the straight run's."""
        with tempfile.TemporaryDirectory() as tmp:
            run = Path(tmp) / "run"
            straight = self.launcher(run, LAUNCH_STEPS)
            # the restart resumes from the checkpoint the straight run wrote
            # mid-run at LAUNCH_RESUME (``--ckpt-every``): the later ones go
            for d in run.glob("step_*"):
                if int(d.name[len("step_"):].split(".")[0]) > LAUNCH_RESUME:
                    shutil.rmtree(d)  # 10 GB a checkpoint
            resumed = self.launcher(run, LAUNCH_STEPS)
        _require(straight["corpus_launches"].get("reject_step", 0) > 0,
                 f"launch: the walk corpus launched no reject_step: {straight}")
        want = [straight["losses"][i] for i in range(LAUNCH_RESUME, LAUNCH_STEPS)]
        got = [resumed["losses"].get(i) for i in range(LAUNCH_RESUME, LAUNCH_STEPS)]
        _require(resumed["restarted"] == LAUNCH_RESUME and None not in got,
                 f"launch: the second run did not restart at {LAUNCH_RESUME}: {resumed}")
        err = float(np.max(np.abs(np.array(got) - want) / np.abs(want)))
        _require(np.isfinite(list(straight["losses"].values())).all()
                 and err <= LAUNCH_RESTART_RTOL,
                 f"launch: the restarted losses {got} differ from {want} by {err:.3g}")
        # the first step of a process loads the card's kernels and grows the
        # allocator's pool: the steady step is the median of the others
        ms = float(np.median(straight["step_ms"][1:]))
        row = dict(path="launch_gemma3_1b", argv=list(LAUNCH_ARGS), steps=LAUNCH_STEPS,
                   ms_per_step=ms, tokens_per_s=LAUNCH_BATCH * LAUNCH_SEQ / (ms * 1e-3),
                   step_ms=straight["step_ms"], log_median_ms=straight["median_ms"],
                   peak_gib=straight["peak_gib"], losses=straight["losses"],
                   grad_norms=straight["grad_norms"], corpus_s=straight["corpus_s"],
                   launches=straight["corpus_launches"], seconds=straight["seconds"],
                   restart=dict(resumed_at=resumed["restarted"], losses=got, straight=want,
                                max_rel_err=err, bound=LAUNCH_RESTART_RTOL,
                                seconds=resumed["seconds"], step_ms=resumed["step_ms"],
                                peak_gib=resumed["peak_gib"]),
                   card=self.card)
        _log(f"[launch_gemma3_1b] {json.dumps(row)}")
        self.paths.append(row)

    def graphsaint_path(self):
        """``graphsaint``: the example's GCN training at 16 and 2,000
        instances; accuracy above 0.6, the first rounds' sampled vertex sets
        equal to the CPU port's."""
        kernels = self.kernels
        ex = _load_example("graphsaint_gcn_torch")
        g, labels = ex.sbm_graph(device=self.dev)
        cpu_g, k = g.to("cpu"), int(labels.max() + 1)
        runs = []
        for instances in SAINT_INSTANCES:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res = ex.train(g, labels, ex.init_params(k), rounds=SAINT_ROUNDS,
                               instances=instances, device=self.dev)
            secs = time.perf_counter() - t0
            launches = self.entry_launches()
            _require(launches["its_select"] > 0,
                     f"graphsaint: MDRW launched no its_select: {launches}")
            _require(res["acc"] > 0.6, f"graphsaint at {instances}: accuracy {res['acc']}")
            for r in range(SAINT_CHECK_ROUNDS):
                cpu = ex.sample_nodes(cpu_g, instances, r, "cpu")
                _require(np.array_equal(cpu, res["nodes"][r]),
                         f"graphsaint at {instances}: round {r}'s sampled vertices differ")
            runs.append(dict(instances=instances, seconds=secs,
                             ms_per_round=secs / SAINT_ROUNDS * 1e3, accuracy=res["acc"],
                             first_loss=res["loss"][0], last_loss=res["loss"][-1],
                             mean_sampled_nodes=float(np.mean([len(x) for x in res["nodes"]])),
                             launches=launches, cpu_equal_rounds=SAINT_CHECK_ROUNDS))
        row = dict(path="graphsaint", vertices=g.num_vertices, edges=g.num_edges,
                   rounds=SAINT_ROUNDS, runs=runs, card=self.card)
        _log(f"[graphsaint] {json.dumps(row)}")
        self.paths.append(row)

    def quickstart_path(self):
        """``quickstart``: the example at its defaults; the first walks of
        each algorithm and the neighbor sampling equal to the CPU port's."""
        torch, kernels = self.torch, self.kernels
        ex = _load_example("quickstart_torch")
        printed = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            card = ex.run(self.dev)
        secs = time.perf_counter() - t0
        launches = self.entry_launches()
        _log("[quickstart]\n" + printed.getvalue().strip())
        with contextlib.redirect_stdout(sys.stderr):
            cpu = ex.run("cpu", num_seeds=QUICK_CHECK_WALKERS, num_pools=QUICK_POOLS)
        for name in (*ex.BUILT_IN, "custom_hot"):
            a = card[name].walks[:QUICK_CHECK_WALKERS].cpu()
            _require(torch.equal(a, cpu[name].walks),
                     f"quickstart: {name}'s first walks differ from the CPU's")
        for field in ("edges_src", "edges_dst", "num_edges", "iters", "searches"):
            _require(torch.equal(getattr(card["neighbor"], field).cpu(),
                                 getattr(cpu["neighbor"], field)),
                     f"quickstart: neighbor sampling's {field} differs from the CPU's")
        for name in ("reject_step", "walk_step_window", "its_select"):
            _require(launches[name] > 0, f"quickstart: no {name} launch: {launches}")
        seps = {m.group(1): float(m.group(2)) for m in
                re.finditer(r"^(\S+)\s+SEPS=(\S+)$", printed.getvalue(), re.M)}
        row = dict(path="quickstart", seconds=secs, seps=seps,
                   neighbor_iters=int(card["neighbor"].iters),
                   neighbor_searches=int(card["neighbor"].searches),
                   custom_edges=int(card["custom_hot"].sampled_edges),
                   cpu_equal_walkers=QUICK_CHECK_WALKERS, launches=launches, card=self.card)
        _log(f"[quickstart] {json.dumps(row)}")
        self.paths.append(row)

    def serve_batch_path(self):
        """``serve_batch``: the example's five modes at their defaults; in
        the in-memory, OOM and sharded modes every request's walks equal the
        CPU port's service on the same requests; no streamed request fails."""
        kernels = self.kernels
        ex = _load_example("serve_batch_torch")
        modes = {}
        for mode in ("memory", "oom", "sharded", "stream", "lm"):
            flags = [] if mode == "memory" else [f"--{mode}"]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                out = ex.main(["--device", str(self.dev), *flags])
            entry = dict(seconds=time.perf_counter() - t0, launches=self.entry_launches())
            if mode in ("memory", "oom", "sharded"):
                svc, results, tickets = out
                with contextlib.redirect_stdout(sys.stderr):
                    _, want, _ = ex.main(["--device", "cpu", *flags])
                _require(sorted(results) == sorted(want) and all(
                    np.array_equal(results[r].walks, want[r].walks) for r in want),
                    f"serve_batch {mode}: the card's walks differ from the CPU's")
                entry.update(requests=len(results), service_launches=getattr(
                    svc.stats, {"memory": "launches", "oom": "oom_launches",
                                "sharded": "sharded_launches"}[mode]),
                    padded_slots=svc.stats.padded_walker_slots, cpu_equal=True)
            elif mode == "stream":
                failed = sum(f.exception(timeout=60) is not None for f in out)
                _require(failed == 0, f"serve_batch stream: {failed} requests failed")
                totals = [f.latency.total_ms for f in out]
                entry.update(requests=len(out), failed=failed,
                             p50_ms=self.percentile(totals, 50),
                             p99_ms=self.percentile(totals, 99))
            else:
                _require(out.shape == (8, 32) and (out >= 0).all(),
                         f"serve_batch lm: decoded {out.shape}")
                entry.update(tokens=list(out.shape))
            modes[mode] = entry
        row = dict(path="serve_batch", modes=modes, card=self.card)
        _log(f"[serve_batch] {json.dumps(row)}")
        self.paths.append(row)

    # -- the run ------------------------------------------------------------

    def run(self):
        torch, alg = self.torch, self.alg
        t0 = time.perf_counter()
        self.build.load()
        _log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
        for line in self.build.build_log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                _log("  " + line.strip())

        t0 = time.perf_counter()
        g = self.gen.rmat_graph(RMAT_SCALE, edge_factor=16, seed=SEED, weighted=True,
                                device=self.dev)
        gen_s = time.perf_counter() - t0
        rejection = ("rejection",) * 3
        self.run_path("main", g, alg.deepwalk(), "reject_step", gen_s, expect_plan=rejection)
        self.hash_check(g.num_vertices)
        self.run_path("node2vec", g, alg.node2vec(), "walk_step_window", gen_s,
                      depth=NODE2VEC_DEPTH)
        for name, spec, rule in [
            ("mhrw", alg.metropolis_hastings_walk(), "stay"),
            ("jump", alg.random_walk_with_jump(TELEPORT_PROB, g.num_vertices), "any"),
            ("restart_home", alg.random_walk_with_restart(TELEPORT_PROB), "seed"),
        ]:
            self.run_path(name, g, spec, "reject_step", gen_s, expect_plan=rejection,
                          depth=EPILOGUE_DEPTH, hop_rule=rule)
        self.traversal_paths(g, gen_s)
        seg = self.run_segments("segments", g, alg.deepwalk(), "reject_step",
                                expect_plan=rejection)
        seg["serve_shape"] = self.serve_shape(g, alg.deepwalk())
        seg["node2vec_rows"] = self.segments_vs_cpu("segments node2vec", g, alg.node2vec(),
                                                    "walk_step_window")
        self.serve_path(g)
        parts = self.oom_paths(g)
        self.serve_oom_path(g, parts)
        del parts
        self.shard_path(g)
        del g
        self._cpu_graphs.clear()
        self.mt.clear_plan_cache()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        g = self.gen.powerlaw_graph(POWERLAW_VERTICES, seed=SEED, weighted=True, device=self.dev)
        gen_s = time.perf_counter() - t0
        its = dataclasses.replace(alg.weighted_random_walk(), selection_method="its")
        self.run_path("its", g, its, "walk_step", gen_s, expect_plan=("its",) * 3)
        self.run_path("alias", g, alg.weighted_random_walk(), "alias_step", gen_s,
                      expect_plan=("alias",) * 3)
        self.serve_mixed_path(g)
        opaque = dataclasses.replace(alg.weighted_random_walk(), transition=None,
                                     flat_edge_bias=None)
        self.run_path("opaque", g, opaque, "its_select", gen_s)
        self.run_segments("segments its", g, its, "walk_step", expect_plan=("its",) * 3,
                          check_rows=(0,))
        seg = self.run_segments("segments alias", g, alg.weighted_random_walk(), "alias_step",
                                expect_plan=("alias",) * 3, check_rows=(0,))
        seg["opaque_rows"] = self.segments_vs_cpu("segments opaque", g, opaque, "its_select")
        self.stream_path(g)
        self.shard_pl_path(g)
        del g
        self._cpu_graphs.clear()
        self.mt.clear_plan_cache()
        torch.cuda.empty_cache()
        self.lm_paths()
        self.mesh_paths()
        self.entry_paths()

        for k in KERNELS:
            row = self.kernel_rows[k]
            _require(row["launches"] > 0 and row["mismatches"] == 0, f"kernel row {row}")


def traversal_cases(alg, g) -> list:
    """Phase 10's paths on graph ``g``: ``(name, spec, seeds, depth,
    pool_capacity, max_vertices)`` each, seeds drawn from the vertices with
    at least one edge; ``alg`` is ``repro_torch.core.algorithms``."""
    rng = np.random.default_rng(SEED)
    deg = (g.indptr[1:] - g.indptr[:-1]).cpu().numpy()
    live = np.nonzero(deg > 0)[0]
    one = rng.choice(live, (TRAVERSAL_INSTANCES, 1)).astype(np.int32)
    pools = rng.choice(live, (TRAVERSAL_INSTANCES, MDRW_SEEDS)).astype(np.int32)
    v = g.num_vertices
    return [
        ("neighbor", alg.biased_neighbor_sampling(2, 8), one, 3, POOL_CAPACITY, v),
        ("snowball", alg.snowball_sampling(16, 8), one, 2, POOL_CAPACITY, v),
        ("layer", alg.layer_sampling(8, 8), one, 3, POOL_CAPACITY, v),
        ("mdrw", alg.multi_dimensional_random_walk(), pools, MDRW_DEPTH, MDRW_CAPACITY, 0),
    ]


def _learnable_batch() -> dict:
    """``repro``'s learnable pattern (``arange % 7 + 1``), LM_BATCH × LM_SEQ."""
    base = np.arange(LM_SEQ + 1) % 7 + 1
    return {"tokens": np.tile(base[:-1], (LM_BATCH, 1)).astype(np.int32),
            "labels": np.tile(base[1:], (LM_BATCH, 1)).astype(np.int32)}


def _step_kernels(methods: tuple, n_buckets: int) -> set:
    """The step kernels a flat plan launches once a step: one per method
    (the rejection and alias tails ride their cohorts' launch; ITS launches
    only for its bucketed cohorts)."""
    per_method = {"rejection": "reject_step", "alias": "alias_step"}
    want = {per_method[m] for m in methods if m in per_method}
    return want | ({"walk_step"} if "its" in methods[:n_buckets] else set())


def _load_example(name: str):
    """``examples/<name>.py``, loaded from the checkout."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    _require(out.returncode == 0 and out.stdout.strip(), "nvidia-smi gave no SM clock")
    return float(out.stdout.strip().splitlines()[0])


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        line = ""
    return line or "nvidia-smi gave no answer"


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the smoke run needs one card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"no port sources under {SRC}: run from the root of a checkout")
    sys.path.insert(0, str(SRC))

    t0 = time.perf_counter()
    smoke = Smoke()
    smoke.run()
    print(json.dumps({"paths": smoke.paths, "device_hash": smoke.hash_row,
                      "seconds": time.perf_counter() - t0}))
    print(json.dumps({"kernels": [smoke.kernel_rows[k] for k in KERNELS]}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
