#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card, at real sizes.

Drives the port's flat-bias ``random_walk`` (the paper's MAIN loop) through
the hand-written CUDA walk-step kernels and checks what comes out.  One walk
per vertex, depth 40 (DeepWalk's walk length):

1. main path — ``deepwalk``, auto plan (rejection in every cohort, rejection
   tail) on R-MAT scale 21, edge factor 16: 2.1M vertices and about 60M CSR
   entries, the edge count of SNAP soc-LiveJournal1;
2. ITS path — ``weighted_random_walk`` pinned to ITS on a 1M-vertex
   power-law graph (maximum degree about 1k, so the chunked ITS tail stays
   at two chunks or fewer);
3. alias path — ``weighted_random_walk``, auto plan (alias in every cohort)
   on the same power-law graph;
4. per kernel — each kernel against its plain PyTorch version on the card,
   on its path's first-step inputs for every cohort, with its time per step,
   its bound (bytes over 3.35 TB/s, or f32 operations over 67 TFLOP/s, the
   larger) and the plain version's time;
5. cross-check — the first 4,096 walkers of each path, rerun on the CPU by
   the plain versions, equal the card's walks; every hop is a graph edge.

Each path runs with the kernels' launch counts set to 0 just before and read
just after; a kernel its path never launched fails the run.

Each path also records its counted-RNG time per step, and a torch.profiler
trace of two steps: device busy time, idle share and the kernels that took
the most device time.

Usage, from the root of a checkout (builds the kernels into build/kernels/):

    python3 chip_smoke.py

Prints a ``paths`` line (SEPS per path), a ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

RMAT_SCALE = 21
POWERLAW_VERTICES = 1_000_000
SEED = 7
DEPTH = 40
CHECK_WALKERS = 4096
TIMING_REPS = 20
PLAIN_CHUNK = 1 << 18  # walkers per plain-version call (bounds its temporaries)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


class Smoke:
    def __init__(self):
        import torch

        from repro_torch import kernels
        from repro_torch.core import algorithms, backend, methods, rng, select, transition
        from repro_torch.core.engine import flat_method_plan, random_walk
        from repro_torch.graph import generators
        from repro_torch.kernels import _build, ref

        self.torch, self.kernels, self.alg = torch, kernels, algorithms
        self.bk, self.mt, self.rng, self.sel, self.tp = backend, methods, rng, select, transition
        self.flat_method_plan, self.random_walk = flat_method_plan, random_walk
        self.gen, self.build, self.ref = generators, _build, ref
        self.dev = torch.device("cuda")
        self.key = rng.PRNGKey(SEED)
        self.paths: list[dict] = []
        self.kernel_rows: dict[str, dict] = {}

    # -- helpers -----------------------------------------------------------

    def sync(self):
        self.torch.cuda.synchronize()

    def event_ms(self, fn, reps: int) -> float:
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

    def check_walks(self, g, res, seeds):
        """Every hop is an edge; walks start at their seeds; no walker revives."""
        torch = self.torch
        walks = res.walks
        _require(walks.shape == (seeds.shape[0], DEPTH + 1), f"walks of shape {walks.shape}")
        _require(torch.equal(walks[:, 0], seeds), "walks do not start at their seeds")
        alive = walks >= 0
        _require(not (alive[:, 1:] & ~alive[:, :-1]).any(), "a walker came back to life")
        v = g.num_vertices
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        row = torch.repeat_interleave(torch.arange(v, device=self.dev), deg)
        edge_key = row * v + g.indices.long()  # ascending: rows are sorted
        a, b = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
        hop = b >= 0
        q = a[hop] * v + b[hop]
        pos = torch.searchsorted(edge_key, q).clamp(max=edge_key.shape[0] - 1)
        bad = int((edge_key[pos] != q).sum())
        _require(bad == 0, f"{bad} hops are not edges of the graph")
        _require(int(res.sampled_edges) == int(hop.sum()), "sampled_edges disagrees with the walks")
        return int(hop.sum())

    # -- one path ----------------------------------------------------------

    def run_path(self, name, g, spec, expect_plan, kernel_name, gen_s):
        torch = self.torch
        program = self.tp.lower(spec)
        max_degree = g.max_degree()
        t0 = time.perf_counter()
        methods, tables = self.flat_method_plan(g, program, max_degree)
        plan_s = time.perf_counter() - t0
        buckets, use_chunked = self.bk.walk_bucket_plan(max_degree)
        plan = self.mt.describe_plan(methods, buckets, use_chunked)
        _log(f"[{name}] V={g.num_vertices} E={g.num_edges} max_degree={max_degree} plan={plan}")
        _require(methods == expect_plan, f"{name}: planned {methods}, expected {expect_plan}")
        _require(use_chunked, f"{name}: the graph has no huge-degree tail")

        seeds = torch.arange(g.num_vertices, dtype=torch.int32, device=self.dev)
        walk = dict(depth=DEPTH, spec=spec, max_degree=max_degree, device=self.dev)
        self.random_walk(g, seeds, self.key, **dict(walk, depth=1))  # warm-up
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = self.random_walk(g, seeds, self.key, **walk)
        self.sync()
        seconds = time.perf_counter() - t0
        launches = self.kernels.launch_counts()
        _require(launches[kernel_name] > 0, f"{name}: {kernel_name} never launched: {launches}")
        edges = self.check_walks(g, res, seeds)
        row = dict(
            path=name, spec=spec.name, method=program.method, vertices=g.num_vertices,
            csr_entries=g.num_edges, max_degree=max_degree, walkers=g.num_vertices,
            depth=DEPTH, plan=plan, launches=launches, sampled_edges=edges,
            seconds=seconds, seps=edges / seconds, ms_per_step=1e3 * seconds / DEPTH,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, graph_s=gen_s, plan_s=plan_s,
        )
        _log(f"[{name}] {json.dumps(row)}")

        # cross-check: the first walkers again, on the CPU, by the plain versions
        n = min(CHECK_WALKERS, g.num_vertices)
        cpu = self.random_walk(g.to("cpu"), seeds[:n].cpu(), self.key, **dict(walk, device="cpu"))
        same = torch.equal(cpu.walks, res.walks[:n].cpu())
        _require(same, f"{name}: card walks differ from the CPU walks of the first {n} walkers")
        row["cpu_check_walkers"] = n
        row["rng_ms_per_step"] = self.rng_ms(g.num_vertices, methods)
        self.paths.append(row)

        self.measure_kernels(name, g, spec, methods, tables, buckets, kernel_name)
        row["kernel_ms_per_step"] = self.kernel_rows[kernel_name]["ms"]
        row.update(self.profile(name, g, seeds, walk))
        del res, cpu
        return row

    def rng_ms(self, w, methods):
        """Time of one step's counted-RNG draws at W walkers, as
        ``walk_step_adaptive`` makes them (bucket uniform, rejection budget,
        tail uniform)."""
        rng, sel = self.rng, self.sel
        kf = rng.fold_in(rng.fold_in(self.key, 0), 1)

        def draws():
            rng.uniform(rng.fold_in(kf, 0), (w,), device=self.dev)
            if "rejection" in methods:
                sel.rejection_randoms(rng.fold_in(kf, 2), (w,), device=self.dev)
            if methods[-1] != "rejection":
                rng.uniform(rng.fold_in(kf, 1), (w,), device=self.dev)

        return self.event_ms(draws, 5)

    # -- per-kernel comparison, time and bound ------------------------------

    def cohort_inputs(self, g, methods, tables, buckets):
        """The first step's cohort inputs, built as ``walk_step_adaptive``
        builds them (one walker per vertex)."""
        torch, rng = self.torch, self.rng
        w = g.num_vertices
        kf = rng.fold_in(rng.fold_in(self.key, 0), 1)
        cur = torch.arange(w, dtype=torch.int32, device=self.dev)
        safe = cur.long()
        starts = g.indptr[safe]
        deg = g.indptr[safe + 1] - starts
        common = dict(r=rng.uniform(rng.fold_in(kf, 0), (w,), device=self.dev))
        if "rejection" in methods:
            common["rej"] = self.sel.rejection_randoms(rng.fold_in(kf, 2), (w,), device=self.dev)
            common["rm"] = tables.row_max[safe]
        cohorts, lo = [], 0
        for seg in buckets:
            inb = (deg > lo) & (deg <= seg)
            cohorts.append((seg, torch.where(inb, starts, 0), torch.where(inb, deg, 0)))
            lo = seg
        huge = deg > buckets[-1]
        cohorts.append((None, torch.where(huge, starts, 0), torch.where(huge, deg, 0)))
        return common, cohorts

    def measure_kernels(self, path, g, spec, methods, tables, buckets, kernel_name):
        torch, ref, K = self.torch, self.ref, self.kernels
        bias = self.tp.lower(spec).bias.fn(g)
        common, cohorts = self.cohort_inputs(g, methods, tables, buckets)
        r = common["r"]
        counts_before = K.launch_counts()
        entries = []
        for seg, st, dg in cohorts:
            if kernel_name == "walk_step":
                if seg is None:
                    continue  # the ITS tail is the chunked scan, not a kernel
                dg = torch.clamp(dg, max=seg)
                launch = lambda st=st, dg=dg, seg=seg: K.walk_step(st, dg, g.indices, bias, r, max_seg=seg)
                plain_fn = lambda s, st=st, dg=dg, seg=seg: ref.walk_step_block_ref(
                    st[s], dg[s], g.indices, bias, r[s], seg=seg)
            elif kernel_name == "alias_step":
                launch = lambda st=st, dg=dg, seg=seg: K.alias_step(
                    st, dg, g.indices, tables.prob, tables.alias, r, max_seg=seg)
                plain_fn = lambda s, st=st, dg=dg, seg=seg: ref.alias_step_block_ref(
                    st[s], dg[s], g.indices, tables.prob, tables.alias, r[s], seg=seg)
            else:
                rej, rm = common["rej"], common["rm"]
                launch = lambda st=st, dg=dg, seg=seg: K.reject_step(
                    st, dg, g.indices, bias, rm, rej, max_seg=seg)
                plain_fn = lambda s, st=st, dg=dg, seg=seg: ref.reject_step_block_ref(
                    st[s], dg[s], g.indices, bias, rm[s], rej[s], seg=seg)
            w = st.shape[0]
            plain = lambda plain_fn=plain_fn: torch.cat(
                [plain_fn(slice(i, i + PLAIN_CHUNK)) for i in range(0, w, PLAIN_CHUNK)])
            got, want = launch(), plain()
            self.sync()
            mismatches = int((got != want).sum())
            err = int((got.long() - want.long()).abs().max())
            _require(mismatches == 0, f"{path}/{kernel_name} seg={seg}: {mismatches} mismatches")
            nbytes, nops = self.work(kernel_name, seg, st, dg, got, bias, common)
            bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
            entry = dict(
                seg=seg, walkers=w, live=int((dg > 0).sum()), mismatches=mismatches,
                max_abs_err=err, ms=self.event_ms(launch, TIMING_REPS),
                plain_ms=self.event_ms(plain, 2), bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= nops / F32_OPS_PER_S else "operations",
                bytes=nbytes, ops=nops,
            )
            _log(f"[{path}] {kernel_name} {json.dumps(entry)}")
            entries.append(entry)
        # comparison launches are not the main path's: restore its counts
        for fn in K.KERNEL_WRAPPERS:
            fn.launches = counts_before[fn.__name__]
        total = lambda k: sum(e[k] for e in entries)
        by_bytes = sum(e["bytes"] for e in entries) / HBM_BYTES_PER_S
        by_ops = sum(e["ops"] for e in entries) / F32_OPS_PER_S
        src = {
            "reject_step": "src/repro/kernels/walk_step.py:267",
            "alias_step": "src/repro/kernels/alias_select.py:66",
            "walk_step": "src/repro/kernels/walk_step.py:158",
        }
        self.kernel_rows[kernel_name] = dict(
            name=kernel_name, route="cuda", source="src/repro_torch/kernels/csrc/walk_kernels.cu",
            replaces=src[kernel_name], path=path,
            launches=self.paths[-1]["launches"][kernel_name],
            launches_per_step=len(entries), mismatches=total("mismatches"),
            max_abs_err=max(e["max_abs_err"] for e in entries),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=None,
            cohorts=entries,
        )

    def work(self, kernel_name, seg, st, dg, out, bias, common):
        """Bytes and f32 operations this launch needs on this data: each
        input word read once, each output written once; a rejection draw
        counts only the rounds up to its acceptance."""
        torch = self.torch
        w = st.shape[0]
        live = dg > 0
        n_live = int(live.sum())
        n_out = int((out >= 0).sum())
        nbytes = 8 * w + 8 * n_live + 4 * n_out  # degs + out; starts + r or rm; ids
        if kernel_name == "walk_step":
            nbytes += 4 * int(dg[live].long().sum())
            nops = 2 * (2 * seg) * n_live  # the window's adds and compares
        elif kernel_name == "alias_step":
            nbytes += 8 * n_live  # prob + alias words
            nops = 3 * n_live
        else:
            rej, rm = common["rej"], common["rm"]
            deg_eff = dg if seg is None else torch.clamp(dg, max=seg)
            hi = torch.clamp(deg_eff - 1, min=0)
            todo = live & (rm > 0)
            rounds = torch.zeros_like(dg)
            for t in range(rej.shape[1]):
                slot = torch.minimum((rej[:, t, 0] * deg_eff.float()).int(), hi)
                acc = rej[:, t, 1] * rm < bias[(st + slot).long().clamp(max=bias.shape[0] - 1)]
                rounds += todo.int()
                todo = todo & ~acc
            n_rounds = int(rounds.long().sum())
            nbytes += 12 * n_rounds  # the round's two uniforms + one bias word
            nops = 3 * n_rounds
        return nbytes, nops

    # -- profile ------------------------------------------------------------

    def profile(self, name, g, seeds, walk) -> dict:
        """Trace two steps; device time from the card's own events."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.random_walk(g, seeds, self.key, **dict(walk, depth=2))
            self.sync()
            wall = time.perf_counter() - t0
        # device-side events only: the aten ops on the host carry their
        # kernels' time too, and would count it twice
        rows = [
            (e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total
            and not e.key.startswith("Activity Buffer")
        ]
        rows.sort(key=lambda x: -x[1])
        busy_ms = sum(r[1] for r in rows) / 1e3
        _require(busy_ms > 0, f"{name}: the trace shows no device time")
        return dict(
            profile_steps=2, profile_wall_ms=wall * 1e3, profile_device_busy_ms=busy_ms,
            device_idle_share=1 - busy_ms / (wall * 1e3),
            profile_top=[[k[:60], us / 1e3, c] for k, us, c in rows[:8]],
        )

    # -- the run ------------------------------------------------------------

    def run(self):
        torch = self.torch
        t0 = time.perf_counter()
        self.build.load()
        _log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
        for line in self.build.build_log.splitlines():
            if "registers" in line or "spill" in line:
                _log("  " + line.strip())

        t0 = time.perf_counter()
        g = self.gen.rmat_graph(RMAT_SCALE, edge_factor=16, seed=SEED, weighted=True,
                                device=self.dev)
        gen_s = time.perf_counter() - t0
        self.run_path("main", g, self.alg.deepwalk(), ("rejection",) * 3, "reject_step", gen_s)
        del g
        self.mt.clear_plan_cache()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        g = self.gen.powerlaw_graph(POWERLAW_VERTICES, seed=SEED, weighted=True, device=self.dev)
        gen_s = time.perf_counter() - t0
        its = dataclasses.replace(self.alg.weighted_random_walk(), selection_method="its")
        self.run_path("its", g, its, ("its",) * 3, "walk_step", gen_s)
        self.run_path("alias", g, self.alg.weighted_random_walk(), ("alias",) * 3, "alias_step",
                      gen_s)

        for k in ("reject_step", "walk_step", "alias_step"):
            row = self.kernel_rows[k]
            _require(row["launches"] > 0 and row["mismatches"] == 0, f"kernel row {row}")


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
    print(json.dumps({"paths": smoke.paths, "seconds": time.perf_counter() - t0}))
    print(json.dumps({"kernels": [smoke.kernel_rows[k] for k in
                                  ("reject_step", "alias_step", "walk_step")]}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
