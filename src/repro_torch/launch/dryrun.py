"""Multi-pod dry run: the port of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k [--multipod]
    python -m repro_torch.launch.dryrun --all [--multipod] [--skip-existing]

Runs one step of every (architecture × input shape × mesh) cell as rank 0 of
the 16 × 16 or 2 × 16 × 16 production mesh, without a card and without
allocating: the process group is a fake one of 256 or 512 ranks
(``init_process_group("fake")``, whose collectives send nothing), and the
parameters, optimizer state, batch and decode cache are fake tensors
(``FakeTensorMode``), placed on the mesh as the port places real ones
(``shard_model``, ``opt_init``, ``place_batch``, ``shard_cache``).  The step
is the port's own (``make_train_step``, ``make_prefill``,
``make_serve_step``), run once under :class:`~repro_torch.launch.cost.OpCounter`
(the rank's FLOPs, bytes and collectives) and ``MemTracker`` (its peak
memory).  Each cell writes one JSON to
``results/dryrun_torch/<mesh>/<arch>__<shape>.json``.

The record keeps ``repro``'s keys where they mean something for an eager
step.  ``trace_s`` is the wall time of the fake step, in place of
``lower_s``.  ``repro``'s ``compile_s``, ``xla_raw_*`` and ``alias_bytes``
are not kept: nothing is compiled, there is no compiler's own cost analysis
to compare with, and the steps update their parameters, state and cache in
place, so no buffer is donated.  The roofline terms divide the rank's counts
by an H100's datasheet rates: they are predictions, not measurements.

Three behaviours of DTensor (torch 2.13) are adjusted for the run, and
restored after it (:func:`fake_dtensor`): a strided shard's offsets are
computed on real index tensors (DTensor reads them on the host, which a
fake tensor refuses); DTensor's shape propagation runs in a fake mode of
its own, so that its global-shape tensors count neither as the rank's work
nor as its memory; and a change of sharded dimension is an all-to-all, as
on the card's NCCL group (on a CPU mesh DTensor would gather and chunk).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import shapes as shp
from repro_torch.launch.cost import OpCounter
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.models import model as m
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: the datasheet's rates
PEAK_FLOPS = 989e12  # bf16 dense FLOP/s
HBM_BW = 3.35e12  # B/s
HBM_CAP = 80e9  # bytes
# A rank's network rate.  Every 16-rank "model" group and every "data" group
# of both production meshes spans more than one node of 8 GPUs, so each ring
# runs at the rate of the InfiniBand NDR port each GPU has on a DGX H100
# (400 Gb/s = 50 GB/s), not at NVLink's 450 GB/s inside a node.
NET_BW = 50e9  # B/s


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors and DTensors."""
    local = (t.to_local() if isinstance(t, DTensor) else t for t in _leaves(tree))
    return sum(t.numel() * t.element_size() for t in local)


@contextlib.contextmanager
def fake_dtensor():
    """DTensor adjusted for fake tensors and the card's collectives (the
    module's docstring says why); everything restored on exit."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily  # noqa: PLC0415
    from torch.distributed.tensor import _sharding_prop, placement_types  # noqa: PLC0415
    from torch.distributed.tensor.placement_types import _StridedShard  # noqa: PLC0415

    strided = _StridedShard.local_shard_size_and_offset
    alltoall = placement_types.shard_dim_alltoall
    detect = _sharding_prop.detect_fake_mode

    def strided_real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return strided(self, *args, **kwargs)

    def card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol  # noqa: PLC0415

        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    _StridedShard.local_shard_size_and_offset = strided_real
    placement_types.shard_dim_alltoall = card_alltoall
    _sharding_prop.detect_fake_mode = lambda *a: None
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = strided
        placement_types.shard_dim_alltoall = alltoall
        _sharding_prop.detect_fake_mode = detect


def fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks with this process as rank 0,
    unless a process group exists."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: PLC0415

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _build(cfg, sh: dict, mesh, fake):
    """The cell's step and its fake arguments, placed on ``mesh``:
    ``(call, arguments)``, ``call()`` running the step once."""
    b, s = sh["batch"], sh["seq"]
    with fake:
        model = ts.shard_model(m.DecoderLM(cfg, device="cpu"), mesh)
        inputs = {k: shp.fake_input(v, fake) for k, v in shp.cell_specs(cfg, sh).items()}
        if sh["kind"] == "train":
            ocfg = opt.OptConfig(kind=cfg.optimizer)
            state = opt.opt_init(ocfg, dict(model.named_parameters()))
            batch = ts.place_batch(inputs, mesh, ts.batch_specs(cfg, mesh, b))
            fn = ts.make_train_step(cfg, ocfg, mesh, device="cpu", global_batch=b)
            args = {"params": dict(model.named_parameters()), "opt_state": state, "batch": batch}
            return (lambda: fn(model, state, 0, batch)), args
        if sh["kind"] == "prefill":
            batch = ts.place_batch(inputs, mesh, ts.batch_specs(cfg, mesh))
            fn = ts.make_prefill(cfg, mesh, device="cpu")
            args = {"params": dict(model.named_parameters()), "batch": batch}
            return (lambda: fn(model, batch)), args
        cache = ts.shard_cache(m.init_cache(cfg, b, s, device="cpu"), mesh)
        tokens = ts.place_batch(inputs, mesh, {"tokens": shd.batch_spec(mesh, b)})["tokens"]
        fn = ts.make_serve_step(cfg, b, s, mesh, device="cpu")
        args = {"params": dict(model.named_parameters()), "cache": cache, "tokens": tokens}
        return (lambda: fn(model, cache, tokens)), args


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             overrides: dict | None = None) -> dict:
    """One cell's record on the production mesh, also written to
    ``out_dir``; a fake process group of the mesh's ranks is started unless
    one exists."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # launcher policy: pure-DP mode needs the global batch to fill the mesh;
    # otherwise fall back to TP (xlstm on 512 ranks with batch 256)
    n_chips = math.prod(PRODUCTION[multi_pod][0])
    sh = shp.SHAPES[shape_name]
    if cfg.tp_mode == "dp" and sh["batch"] < n_chips:
        cfg = dataclasses.replace(cfg, tp_mode="model", microbatches=max(cfg.microbatches, 2))
    ok, why = shp.cell_applicable(cfg, shape_name)
    rec: dict = {"arch": cfg.name, "shape": shape_name,
                 "mesh": "pod2x16x16" if multi_pod else "pod16x16",
                 "status": "skip" if not ok else "pending"}
    if not ok:
        rec["skip_reason"] = why
        return _save(rec, out_dir)
    fake_world(n_chips)
    rec.update(measure(cfg, sh, make_production_mesh(multi_pod, device="cpu")))
    return _save(rec, out_dir)


def measure(cfg, sh: dict, mesh) -> dict:
    """One step of ``cfg`` on the cell ``sh`` (a :data:`shapes.SHAPES`
    entry) as this rank of ``mesh``, on fake tensors: the record's measured
    keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: PLC0415
    from torch.distributed._tools.mem_tracker import MemTracker  # noqa: PLC0415

    chips = mesh.size()
    fake = FakeTensorMode()
    with fake_dtensor():
        call, args = _build(cfg, sh, mesh, fake)
        argument_bytes = _local_bytes(args)
        t0 = time.time()
        with fake:
            mem = MemTracker()
            mem.track_external(*_leaves(args))
            with mem, OpCounter(fake) as counter:
                out = call()
        trace_s = time.time() - t0
    # the rank's device; meta tensors (DTensor's and ``from_local``'s global
    # strides) hold no memory
    peak = sum(snap["Total"] for dev, snap in mem.get_tracker_snapshot("peak").items()
               if dev.type != "meta")
    if sh["kind"] == "train":
        output_bytes = _local_bytes((args["params"], out))
    else:
        output_bytes = _local_bytes(out)

    cost = counter.cost
    flops_dev, bytes_dev, wires = cost.flops, cost.bytes_accessed, cost.wire_bytes
    terms = {"compute_s": flops_dev / PEAK_FLOPS, "memory_s": bytes_dev / HBM_BW,
             "collective_s": wires / NET_BW}
    dominant = max(terms, key=terms.get)

    if sh["kind"] == "train":
        tokens = sh["batch"] * sh["seq"]
        model_flops = 6 * cfg.active_param_count() * tokens
    elif sh["kind"] == "prefill":
        tokens = sh["batch"] * sh["seq"]
        model_flops = 2 * cfg.active_param_count() * tokens
    else:
        tokens = sh["batch"]  # one token per sequence
        model_flops = 2 * cfg.active_param_count() * tokens
    total = flops_dev * chips
    useful = model_flops / total if total else 0.0

    return dict(
        status="ok",
        chips=chips,
        trace_s=round(trace_s, 2),
        peak_memory_bytes=int(peak),
        argument_bytes=int(argument_bytes),
        output_bytes=int(output_bytes),
        temp_bytes=int(peak - argument_bytes),
        fits_hbm=bool(peak < HBM_CAP),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collectives={k: v for k, v in cost.collectives.items() if v["count"]},
        wire_bytes_per_device=wires,
        roofline=terms,
        dominant=dominant,
        model_flops=model_flops,
        useful_flop_ratio=round(useful, 4),
        tokens=tokens,
        top_flops=cost.top_flops(8),
    )


def _save(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument(
        "--override", action="append", default=[],
        help="config override key=value (perf iterations; use with --out results/hillclimb)",
    )
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    mesh_name = "pod2x16x16" if args.multipod else "pod16x16"
    out_dir = os.path.join(args.out, mesh_name)

    if args.all:
        # one fresh process a cell: each starts its own fake process group,
        # and the sweep restarts cell by cell
        for a in ARCH_IDS:
            for s in shp.SHAPES:
                cfg_name = get_config(a).name
                path = os.path.join(out_dir, f"{cfg_name}__{s}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {cfg_name} {s}", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--out", args.out]
                if args.multipod:
                    cmd.append("--multipod")
                for ov in args.override:
                    cmd += ["--override", ov]
                subprocess.run(cmd, check=False)
        return

    assert args.arch and args.shape, "--arch/--shape or --all"
    arch, shape_name = args.arch, args.shape
    cfg_name = get_config(arch).name
    path = os.path.join(out_dir, f"{cfg_name}__{shape_name}.json")
    if args.skip_existing and os.path.exists(path):
        print(f"[skip existing] {cfg_name} {shape_name}")
        return
    print(f"[dryrun] {cfg_name} × {shape_name} × {mesh_name} {overrides or ''} ...", flush=True)
    try:
        rec = run_cell(arch, shape_name, args.multipod, out_dir, overrides)
        if rec["status"] == "ok":
            print(
                f"  ok: trace={rec['trace_s']}s peak={rec['peak_memory_bytes']/1e9:.2f}GB "
                f"flops/dev={rec['flops_per_device']:.3e} dominant={rec['dominant']} "
                f"useful={rec['useful_flop_ratio']}",
                flush=True,
            )
            print("  memory:", {"peak": rec["peak_memory_bytes"], "args": rec["argument_bytes"],
                                "temp": rec["temp_bytes"]})
            print("  cost:", {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
                              "wire": rec["wire_bytes_per_device"]})
        else:
            print(f"  SKIP: {rec.get('skip_reason')}", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec = {
            "arch": cfg_name, "shape": shape_name, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        _save(rec, out_dir)
        print(f"  ERROR: {e}", flush=True)


if __name__ == "__main__":
    main()
