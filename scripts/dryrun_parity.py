#!/usr/bin/env python3
"""``repro``'s dry run beside the port's: a rank's work, cell by cell.

    PYTHONPATH=src python scripts/dryrun_parity.py [--multipod] [--arch A ...]
        [--shape S ...] [--jobs N] [--skip-existing]

For every applicable (architecture × cell) of the 16 × 16 (or, with
``--multipod``, 2 × 16 × 16) production mesh it

1. runs ``repro.launch.dryrun.run_cell`` in a child process with 512 forced
   host devices on the CPU (``XLA_FLAGS=--xla_force_host_platform_device_count=512``,
   ``JAX_PLATFORMS=cpu``), its ``make_production_mesh`` replaced by a mesh of
   the same shape and axis names whose axes are ``AxisType.Auto`` (JAX 0.9's
   ``jax.make_mesh`` gives ``Explicit`` axes, which ``with_sharding_constraint``
   refuses), writing ``results/dryrun_ref/<mesh>/<arch>__<shape>.json``;
2. reads the port's ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``
   (``python -m repro_torch.launch.dryrun``);
3. prints, and writes to ``results/dryrun_parity/<mesh>.json``, both
   ``flops_per_device``, the port's over ``repro``'s, both
   ``useful_flop_ratio``s and both collective counts; a ratio above 1.10
   (``within_bound`` false) or below 0.90 (``below`` true: the port's rank
   does less, a layout that departs from ``repro``'s) is flagged.

The FLOPs are counts of a rank's work (XLA's HLO through ``repro``'s
``hlo_analysis.analyze``; the port's ``launch/cost.py::OpCounter``), not
times.  With ``--skip-existing`` a cell whose ``repro`` JSON exists is not
run again.  With ``--dots N`` the ``repro`` record also keeps its N largest
products (``top_flops``: XLA's ``dot`` shapes and their FLOPs over all
executions, as ``hlo_analysis.analyze`` counts them), and the table prints
both sides' largest products under each cell, to find a product that one
side runs and the other does not.  The script imports ``repro`` (in its children) and so lives
outside the port's package.

:func:`reference_cell` is the child's body; the tier-1 parity test calls it
on small meshes with smoke configs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model"), "pod16x16"),
          True: ((2, 16, 16), ("pod", "data", "model"), "pod2x16x16")}
BOUND = 1.10  # the port's FLOPs a rank over repro's that the parity asks
LOW = 0.90  # below this the port's layout departs from repro's: flagged


def reference_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
                   cfg=None, cell: dict | None = None,
                   mesh_shape: tuple | None = None, axes: tuple | None = None,
                   dots: int = 0) -> dict:
    """``repro.launch.dryrun.run_cell`` on an ``AxisType.Auto`` mesh of the
    production mesh's shape and names (or of ``mesh_shape`` / ``axes``); a
    ``cfg`` replaces ``get_config(arch)`` and a ``cell`` (a ``SHAPES``
    entry) is run under ``shape_name``; ``dots`` > 0 adds the ``dots``
    largest products to the record (``top_flops``).  Must run in a process
    that has not started JAX: it forces 512 host devices first."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax  # noqa: PLC0415
    from jax.sharding import AxisType  # noqa: PLC0415

    from repro.launch import dryrun, shapes  # noqa: PLC0415

    default_shape, default_axes, _ = MESHES[multi_pod]
    shape, names = tuple(mesh_shape or default_shape), tuple(axes or default_axes)

    def auto_mesh(*, multi_pod: bool = False):
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))

    dryrun.make_production_mesh = auto_mesh
    if cfg is not None:
        dryrun.get_config = lambda _arch: cfg
    if cell is not None:
        shapes.SHAPES[shape_name] = cell
    if not dots:
        return dryrun.run_cell(arch, shape_name, multi_pod, out_dir)
    found: dict = {}
    analyze = dryrun.analyze

    def analyze_dots(text):
        found.update(_dot_flops(text))
        return analyze(text)

    dryrun.analyze = analyze_dots
    rec = dryrun.run_cell(arch, shape_name, multi_pod, out_dir)
    if rec.get("status") == "ok":
        rec["top_flops"] = sorted(found.items(), key=lambda kv: -kv[1])[:dots]
        dryrun._save(rec, out_dir)
    return rec


def _dot_flops(text: str) -> dict:
    """XLA's products in the HLO ``text``, "dot lhs x rhs -> out" → FLOPs
    over all executions, as ``hlo_analysis.analyze`` counts them."""
    from repro.launch import hlo_analysis as ha  # noqa: PLC0415

    comps = ha.parse_hlo(text)
    mult, _ = ha._multipliers(comps)
    out: dict = {}
    for name, comp in comps.items():
        m = mult.get(name, 0.0)
        for ins in comp.instrs.values():
            if m <= 0 or ins.op not in ("dot", "convolution"):
                continue
            shapes = [comp.instrs[o].shape.split("{")[0] for o in ins.operands[:2]
                      if o in comp.instrs]
            key = f"{ins.op} {' x '.join(shapes)} -> {ins.shape.split('{')[0]}"
            out[key] = out.get(key, 0.0) + m * ha._dot_flops(comp, ins)
    return out


def _cells(archs, shape_names) -> list[tuple[str, str, str]]:
    """``(arch id, config name, cell)`` of every applicable cell."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config  # noqa: PLC0415
    from repro_torch.launch import shapes  # noqa: PLC0415

    out = []
    for a in archs:
        cfg = get_config(a)
        for s in shape_names:
            if shapes.cell_applicable(cfg, s)[0]:
                out.append((a, cfg.name, s))
    return out


def _run_reference(arch: str, shape: str, multi_pod: bool, out_dir: str, dots: int
                   ) -> tuple[int, str]:
    cmd = [sys.executable, __file__, "--reference-cell", arch, shape, "--ref-out", out_dir,
           "--dots", str(dots)]
    if multi_pod:
        cmd.append("--multipod")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
    return proc.returncode, (proc.stdout + proc.stderr)[-2000:]


def _count(rec: dict) -> int:
    return sum(v["count"] for v in rec.get("collectives", {}).values())


def _read(path: Path) -> dict | None:
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def compare(ref: dict | None, port: dict | None) -> dict:
    """One cell's row: both FLOPs a rank, their ratio, both useful ratios and
    both collective counts (None where a side has no ``ok`` record)."""
    ok = lambda r: r is not None and r.get("status") == "ok"  # noqa: E731
    row = {"ref_status": ref and ref.get("status"), "port_status": port and port.get("status")}
    for side, rec in (("ref", ref), ("port", port)):
        row[f"{side}_flops"] = rec["flops_per_device"] if ok(rec) else None
        row[f"{side}_useful"] = rec["useful_flop_ratio"] if ok(rec) else None
        row[f"{side}_collectives"] = _count(rec) if ok(rec) else None
    row["ratio"] = (row["port_flops"] / row["ref_flops"]
                    if ok(ref) and ok(port) and row["ref_flops"] else None)
    row["within_bound"] = row["ratio"] is not None and row["ratio"] <= BOUND
    row["below"] = row["ratio"] is not None and row["ratio"] < LOW
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--jobs", type=int, default=1, help="reference cells run side by side")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--dots", type=int, default=0,
                    help="keep and print each side's N largest products")
    ap.add_argument("--ref-out", default="results/dryrun_ref")
    ap.add_argument("--port-out", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/dryrun_parity")
    ap.add_argument("--reference-cell", nargs=2, metavar=("ARCH", "SHAPE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _, _, mesh_name = MESHES[args.multipod]

    if args.reference_cell:
        arch, shape = args.reference_cell
        rec = reference_cell(arch, shape, args.multipod, os.path.join(args.ref_out, mesh_name),
                             dots=args.dots)
        print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "status",
                                                  "flops_per_device", "compile_s")}))
        return 0 if rec.get("status") in ("ok", "skip") else 1

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS  # noqa: PLC0415
    from repro_torch.launch import shapes  # noqa: PLC0415

    cells = _cells(args.arch or ARCH_IDS, args.shape or list(shapes.SHAPES))
    ref_dir = ROOT / args.ref_out / mesh_name
    port_dir = ROOT / args.port_out / mesh_name

    todo = [c for c in cells
            if not (args.skip_existing and (ref_dir / f"{c[1]}__{c[2]}.json").exists())]

    def run(c):
        rc, tail = _run_reference(c[0], c[2], args.multipod, str(ROOT / args.ref_out), args.dots)
        print(f"[repro] {c[1]} × {c[2]} × {mesh_name}: rc {rc}", flush=True)
        if rc:
            print(tail, flush=True)

    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        list(pool.map(run, todo))

    rows = []
    print(f"{'arch':28s} {'cell':12s} {'repro flops':>12s} {'port flops':>12s} {'ratio':>7s} "
          f"{'useful r/p':>15s} {'coll r/p':>13s}")
    for _, name, shape in cells:
        ref, port = (_read(d / f"{name}__{shape}.json") for d in (ref_dir, port_dir))
        row = {"arch": name, "shape": shape, "mesh": mesh_name, **compare(ref, port)}
        rows.append(row)
        fmt = lambda v, f: format(v, f) if v is not None else "-"  # noqa: E731
        print(f"{name:28s} {shape:12s} {fmt(row['ref_flops'], '12.4e')} "
              f"{fmt(row['port_flops'], '12.4e')} {fmt(row['ratio'], '7.3f')} "
              f"{fmt(row['ref_useful'], '.4f'):>7s}/{fmt(row['port_useful'], '.4f'):7s} "
              f"{fmt(row['ref_collectives'], 'd'):>6s}/{fmt(row['port_collectives'], 'd'):6s}"
              + ("" if row["within_bound"] else "  <-- above the bound or missing")
              + (f"  <-- below {LOW}" if row["below"] else ""),
              flush=True)
        for side, rec in (("repro", ref), ("port", port)) if args.dots else ():
            for label, flops in (rec or {}).get("top_flops", [])[:args.dots]:
                print(f"    {side:5s} {flops:10.3e}  {label}")
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{mesh_name}.json", "w") as f:
        json.dump({"bound": BOUND, "low": LOW, "cells": rows}, f, indent=1)
    above = [r for r in rows if not r["within_bound"]]
    below = [r for r in rows if r["below"]]
    print(f"{len(rows) - len(above)} of {len(rows)} cells within {BOUND} × repro's FLOPs a rank; "
          f"{len(below)} below {LOW}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
