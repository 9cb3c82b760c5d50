"""The port's dry run against ``repro``'s: a rank's work on the same cell.

``scripts/dryrun_parity.py`` sets the two dry runs side by side on the
production meshes; these tests do it in small.  One JAX child runs
``repro.launch.dryrun.run_cell`` on a fake (4, 4) mesh of forced host
devices with ``AxisType.Auto`` axes (``dryrun_parity.reference_cell``), and
child processes that are rank 0 of a fake process group of 16 ranks run
``repro_torch.launch.dryrun.measure`` on a (4, 4) ``DeviceMesh``, all side
by side, for four smoke-config cells:

- ``glu_train``: ``internlm2_1_8b``'s train step (a GLU FFN);
- ``xlstm_model_train``: ``xlstm_350m``'s train step in ``tp_mode="model"``
  (2 heads, which the 4 ``model`` ranks do not divide: the mLSTM's blocked
  form as a region, the dry run's ``xlstm-350m × train_4k`` on 2 × 16 × 16);
- ``decode_batch1``: ``gemma3_1b``'s decode step at a batch of 1;
- ``expert_train``: ``arctic_480b``'s train step (experts).

Each asserts that the port's rank does at most 1.10 × ``repro``'s FLOPs
(XLA's HLO through ``hlo_analysis.analyze``; the port's ``OpCounter``), and
the three train cells, whose layouts agree with ``repro``'s at this size,
at least 0.90 × (the script's flag for a layout that departs downward;
measured 1.08, 1.02 and 1.05; the batch-1 decode 0.89).  The
reference's records also keep their four largest products (the script's
``--dots``).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
BOUND = 1.10
LOW = 0.90

CASES = {
    "glu_train": ("internlm2_1_8b", {}, {"kind": "train", "seq": 32, "batch": 8}),
    "xlstm_model_train": ("xlstm_350m", {"tp_mode": "model", "microbatches": 2},
                          {"kind": "train", "seq": 32, "batch": 8}),
    "decode_batch1": ("gemma3_1b", {}, {"kind": "decode", "seq": 64, "batch": 1}),
    "expert_train": ("arctic_480b", {}, {"kind": "train", "seq": 32, "batch": 8}),
}

_REF = r"""
import dataclasses, json, sys, tempfile
sys.path.insert(0, {scripts!r})
import dryrun_parity
from repro.configs import get_smoke_config
out = {{}}
for name, (arch, over, cell) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    rec = dryrun_parity.reference_cell(arch, "parity_" + name, False, tempfile.mkdtemp(),
                                       cfg=cfg, cell=cell, mesh_shape=(4, 4),
                                       axes=("data", "model"), dots=4)
    out[name] = {{"status": rec["status"], "flops": rec.get("flops_per_device"),
                  "top": rec.get("top_flops")}}
print(json.dumps(out))
"""

_PORT = r"""
import dataclasses, json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
torch.set_num_threads(1)
dryrun.fake_world(16)
mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=("data", "model"))
out = {}
for name, (arch, over, cell) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    try:
        rec = dryrun.measure(cfg, cell, mesh)
        out[name] = {"status": rec["status"], "flops": rec["flops_per_device"]}
    except Exception as e:  # noqa: BLE001 - a cell that fails is recorded
        out[name] = {"status": "error", "error": f"{type(e).__name__}: {e}"[:500]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    ref = [sys.executable, "-c", _REF.format(scripts=os.path.join(ROOT, "scripts")),
           json.dumps(CASES)]
    # the port's cells in two children, beside the reference's
    halves = [dict(list(CASES.items())[i::2]) for i in range(2)]
    procs = [subprocess.Popen(ref, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _PORT, json.dumps(h)], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for h in halves]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return {"ref": outs[0], "port": {**outs[1], **outs[2]}}


@pytest.mark.parametrize("case", list(CASES))
def test_port_rank_does_at_most_repro_work(counts, case):
    ref, port = counts["ref"][case], counts["port"][case]
    assert ref["status"] == "ok", ref
    assert port["status"] == "ok", port
    assert port["flops"] <= BOUND * ref["flops"], (case, port["flops"] / ref["flops"])


@pytest.mark.parametrize("case", ["glu_train", "xlstm_model_train", "expert_train"])
def test_port_rank_keeps_repro_layout(counts, case):
    ref, port = counts["ref"][case], counts["port"][case]
    assert port["flops"] >= LOW * ref["flops"], (case, port["flops"] / ref["flops"])


def test_reference_keeps_its_largest_products(counts):
    """``dots``: the reference record keeps its largest products, XLA's dot
    shapes with their FLOPs, in descending order and within the total."""
    for case, ref in counts["ref"].items():
        top = ref["top"]
        assert len(top) == 4, (case, top)
        assert all(label.startswith(("dot ", "convolution ")) and " -> " in label
                   for label, _ in top), top
        flops = [f for _, f in top]
        assert flops == sorted(flops, reverse=True) and flops[-1] > 0, top
        assert sum(flops) <= ref["flops"] * (1 + 1e-9), (case, sum(flops), ref["flops"])


def test_compare_row():
    """The script's row: both counts, the ratio, the bound, and the flag
    for a ratio below 0.90."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import dryrun_parity

    rec = {"status": "ok", "flops_per_device": 2.0, "useful_flop_ratio": 0.5,
           "collectives": {"all-reduce": {"count": 3, "bytes": 8.0},
                           "all-gather": {"count": 2, "bytes": 4.0}}}
    row = dryrun_parity.compare(rec, dict(rec, flops_per_device=2.3))
    assert row["ratio"] == pytest.approx(1.15) and not row["within_bound"] and not row["below"]
    assert row["ref_collectives"] == row["port_collectives"] == 5
    row = dryrun_parity.compare(rec, dict(rec, flops_per_device=1.7))
    assert row["ratio"] == pytest.approx(0.85) and row["within_bound"] and row["below"]
    row = dryrun_parity.compare(rec, dict(rec, flops_per_device=1.8))
    assert row["within_bound"] and not row["below"]
    row = dryrun_parity.compare(rec, {"status": "error"})
    assert row["ratio"] is None and not row["within_bound"] and not row["below"]
