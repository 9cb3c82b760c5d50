"""The port's dry run (``repro_torch.launch.{shapes,cost,dryrun}``).

``shapes.py``'s cells and specs against ``repro.launch.shapes`` for the ten
full configs; :class:`~repro_torch.launch.cost.OpCounter` on the five cases
of ``tests/test_hlo_analysis.py`` and on a checkpointed step; the layout
helpers that the production meshes needed, on 4 gloo ranks
(``torch_mesh_child.fake_safe_layouts``); then, in one
child process that is rank 0 of a fake process group of 4 ranks (the pytest
worker starts no process group), the rank's FLOPs of ``internlm2_1_8b``'s
smoke train step on four meshes against the plain step's
``FlopCounterMode`` count, one small cell of each kind through
``dryrun.measure``, the vocabulary-split lookup under ``FakeTensorMode``
and seven ``all_reduce``s.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs import ARCH_IDS, get_config as ref_get_config  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch.cost import OpCounter  # noqa: E402
from repro_torch.models.layers import local_span  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def test_cells_equal_repro():
    assert shapes.SHAPES == ref_shapes.SHAPES
    assert shapes.LONG_OK == ref_shapes.LONG_OK


@pytest.mark.parametrize("cell", list(ref_shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_repro(arch, cell):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    ref = ref_shapes.input_specs(ref_cfg, cell)
    mine = shapes.input_specs(cfg, cell)
    assert list(mine) == list(ref)
    for k, spec in ref.items():
        assert mine[k].shape == tuple(spec.shape), k
        assert str(mine[k].dtype).removeprefix("torch.") == str(spec.dtype), k
    assert shapes.cell_applicable(cfg, cell) == ref_shapes.cell_applicable(ref_cfg, cell)


def test_fake_input_allocates_nothing():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    mode = FakeTensorMode()
    t = shapes.fake_input(shapes.TensorSpec((256, 4096), torch.int32), mode)
    assert isinstance(t, FakeTensor) and t.fake_mode is mode
    assert tuple(t.shape) == (256, 4096) and t.dtype == torch.int32


# ---------------------------------------------------------------------------
# the op counter (tests/test_hlo_analysis.py's cases)
# ---------------------------------------------------------------------------


def test_loop_free_product_counts_exactly():
    x, w = torch.randn(256, 512), torch.randn(512, 128)
    with OpCounter() as c:
        x @ w
    assert c.cost.flops == 2 * 256 * 512 * 128
    assert c.cost.bytes_accessed == (256 * 512 + 512 * 128 + 256 * 128) * 4


def test_loop_counts_each_iteration():
    c0, w = torch.randn(256, 512), torch.randn(512, 512)
    with OpCounter() as c:
        for _ in range(10):
            c0 = torch.tanh(c0 @ w)
    assert c.cost.flops == 2 * 256 * 512 * 512 * 10


def test_nested_loops_compose():
    x, w = torch.randn(64, 128), torch.randn(128, 128)
    with OpCounter() as c:
        for _ in range(3):
            for _ in range(4):
                x = x @ w
    assert c.cost.flops == 2 * 64 * 128 * 128 * 12


def test_stack_read_a_slice_a_step_is_charged_once():
    """A (16, 4, 32) stack read a slice a step over 16 steps is charged its
    bytes once, not 16 times: a slice is a view, and each step reads only
    its own rows."""
    stack = torch.randn(16, 4, 32)
    with OpCounter() as c:
        outs = [torch.tanh(stack[i]) for i in range(16)]
    stack_bytes, slice_bytes = 16 * 4 * 32 * 4, 4 * 32 * 4
    assert len(outs) == 16
    assert c.cost.bytes_accessed == stack_bytes + 16 * slice_bytes


def test_indexed_read_is_charged_its_rows():
    table, ids = torch.randn(1000, 64), torch.tensor([3, 7, 3, 999])
    with OpCounter() as c:
        table[ids]
    assert c.cost.bytes_accessed == 4 * 64 * 4 + 4 * 8 + 4 * 64 * 4


@pytest.mark.parametrize("remat", [False, True])
def test_remat_counts_its_recompute(remat):
    """A checkpointed layer runs its forward again in backward, and the
    counter sees it: 4 products where the plain layer's backward makes 3."""
    x = torch.randn(64, 128, requires_grad=True)
    w = torch.randn(128, 96, requires_grad=True)

    def layer(x, w):
        return torch.tanh(x @ w)

    with OpCounter() as c:
        y = checkpoint(layer, x, w, use_reentrant=False) if remat else layer(x, w)
        y.sum().backward()
    assert c.cost.flops == (4 if remat else 3) * 2 * 64 * 128 * 96


# ---------------------------------------------------------------------------
# the shard arithmetic that replaced DTensor's offsets, and the layouts
# the production meshes needed
# ---------------------------------------------------------------------------


class _Mesh:
    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, i):
        return self.shape[i]


class _Tensor:
    def __init__(self, shape, mesh, placements):
        self.shape, self.device_mesh, self.placements = shape, mesh, placements


@pytest.mark.parametrize("placements", [
    (Shard(0), Replicate()), (Replicate(), Shard(0)), (Shard(0), Shard(0)),
    (Shard(1), Shard(0)), (Shard(0), Shard(1))])
@pytest.mark.parametrize("shape", [(92544, 64), (10, 7), (3, 5)])
def test_local_span_equals_dtensor_offsets(shape, placements):
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    mesh_shape = (4, 3)
    for coord in [(i, j) for i in range(4) for j in range(3)]:
        t = _Tensor(shape, _Mesh(mesh_shape, coord), placements)
        local, offset = _compute_local_shape_and_global_offset(shape, mesh_shape, list(coord),
                                                               placements)
        for dim in range(2):
            lo, n = local_span(t, dim)
            assert n == local[dim], (coord, dim)
            if n:
                assert lo == offset[dim], (coord, dim)


def test_layouts_on_gloo_ranks():
    """The layout helpers the production meshes needed keep real values on 4
    gloo ranks (``torch_mesh_child.fake_safe_layouts``)."""
    import torch_mesh_child

    res = torch_mesh_child.run("fake_safe_layouts", 4)
    assert res["strided"]  # the rows really are split in strides
    assert res["y_err"] < 1e-5 and res["dw_err"] < 1e-5
    assert res["q_err"] == 0.0
    for mine, dtensor in res["spans"]:
        assert [s for s in mine if s[1]] == [s for s in dtensor if s[1]]


def test_run_cell_records_a_skipped_cell(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("internlm2_1_8b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skip" and rec["mesh"] == "pod16x16"
    assert rec["skip_reason"] == ref_shapes.cell_applicable(
        ref_get_config("internlm2_1_8b"), "long_500k")[1]
    with open(tmp_path / "internlm2-1.8b__long_500k.json") as f:
        assert json.load(f) == rec


# ---------------------------------------------------------------------------
# a fake process group of 4 ranks, in a child process
# ---------------------------------------------------------------------------

_CHILD = r"""
import json
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.cost import OpCounter
from repro_torch.models import model as m
from repro_torch.train import optimizer as opt, train_step as ts

torch.set_num_threads(1)
res = {}
arch = "internlm2_1_8b"
cfg = get_smoke_config(arch)
ocfg = opt.OptConfig(kind=cfg.optimizer)
gen = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=gen, dtype=torch.int32)
         for k in ("tokens", "labels")}
model = m.DecoderLM(cfg, device="cpu")
state = opt.opt_init(ocfg, dict(model.named_parameters()))
with FlopCounterMode(display=False) as fc:
    ts.make_train_step(cfg, ocfg, device="cpu")(model, state, 0, batch)
res["plain_flops"] = fc.get_total_flops()

dryrun.fake_world(4)
cells = {"train": {"kind": "train", "seq": 32, "batch": 8},
         "prefill": {"kind": "prefill", "seq": 32, "batch": 8},
         "decode": {"kind": "decode", "seq": 32, "batch": 8}}
res["flops"] = {}
for shape in [(1, 1), (4, 1), (2, 2), (1, 4)]:
    n = shape[0] * shape[1]
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
    res["flops"][str(shape)] = dryrun.measure(cfg, cells["train"], mesh)["flops_per_device"]

mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))


def local_bytes(tree):
    # from each DTensor's global shape and placements, not its local tensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        shape, _ = compute_local_shape_and_global_offset(tree.shape, mesh, tree.placements)
        return int(torch.Size(shape).numel()) * tree.element_size()
    return 0


res["cells"] = {}
for kind in cells:
    rec = dryrun.measure(cfg, cells[kind], mesh)
    with dryrun.fake_dtensor():
        _, args = dryrun._build(cfg, cells[kind], mesh, FakeTensorMode())
    rec["expected_argument_bytes"] = local_bytes(args)
    res["cells"][kind] = rec

# the vocabulary-split lookup under FakeTensorMode
fake = FakeTensorMode()
with fake:
    table = distribute_tensor(torch.empty(cfg.vocab_size, cfg.d_model), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
    tokens = distribute_tensor(torch.zeros(8, 32, dtype=torch.int32), mesh,
                               [Shard(0), Replicate()], src_data_rank=None)
    rows = m._lookup(table, tokens)
res["lookup"] = {"dtensor": isinstance(rows, DTensor), "shape": list(rows.shape),
                 "local": list(rows.to_local().shape)}

with OpCounter() as counter:
    t = torch.ones(8, 128)
    for _ in range(7):
        dist.all_reduce(t)
res["all_reduce"] = {"collectives": counter.cost.collectives, "wire": counter.cost.wire_bytes}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def fake_group():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_plain_step_flops(fake_group):
    # the smoke config's train step at 8 × 32 tokens, one process
    assert fake_group["plain_flops"] == 189_792_256


def test_rank_flops_on_a_mesh_of_one_equal_the_plain_step(fake_group):
    assert fake_group["flops"]["(1, 1)"] == fake_group["plain_flops"]


def test_rank_flops_split_over_data_are_a_quarter(fake_group):
    assert fake_group["flops"]["(4, 1)"] * 4 == fake_group["plain_flops"]


@pytest.mark.parametrize("shape", ["(2, 2)", "(1, 4)"])
def test_rank_flops_with_model_parallel_are_local(fake_group, shape):
    """Each rank counts its own ops: all four together do at least the plain
    step's work (a replicated part is done on every rank), one alone at most
    all of it.  ``FlopCounterMode`` over DTensors read 139,460,608 here on
    every mesh, fewer than the plain step."""
    flops = fake_group["flops"][shape]
    assert flops * 4 >= fake_group["plain_flops"]
    assert flops <= fake_group["plain_flops"]


_KEYS = ("status", "chips", "trace_s", "peak_memory_bytes",
         "argument_bytes", "output_bytes", "temp_bytes", "fits_hbm", "flops_per_device",
         "bytes_per_device", "collectives", "wire_bytes_per_device", "roofline", "dominant",
         "model_flops", "useful_flop_ratio", "tokens")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_on_a_fake_group(fake_group, kind):
    rec = fake_group["cells"][kind]
    assert rec["status"] == "ok"
    assert all(k in rec for k in _KEYS)
    assert rec["chips"] == 4
    assert rec["argument_bytes"] == rec["expected_argument_bytes"]
    assert rec["peak_memory_bytes"] >= rec["argument_bytes"] > 0
    assert rec["temp_bytes"] == rec["peak_memory_bytes"] - rec["argument_bytes"]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["wire_bytes_per_device"] > 0 and rec["collectives"]
    assert rec["dominant"] == max(rec["roofline"], key=rec["roofline"].get)
    assert rec["useful_flop_ratio"] > 0


def test_lookup_under_fake_tensors(fake_group):
    """The vocabulary split over ``model``: DTensor's own offsets read a fake
    tensor on the host and raised; the lookup's rows are a DTensor of the
    global shape."""
    look = fake_group["lookup"]
    assert look["dtensor"]
    assert look["shape"] == [8, 32, 64]
    assert look["local"] == [4, 32, 64]


def test_collectives_counted_a_call(fake_group):
    ar = fake_group["all_reduce"]
    assert ar["collectives"]["all-reduce"] == {"count": 7, "bytes": 7 * 8 * 128 * 4}
    assert ar["wire"] == 2 * 7 * 8 * 128 * 4  # ring factor 2
