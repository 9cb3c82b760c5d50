"""The port's sharding rules against ``repro``'s, with no process group.

``tests/test_sharding.py``'s cases run on the port's functions; then, for
each of the ten full configs on the 16 × 16 and 2 × 16 × 16 production
meshes, in both ``tp_mode``s, the port's parameter, optimizer-state, batch
and decode-cache specs equal ``repro``'s.  Both sides' meshes are abstract
(names and sizes, no devices).  A port parameter is one layer of a stacked
``repro`` leaf, whose spec has a leading ``layers`` entry (never sharded);
specs are compared as tuples with trailing ``None`` entries trimmed.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.configs import ARCH_IDS, get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_step as ref_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P, abstract_mesh, cache_spec, default_rules, placements, spec_for, spec_of, tree_placements,
    tree_specs)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402
from repro_torch.train.fault import largest_mesh_shape  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "multipod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module")
def mesh():
    return abstract_mesh(("data", "model"), (16, 16))


def _trim(spec) -> tuple:
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


# ---------------------------------------------------------------------------
# test_sharding.py's cases on the port
# ---------------------------------------------------------------------------


class TestSpecFor:
    def test_basic_2d(self, mesh):
        assert spec_for((2048, 8192), ("embed", "mlp"), mesh) == P("data", "model")

    def test_nondivisible_axis_dropped(self, mesh):
        assert spec_for((2048, 1, 128), ("embed", "kv_heads", None), mesh) == P("data")

    def test_axis_used_once(self, mesh):
        assert spec_for((4096, 4096), ("mlp", "rnn"), mesh) == P("model")

    def test_layers_never_sharded(self, mesh):
        s = spec_for((24, 2048, 8192), ("layers", "embed", "mlp"), mesh)
        assert s == P(None, "data", "model")


class TestCacheSpec:
    def test_kv_heads_preferred(self, mesh):
        assert cache_spec((128, 32768, 16, 256), "kv", mesh) == P("data", None, "model", None)

    def test_split_kv_when_heads_dont_divide(self, mesh):
        assert cache_spec((128, 32768, 8, 128), "kv", mesh) == P("data", "model", None, None)

    def test_long_context_batch1_shards_sequence_everywhere(self, mesh):
        s = cache_spec((1, 524288, 1, 256), "kv", mesh)
        assert s == P(None, ("data", "model"), None, None)

    def test_recurrent_state(self, mesh):
        assert cache_spec((128, 4096), "state", mesh) == P("data", "model")


def test_elastic_shrink_keeps_model_axis():
    assert largest_mesh_shape(512, 16) == (32, 16)
    assert largest_mesh_shape(511, 16) == (511, 1)
    assert largest_mesh_shape(508, 16) == (127, 4)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, need):
    """Without a process group of 256 (512) ranks the production mesh
    raises, naming the count; it starts no process group of its own."""
    with pytest.raises(RuntimeError, match=f"needs {need} ranks"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("tp", [True, False])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_default_rules_match(kind, tp):
    names, sizes = MESHES[kind]
    ours = default_rules(abstract_mesh(names, sizes), tp)
    ref = ref_shd.default_rules(ref_shd.abstract_mesh(names, sizes), tp)
    assert ours == ref


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


class TestPlacements:
    def test_one_axis_each(self):
        m = abstract_mesh(("data", "model"), (2, 4))
        assert placements(P("data", "model"), m) == (Shard(0), Shard(1))
        assert placements(P("model", "data"), m) == (Shard(1), Shard(0))

    def test_replicated(self):
        m = abstract_mesh(("data", "model"), (2, 4))
        assert placements(P(), m) == (Replicate(), Replicate())
        assert placements(P(None, "model"), m) == (Replicate(), Shard(1))

    def test_tuple_in_mesh_order(self):
        m = abstract_mesh(("pod", "data", "model"), (2, 4, 2))
        assert placements(P(("pod", "data"), "model"), m) == (Shard(0), Shard(0), Shard(1))
        assert placements(P(None, ("data", "model")), m) == (Replicate(), Shard(1), Shard(1))

    def test_tuple_out_of_mesh_order_raises(self):
        m = abstract_mesh(("pod", "data", "model"), (2, 4, 2))
        with pytest.raises(ValueError, match="order"):
            placements(P(("data", "pod")), m)

    def test_axis_twice_raises(self):
        m = abstract_mesh(("data", "model"), (2, 4))
        with pytest.raises(ValueError, match="twice"):
            placements(P("model", "model"), m)

    def test_axis_of_one_replicates(self):
        m = abstract_mesh(("data", "model"), (4, 1))
        assert placements(P("data", "model"), m) == (Shard(0), Replicate())

    def test_trees(self):
        """``tree_specs`` and ``tree_placements`` map nested dicts and
        lists leaf for leaf."""
        m = abstract_mesh(("data", "model"), (2, 4))
        axes = {"w": ("embed", "mlp"), "layers": [{"b": (None,)}, {"k": ("heads",)}]}
        shapes = {"w": torch.empty(8, 8, device="meta"),
                  "layers": [{"b": torch.empty(3, device="meta")},
                             {"k": torch.empty(6, device="meta")}]}
        specs = tree_specs(axes, shapes, m)
        assert specs == {"w": P("data", "model"), "layers": [{"b": P()}, {"k": P()}]}
        assert tree_placements(specs, m) == {
            "w": (Shard(0), Shard(1)),
            "layers": [{"b": (Replicate(), Replicate())}, {"k": (Replicate(), Replicate())}]}

    def test_spec_of_inverts(self):
        m = abstract_mesh(("pod", "data", "model"), (2, 4, 2))
        for spec in (P(("pod", "data"), "model"), P(None, "model"), P("model", None, "data")):
            assert _trim(spec_of(placements(spec, m), m)) == _trim(spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_name_the_model(arch):
    """``abstract_params`` and ``param_logical_axes`` are keyed by the
    model's parameter names, with its shapes (the smoke config's model)."""
    from repro_torch.configs import get_smoke_config  # noqa: PLC0415

    cfg = get_smoke_config(arch)
    model = tm.DecoderLM(cfg, device="cpu")
    shapes = tm.abstract_params(cfg)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in shapes.items()}
    axes = tm.param_logical_axes(cfg)
    assert list(axes) == list(shapes)
    assert all(len(axes[n]) == shapes[n].ndim for n in axes)


# ---------------------------------------------------------------------------
# the ten full configs against repro
# ---------------------------------------------------------------------------

CASES = [(a, k, tp) for a in ARCH_IDS for k in sorted(MESHES) for tp in ("model", "dp")]


def _configs(arch, kind, tp):
    names, sizes = MESHES[kind]
    ref_cfg = dataclasses.replace(ref_get_config(arch), tp_mode=tp)
    cfg = dataclasses.replace(get_config(arch), tp_mode=tp)
    return (ref_cfg, ref_shd.abstract_mesh(names, sizes)), (cfg, abstract_mesh(names, sizes))


def _leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _ref_layer(tree, cfg, i: int, path: list, stacked_prefix: int = 1):
    """``repro``'s leaf of the port's layer ``i`` at ``path``: a stacked
    ``blocks`` leaf with its leading entries dropped, or a ``tail`` leaf."""
    per = len(cfg.pattern)
    if i < cfg.n_rep * per:
        spec = _leaf(tree["blocks"][i % per], path)
        return _drop_leading(spec, stacked_prefix)
    return _leaf(tree["tail"][i - cfg.n_rep * per], path)


def _drop_leading(spec, n):
    if isinstance(spec, dict):
        return {k: _drop_leading(v, n) for k, v in spec.items()}
    parts = tuple(spec)
    assert all(p is None for p in parts[:n]), parts
    return parts[n:]


def _ref_param_leaf(tree, cfg, name):
    parts = name.split(".")
    if parts[0] == "layers":
        return _ref_layer(tree, cfg, int(parts[1]), parts[2:])
    return _leaf(tree, parts)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_match(arch):
    """Each parameter's logical axes are ``repro``'s leaf's, its stacked
    ``layers`` axis dropped."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref = ref_model.param_logical_axes(rcfg)
    per = len(rcfg.pattern)
    for name, axes in tm.param_logical_axes(cfg).items():
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) < rcfg.n_rep * per:
            want = _leaf(ref["blocks"][int(parts[1]) % per], parts[2:])
            assert want[0] == "layers", name
            want = want[1:]
        elif parts[0] == "layers":
            want = _leaf(ref["tail"][int(parts[1]) - rcfg.n_rep * per], parts[2:])
        else:
            want = _leaf(ref, parts)
        assert tuple(axes) == tuple(want), name


@pytest.mark.parametrize("arch,kind,tp", CASES)
def test_param_specs_match(arch, kind, tp):
    (rcfg, rmesh), (cfg, mesh) = _configs(arch, kind, tp)
    ref = ref_steps.param_specs(rcfg, rmesh)
    ours = tsteps.param_specs(cfg, mesh)
    assert list(ours) == list(tm.abstract_params(cfg))
    for name, spec in ours.items():
        assert _trim(spec) == _trim(_ref_param_leaf(ref, rcfg, name)), name


@pytest.mark.parametrize("arch,kind,tp", CASES)
def test_opt_state_specs_match(arch, kind, tp):
    (rcfg, rmesh), (cfg, mesh) = _configs(arch, kind, tp)
    rp = ref_steps.param_specs(rcfg, rmesh)
    pp = tsteps.param_specs(cfg, mesh)
    for opt_kind in ("adamw", "adafactor"):
        ref = ref_opt.opt_state_specs(ref_opt.OptConfig(kind=opt_kind), rp,
                                      ref_model.abstract_params(rcfg))
        ours = topt.opt_state_specs(topt.OptConfig(kind=opt_kind), pp, tm.abstract_params(cfg))
        assert set(ours) == set(ref)
        for part in ours:
            for name, spec in ours[part].items():
                want = _ref_param_leaf(ref[part], rcfg, name)
                if isinstance(spec, dict):
                    assert set(spec) == set(want), (opt_kind, name)
                    for k in spec:
                        assert _trim(spec[k]) == _trim(want[k]), (opt_kind, part, name, k)
                else:
                    assert _trim(spec) == _trim(want), (opt_kind, part, name)


@pytest.mark.parametrize("arch,kind,tp", CASES)
def test_batch_specs_match(arch, kind, tp):
    (rcfg, rmesh), (cfg, mesh) = _configs(arch, kind, tp)
    for global_batch in (256, 32, 128, 1, None):
        ref = ref_steps.batch_specs(rcfg, rmesh, global_batch)
        ours = tsteps.batch_specs(cfg, mesh, global_batch)
        assert set(ours) == set(ref)
        for k in ours:
            assert _trim(ours[k]) == _trim(ref[k]), (global_batch, k)


@pytest.mark.parametrize("arch,kind,tp", CASES)
def test_cache_specs_match(arch, kind, tp):
    (rcfg, rmesh), (cfg, mesh) = _configs(arch, kind, tp)
    for batch, max_len in ((128, 32768), (1, 524288)):
        ref = ref_steps.cache_specs(rcfg, batch, max_len, rmesh)
        ours = tsteps.cache_specs(cfg, batch, max_len, mesh)
        assert _trim(ours["index"]) == _trim(ref["index"])
        assert len(ours["layers"]) == cfg.num_layers
        for i, layer in enumerate(ours["layers"]):
            want = _ref_layer(ref, rcfg, i, [])
            assert set(layer) == set(want), i
            for k, spec in layer.items():
                assert _trim(spec) == _trim(want[k]), (batch, i, k)
