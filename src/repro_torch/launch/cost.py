"""What one rank runs: FLOPs, bytes and collectives, counted op by op.

The port's counterpart of ``repro.launch.hlo_analysis``.  ``repro`` compiles
a step and re-derives its cost from the HLO, multiplying each while loop's
body by its trip count.  The port runs its steps eagerly, so
:class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op the rank
runs, each loop iteration and each recomputed checkpoint included, and
counts it into an :class:`OpCost`:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), on the rank's local tensors only.  An op on
  DTensors is returned to DTensor (``NotImplemented``), which runs it as
  local ops on each rank's shards; the counter counts those.  DTensor's
  sharding propagation also runs each op once on fake tensors of the global
  shapes, to learn its output's shape; that is not the rank's work, and the
  counter counts nothing while the propagation runs.  Without a fake mode
  only real tensors count; under the dry run's fake mode only its fake
  tensors (the arithmetic that DTensor does on real index tensors beside
  them is host work).
- **Bytes**: every op that is not a view or a metadata op reads its operands
  and writes its results, each counted once, as eager PyTorch does without
  fusion.  An indexed read (``index``, ``index_select``, ``gather``,
  ``embedding``) is charged the rows it reads, not its whole source, and an
  indexed write (``index_put_``, ``scatter*``, ``index_add_``) the rows it
  writes.  Collectives are counted apart, not as bytes.
- **Collectives**: every collective the rank issues, functional (DTensor's
  redistributions, ``to_local``'s backward) or not (``dist.all_reduce``),
  by kind with its count and the bytes of its result on this rank, as
  ``repro`` counts them; ``wire_bytes`` applies ``repro``'s ring factors
  (all-reduce 2, the others 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_c10d = torch.ops.c10d
_func = torch.ops._c10d_functional
_func_ag = torch.ops._c10d_functional_autograd

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# ring factors: an all-reduce moves its bytes twice (reduce-scatter, then
# all-gather)
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# each collective op: (kind, where its result is: "out" the op's output,
# an int the argument it writes in place)
_COLLECTIVE_OPS = {
    _func.all_reduce.default: ("all-reduce", "out"),
    _func.all_reduce_.default: ("all-reduce", 0),
    _func.all_reduce_coalesced.default: ("all-reduce", "out"),
    _func.all_reduce_coalesced_.default: ("all-reduce", 0),
    _func.all_gather_into_tensor.default: ("all-gather", "out"),
    _func.all_gather_into_tensor_out.default: ("all-gather", "out"),
    _func.all_gather_into_tensor_coalesced.default: ("all-gather", "out"),
    _func_ag.all_gather_into_tensor.default: ("all-gather", "out"),
    _func.reduce_scatter_tensor.default: ("reduce-scatter", "out"),
    _func.reduce_scatter_tensor_coalesced.default: ("reduce-scatter", "out"),
    _func_ag.reduce_scatter_tensor.default: ("reduce-scatter", "out"),
    _func.all_to_all_single.default: ("all-to-all", "out"),
    _func_ag.all_to_all_single.default: ("all-to-all", "out"),
    torch.ops._dtensor.shard_dim_alltoall.default: ("all-to-all", "out"),
    _func.broadcast.default: ("collective-permute", "out"),
    _func.broadcast_.default: ("collective-permute", 0),
    _c10d.allreduce_.default: ("all-reduce", 0),
    _c10d.allgather_.default: ("all-gather", 0),
    _c10d._allgather_base_.default: ("all-gather", 0),
    _c10d.reduce_scatter_.default: ("reduce-scatter", 0),
    _c10d._reduce_scatter_base_.default: ("reduce-scatter", 0),
    _c10d.alltoall_.default: ("all-to-all", 0),
    _c10d.alltoall_base_.default: ("all-to-all", 0),
    _c10d.broadcast_.default: ("collective-permute", 0),
    _c10d.send.default: ("collective-permute", 0),
    _c10d.recv_.default: ("collective-permute", 0),
}

# ops that move no data: views, allocations without a write, metadata,
# waits on a collective already counted
_FREE_OPS = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten._unsafe_view.default, aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default, aten.new_empty_strided.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
    aten._local_scalar_dense.default, _func.wait_tensor.default, torch.ops.prim.device.default,
}

# indexed reads (the source is argument 0) and writes (the destination is
# argument 0, the rows written are the last tensor argument)
_GATHERS = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
            aten.embedding.default}
_SCATTERS = {aten.index_put_.default, aten.index_put.default, aten._index_put_impl_.default,
             aten.scatter_.src, aten.scatter.src, aten.scatter_add_.default,
             aten.scatter_add.default, aten.index_add_.default, aten.index_add.default,
             aten.index_copy_.default, aten.index_copy.default}


@dataclasses.dataclass
class OpCost:
    """A rank's counts; ``hlo_analysis.HloCost``'s fields without its loop
    count (eager runs each iteration; there is nothing to multiply)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: Dict[str, dict] = dataclasses.field(
        default_factory=lambda: {c: {"count": 0, "bytes": 0.0} for c in COLLECTIVES})
    # FLOPs by op and operand shapes ("aten.mm (4096, 2048) (2048, 512)")
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def top_flops(self, n: int) -> list:
        """The ``n`` op shapes with the most FLOPs: ``[name, flops]``."""
        return sorted(([k, v] for k, v in self.flops_by_op.items()), key=lambda kv: -kv[1])[:n]

    @property
    def wire_bytes(self) -> float:
        return sum(v["bytes"] * WIRE_FACTOR[k] for k, v in self.collectives.items())


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether an aten op has a composite (decomposable) kernel."""
    if func not in _COMPOSITE:
        has = torch._C._dispatch_has_kernel_for_dispatch_key
        _COMPOSITE[func] = func.namespace == "aten" and has(func.name(),
                                                            "CompositeImplicitAutograd")
    return _COMPOSITE[func]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the ops a rank runs into :attr:`cost`.  ``fake_mode``: the dry
    run's ``FakeTensorMode``, whose tensors then stand for the rank's own
    (without one, real tensors do).  DTensor's shape propagation, which
    runs while an op is dispatched, is not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.cost = OpCost()
        self._propagating = 0
        self._depth = 0
        self._unwrap = None

    def __enter__(self):
        if self._unwrap is None:  # DTensor's shape propagation, marked while counting
            from torch.distributed.tensor._sharding_prop import (  # noqa: PLC0415
                ShardingPropagator)

            orig = ShardingPropagator._propagate_tensor_meta_non_cached

            def marked(prop, op_schema):
                self._propagating += 1
                try:
                    return orig(prop, op_schema)
                finally:
                    self._propagating -= 1

            ShardingPropagator._propagate_tensor_meta_non_cached = marked

            def unwrap():
                ShardingPropagator._propagate_tensor_meta_non_cached = orig

            self._unwrap = unwrap
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._unwrap()
                self._unwrap = None

    def _ours(self, t: torch.Tensor) -> bool:
        if self.fake_mode is None:
            return not isinstance(t, FakeTensor) and t.device.type != "meta"
        return (isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                and t.fake_device.type != "meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._propagating:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        flat_in = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        packet = func._overloadpacket
        if packet not in flop_registry and _composite(func):
            # a composite op the counter's formulas do not name: count its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not all(self._ours(t) for t in flat_in):
            return out
        flat_out = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not all(self._ours(t) for t in flat_out):
            return out
        if func in _COLLECTIVE_OPS:
            kind, where = _COLLECTIVE_OPS[func]
            res = flat_out if where == "out" else tree_leaves(args[where])
            entry = self.cost.collectives[kind]
            entry["count"] += 1
            entry["bytes"] += float(sum(_nbytes(t) for t in res if isinstance(t, torch.Tensor)))
            return out
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            key = " ".join([str(packet)] + [str(tuple(t.shape)) for t in flat_in])
            self.cost.flops += flops
            self.cost.flops_by_op[key] = self.cost.flops_by_op.get(key, 0.0) + flops
        if func.is_view or func in _FREE_OPS:
            return out
        self.cost.bytes_accessed += float(self._bytes(func, flat_in, flat_out))
        return out

    @staticmethod
    def _bytes(func, flat_in, flat_out) -> int:
        ins = [_nbytes(t) for t in flat_in]
        outs = [_nbytes(t) for t in flat_out]
        if func in _GATHERS and flat_in and flat_out:
            # the source is read only where indexed: as many of its elements
            # as the result holds
            ins[0] = min(ins[0], flat_out[0].numel() * flat_in[0].element_size())
        elif func in _SCATTERS and flat_in:
            rows = min(ins[0], _nbytes(flat_in[-1]) if len(flat_in) > 1 else ins[0])
            ins[0] = rows
            outs = [min(o, rows) for o in outs]
        return sum(ins) + sum(outs)
