"""Base layers: parameter definitions, norms, RoPE, causal conv, softcap.

The port of ``repro.models.layers``.  A model's parameters come from
``ParamDef`` specs, as in ``repro``: one source of truth for the shapes, the
initializers and the weight layouts (``wq`` is ``(d, heads, head_dim)`` and
applied by einsum), so that a ``repro`` parameter tree maps one to one onto
the port's modules (``models.convert``).

On a device mesh the parameters and activations are DTensors, and
``repro``'s sharding helpers become placements: ``ashard`` redistributes an
activation, and its gradient (:func:`grad_in`), to the layout ``repro``'s
constraint names, ``rp_einsum`` reduces a product's partial sums where the
product is, in its ``reduce_dtype``, as XLA places them, and
:func:`const` / :func:`mesh_full` make the tensors a layer builds for itself
(positions, masks, pads, accumulators) DTensors too.  Every one of them is
the identity on a plain tensor, so without a mesh a layer computes what it
computes on one device, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` / ``param_dtype`` string."""
    return DTYPES[name]


@dataclasses.dataclass(frozen=True, init=False)
class ParamDef:
    """A parameter's shape and initializer (the fields), and ``axes``: its
    logical axis names, one per dim (None = replicated), read by the
    sharding rules; its layout, not part of its value's recipe."""

    shape: tuple
    init: str = "normal"  # normal | zeros | ones | lru_lambda
    scale: float = 1.0

    def __init__(self, shape: tuple, axes: tuple = (), init: str = "normal",
                 scale: float = 1.0):
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "init", init)
        object.__setattr__(self, "scale", scale)
        object.__setattr__(self, "axes", tuple(axes))


def _tree_map(fn, defs):
    if isinstance(defs, dict):
        return {k: _tree_map(fn, v) for k, v in defs.items()}
    if isinstance(defs, list):
        return [_tree_map(fn, v) for v in defs]
    return fn(defs)


def shape_tree(defs, dtype: torch.dtype):
    """Meta tensors of the defs' shapes in ``dtype`` (no allocation)."""
    return _tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def axes_tree(defs):
    """Logical-axes tree matching the defs' structure."""
    return _tree_map(lambda d: d.axes, defs)


@torch.no_grad()
def init_param(p: torch.Tensor, d: ParamDef, gen: torch.Generator) -> None:
    """Fill ``p`` as ``repro``'s ``init_param`` draws it (the same
    distributions; the bits come from ``gen``, not from ``jax.random``)."""
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    elif d.init == "lru_lambda":
        # RG-LRU: Λ init so a = sigmoid(Λ)^(8c) spreads in [0.9, 0.999]
        u = torch.empty(d.shape, dtype=torch.float32, device=p.device)
        u.uniform_(0.9, 0.999, generator=gen)
        r = u ** (1 / 8.0)
        p.copy_(torch.log(r / (1 - r)))
    else:
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        std = d.scale / np.sqrt(fan_in)
        w = torch.empty(d.shape, dtype=torch.float32, device=p.device)
        w.normal_(0.0, 1.0, generator=gen)
        p.copy_(w * std)


class ParamTree(nn.Module):
    """A nested dict of ``ParamDef`` as a module: a parameter per leaf, a
    submodule per dict, a ``ModuleList`` per list, under the defs' names.
    :meth:`tree` gives the parameters back as the nested dict the layer
    functions take."""

    def __init__(self, defs: dict, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self._defs = {}
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self._defs[name] = d
                self.register_parameter(
                    name, nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device)))
            elif isinstance(d, dict):
                self.add_module(name, ParamTree(d, dtype, device))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x, dtype, device) for x in d))

    def tree(self) -> dict:
        out: dict = {name: getattr(self, name) for name in self._defs}
        for name, mod in self.named_children():
            if isinstance(mod, nn.ModuleList):
                out[name] = [m.tree() for m in mod]
            else:
                out[name] = mod.tree()
        return out

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        """Initialize every parameter, in registration order, from ``gen``."""
        for name, d in self._defs.items():
            init_param(getattr(self, name), d, gen)
        for mod in self.children():
            for m in (mod if isinstance(mod, nn.ModuleList) else (mod,)):
                m.init_from(gen)


# ---------------------------------------------------------------------------
# the activation mesh
# ---------------------------------------------------------------------------

# Set by the step builders' steps for the length of a call; None (one
# device) makes ashard and model_divides no-ops.
_ACTIVATION_MESH = None
# logical "batch"/"model" remapped per arch ({"batch": fsdp + ("model",),
# "model": ()} under tp_mode="dp")
_ACTIVATION_RULES: dict = {}


def set_activation_mesh(mesh, rules: dict | None = None) -> None:
    global _ACTIVATION_MESH, _ACTIVATION_RULES
    _ACTIVATION_MESH = mesh
    _ACTIVATION_RULES = rules or {}


@contextlib.contextmanager
def activation_mesh(mesh, rules: dict | None = None):
    """:func:`set_activation_mesh` for the block, the previous one restored
    after it."""
    old = (_ACTIVATION_MESH, _ACTIVATION_RULES)
    set_activation_mesh(mesh, rules)
    try:
        yield
    finally:
        set_activation_mesh(*old)


# mesh dimensions a decode step leaves idle (``model.decode_step``): each
# product splits its contraction over those that neither operand splits
_IDLE_AXES: tuple = ()


@contextlib.contextmanager
def idle_axes(names: tuple):
    """:func:`rp_einsum` splits a product's contraction over the mesh
    dimensions ``names`` wherever neither operand splits it, for the block:
    GSPMD's placement of a decode step (:func:`idle`)."""
    global _IDLE_AXES
    old, _IDLE_AXES = _IDLE_AXES, tuple(names)
    try:
        yield
    finally:
        _IDLE_AXES = old


def idle() -> tuple:
    """The mesh dimensions that the enclosing :func:`idle_axes` names."""
    return _IDLE_AXES


def activation_spec(shape: tuple, logical: tuple) -> tuple:
    """``repro``'s ``ashard`` layout of a tensor of ``shape`` under the
    activation mesh: a spec entry per dimension ("batch" → the fsdp axes,
    "model" → the model axis; dimensions they do not divide stay whole)."""
    from repro_torch.distributed.sharding import axis_names, mesh_shape  # noqa: PLC0415

    mesh = _ACTIVATION_MESH
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    default = {"batch": fsdp, "model": ("model",) if "model" in names else ()}
    parts: list = []
    used: set = set()
    for dim, name in zip(shape, logical):
        cand = _ACTIVATION_RULES.get(name, default.get(name, ()))
        cand = tuple(a for a in cand if a in names and a not in used)
        size = 1
        for a in cand:
            size *= sizes[a]
        if cand and dim % size == 0:
            parts.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            parts.append(None)
    return tuple(parts)


def activation_placements(shape: tuple, *logical) -> tuple:
    from repro_torch.distributed.sharding import placements  # noqa: PLC0415

    return placements(activation_spec(shape, logical), _ACTIVATION_MESH)


class _GradIn(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to
    ``placements``: the transpose of a sharding constraint constrains the
    cotangent to the same layout."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_in(x: torch.Tensor, placements=None) -> torch.Tensor:
    """``x``, its gradient redistributed to ``placements`` (by default
    ``x``'s own, partial sums reduced) before it flows on into the backward
    of what made ``x``.  XLA reduces a product's partial sums where the
    product is; DTensor carries them lazily, and a backward product on a
    partial gradient runs on gathered weights.  The identity on a plain
    tensor, without a gradient and on a mesh of one."""
    if (not isinstance(x, DTensor) or not x.requires_grad or not torch.is_grad_enabled()
            or x.device_mesh.size() == 1):
        return x
    if placements is None:
        placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return _GradIn.apply(x, tuple(placements))


def ashard(x: torch.Tensor, *logical) -> torch.Tensor:
    """``repro``'s activation sharding constraint from logical axis names
    ("batch", "model", None): ``x`` redistributed to that layout, and its
    gradient too, as ``with_sharding_constraint`` constrains the cotangent
    (DTensor would otherwise carry a gradient's partial sums on through the
    backward, into products it then runs on gathered weights).  The
    identity without an activation mesh and on a plain tensor."""
    if _ACTIVATION_MESH is None or not isinstance(x, DTensor):
        return x
    want = activation_placements(tuple(x.shape), *logical)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return grad_in(x, want)


def model_divides(n: int) -> bool:
    """True iff the active mesh's model axis evenly shards a dim of size n."""
    from repro_torch.distributed.sharding import axis_names, mesh_shape  # noqa: PLC0415

    mesh = _ACTIVATION_MESH
    if mesh is None:
        return False
    if "model" in _ACTIVATION_RULES and not _ACTIVATION_RULES["model"]:
        return False  # tp_mode="dp": model axis remapped to data parallelism
    return "model" in axis_names(mesh) and n % mesh_shape(mesh)["model"] == 0


def from_local(t: torch.Tensor, mesh, placements, shape: tuple) -> DTensor:
    """A DTensor of global ``shape`` (contiguous) from each rank's local
    ``t`` in ``placements``; nothing is sent."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=stride)


def local_span(t: DTensor, dim: int) -> tuple[int, int]:
    """``(offset, length)`` of this rank's shard of ``t`` along ``dim``, by
    arithmetic on the mesh coordinate: DTensor splits a dimension in
    ``torch.chunk``'s pieces, once for each mesh dimension that shards it,
    in mesh-dimension order.  Unlike DTensor's own offsets it reads no
    tensor, so it also holds under ``FakeTensorMode``."""
    return shard_span(t.device_mesh, t.placements, dim, t.shape[dim])


def shard_span(mesh, placements, dim: int, n: int) -> tuple[int, int]:
    """:func:`local_span` of a dimension of size ``n`` in ``placements``."""
    coord = mesh.get_coordinate()
    lo = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-n // mesh.size(i))
            start = min(coord[i] * chunk, n)
            lo, n = lo + start, min(n, start + chunk) - start
    return lo, n


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` in a layout that a reshape of dimension ``dim`` into ``(outer,
    -1)`` keeps: a DTensor that splits ``dim`` over a number of ranks that
    does not divide ``outer`` gets ``dim`` whole first (DTensor refuses such
    a reshape).  The identity otherwise, and on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    ranks = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            ranks *= mesh.size(i)
    if outer % ranks == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p for p in x.placements])


def const(like: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor a layer computes for itself from no activation
    (positions, frequencies, masks), replicated over ``like``'s mesh when
    ``like`` is a DTensor: GSPMD's layout for a constant."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def mesh_full(like: torch.Tensor, shape: tuple, value, dtype: torch.dtype,
              *logical) -> torch.Tensor:
    """``torch.full(shape, value)`` on ``like``'s device; when ``like`` is a
    DTensor, a DTensor in the layout ``ashard(·, *logical)`` names, or in
    ``like``'s own placements without ``logical`` (an accumulator or a pad
    made in place, sharded as the activation it joins)."""
    if not isinstance(like, DTensor):
        return torch.full(shape, value, dtype=dtype, device=like.device)
    from torch.distributed.tensor import full  # noqa: PLC0415

    mesh = like.device_mesh
    if not logical:
        pl = like.placements
    elif _ACTIVATION_MESH is None:
        pl = [Replicate()] * mesh.ndim
    else:
        pl = activation_placements(tuple(shape), *logical)
    return full(shape, value, dtype=dtype, device_mesh=mesh, placements=pl)


def local_rows(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a ``fn`` that keeps ``x``'s shape and works along
    dimensions ``x`` holds whole (elementwise, or a scan along time): on a
    DTensor, ``fn`` of each rank's shard, in ``x``'s layout."""
    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    return DTensor.from_local(fn(x.to_local()), mesh, pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def _contraction_split(spec: str, x: torch.Tensor) -> bool:
    """Whether ``x`` is split over more than one rank along a dimension the
    einsum ``spec`` contracts (its product is then partial sums)."""
    if not isinstance(x, DTensor):
        return False
    ins, out = spec.split("->")
    xs = ins.split(",")[0]
    mesh = x.device_mesh
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and mesh.size(i) > 1 and xs[pl.dim] not in out:
            return True
    return False


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``: the
    operands' products accumulated and returned in f32.  bf16 operands are
    widened first, which is exact (run with TF32 off, an f32 product of two
    widened bf16 values is exact too)."""
    return torch.einsum(spec, a.float(), b.float())


def _strided_rows(spec: str, x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor whose rows are split in strides (the
    sequence of sequence-block attention's output: each rank's share of
    every query chunk) along dimensions the einsum keeps in place, and ``w``
    is whole on every rank.  DTensor's own einsum fails on such rows: it
    flattens them into one dimension, and its view rules lose the stride."""
    from torch.distributed.tensor.placement_types import _StridedShard  # noqa: PLC0415

    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return False
    if not any(isinstance(p, _StridedShard) for p in x.placements):
        return False
    xs, out = spec.split("->")[0].split(",")[0], spec.split("->")[1]
    for p in x.placements:
        if p.is_partial():
            return False
        dim = getattr(p, "dim", None)
        if dim is not None and (xs[dim] not in out or out.index(xs[dim]) != dim):
            return False
    return all(p.is_replicate() for p in w.placements)


def _einsum_rows(spec: str, x: DTensor, w: DTensor) -> DTensor:
    """``einsum(spec, x, w)`` on each rank's own rows of ``x``
    (:func:`_strided_rows`), in ``x``'s layout; ``w``'s gradient is partial
    over the ranks that hold other rows."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    mesh = x.device_mesh
    rows = [i for i, p in enumerate(x.placements) if not p.is_replicate()]
    wl = w.to_local(grad_placements=[Partial() if i in rows else Replicate()
                                     for i in range(mesh.ndim)])
    y = torch.einsum(spec, x.to_local(), wl)
    sizes = dict(zip(xs, x.shape)) | dict(zip(ws, w.shape))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(y, mesh, x.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _align(spec: str, x: DTensor, w: DTensor) -> tuple:
    """``x`` and ``w`` laid out so that ``x`` splits each contracted
    dimension as ``w`` does where ``x`` is whole on that mesh dimension (a
    local slice: a weight kept in its FSDP shards turns the product into
    partial sums, as GSPMD places it), and both split a contracted dimension
    (the first the mesh dimension divides) over the mesh dimensions that
    :func:`idle` names and neither splits yet."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    if "." in xs or "." in ws:
        return x, w
    mesh = x.device_mesh
    xp, wp = list(x.placements), list(w.placements)
    shared = [c for c in xs if c in ws and c not in out]
    names = mesh.mesh_dim_names or ()
    for i in range(mesh.ndim):
        if mesh.size(i) == 1 or not xp[i].is_replicate():
            continue
        if wp[i].is_shard() and ws[wp[i].dim] in shared:
            xp[i] = Shard(xs.index(ws[wp[i].dim]))
        elif wp[i].is_replicate() and names and names[i] in _IDLE_AXES:
            for c in shared:
                if _local_size(x, xs.index(c), xp) % mesh.size(i) == 0:
                    xp[i], wp[i] = Shard(xs.index(c)), Shard(ws.index(c))
                    break
    if xp != list(x.placements):
        x = x.redistribute(mesh, xp)
    if wp != list(w.placements):
        w = w.redistribute(mesh, wp)
    return x, w


def _local_size(x: DTensor, dim: int, placements) -> int:
    """The extent of ``x``'s dimension ``dim`` on a rank under
    ``placements``, where the splits divide it."""
    n = x.shape[dim]
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            n //= x.device_mesh.size(i)
    return n


def rp_einsum(spec: str, x: torch.Tensor, w: torch.Tensor, reduce_dtype: str = "f32"
              ) -> torch.Tensor:
    """A product with a weight whose contraction may be split over ranks: a
    row-parallel product (the contraction on ``model``), one whose weight
    stays in its FSDP shards, or one split over the mesh dimensions a decode
    step leaves idle (:func:`_align`).  Its
    partial sums are reduced where it is, in ``reduce_dtype`` ("f32": the
    partials in f32, the sum cast back to ``x``'s dtype; "bf16": the bf16
    products' partials).  Where no rank holds a partial sum (one device, or
    the contraction whole on each rank), ``torch.einsum``."""
    if _strided_rows(spec, x, w):
        return _einsum_rows(spec, x, w)
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        # an operand's partial sums reduced before the product: a product on
        # partial sums keeps them, against whole weights
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        x, w = _align(spec, x, w)
    if not _contraction_split(spec, x):
        return grad_in(torch.einsum(spec, x, w))
    if reduce_dtype == "bf16" or x.dtype == torch.float32:
        y = torch.einsum(spec, x, w)
    else:
        y = einsum_f32(spec, x, w)
    pl = [Replicate() if p.is_partial() else p for p in y.placements]
    return grad_in(y.redistribute(y.device_mesh, pl).to(x.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as ``repro``'s: in f32 for an f32 ``x``; for a bf16 ``x`` the
    variance accumulated in f32 and the normalization in bf16."""
    if x.dtype == torch.float32:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        xn = x * torch.rsqrt(var + eps)
        return xn * (1.0 + scale.float())
    d = x.shape[-1]
    var = einsum_f32("...d,...d->...", x, x) / d
    r = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return (x * r) * (1.0 + scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., S, H, Dh), positions: (..., S).  The
    frequencies and angles are f32, as ``repro``'s."""
    dh = x.shape[-1]
    half = dh // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = const(x, torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), expo))
    ang = const(x, positions)[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x: (B, S, C), w: (C, K).

    Returns (y, new_state) where state holds the last K-1 inputs for decode.
    """
    k = w.shape[-1]
    if state is None:
        pad = mesh_full(x, x.shape[:-2] + (k - 1, x.shape[-1]), 0, x.dtype)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)  # (B, S+K-1, C)
    y = sum(xp[..., i : i + x.shape[-2], :] * w[:, i] for i in range(k))
    new_state = xp[..., -(k - 1) :, :] if k > 1 else pad
    return y.to(x.dtype), new_state


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "gelu": _gelu,
    "silu": F.silu,
    "relu": F.relu,
    "geglu": _gelu,  # gating handled by the FFN structure
    "swiglu": F.silu,
}
