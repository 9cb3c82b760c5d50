"""Logical-axis → mesh sharding rules: the port of ``repro.distributed.sharding``.

Parameters carry logical axis names (``models/layers.py`` ``ParamDef.axes``);
this module maps them to partition specs for a mesh, with ``repro``'s
divisibility-aware fallback (an axis that does not divide the dimension is
dropped rather than padded: kv_heads = 1 never shards over model = 16; the KV
cache shards its *sequence* dimension instead, split-KV decoding), and turns a
spec into the DTensor placements of a ``DeviceMesh``.

A mesh is anything with ``axis_names`` and ``shape`` (a name → size mapping):
:class:`AbstractMesh`, which needs no devices and no process group (the spec
arithmetic of the 256- and 512-chip meshes), or a ``DeviceMesh``, read through
its ``mesh_dim_names`` and ``shape``.  ``repro``'s ``shard_map_compat`` and its
``abstract_mesh`` shim answer to JAX's API drift and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s meaning: one entry per tensor
    dimension, each ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dimension split over those axes, major to minor); a tuple of
    one name is that name, as JAX normalizes it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def abstract_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int]) -> AbstractMesh:
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def axis_names(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """Axis name → size."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def default_rules(mesh, tp: bool = True) -> dict:
    """logical axis -> tuple of mesh axes (in preference order).

    ``tp=False`` (tp_mode="dp"): the model axis joins the fsdp group."""
    fsdp = fsdp_axes(mesh)
    if not tp:
        full = fsdp + ("model",)
        return {
            "vocab": (), "embed": full, "heads": (), "kv_heads": (),
            "mlp": (), "experts": (), "rnn": (), "layers": (),
            "batch": full, "seq": (), None: (),
        }
    return {
        "vocab": ("model",),
        "embed": fsdp,  # FSDP: shard weight embed dim across data(+pod)
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "rnn": ("model",),
        "layers": (),  # scan axis never sharded
        "batch": fsdp,
        "seq": ("model",),
        None: (),
    }


def _axis_size(mesh, names: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names)


def _entry(axes: tuple):
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def spec_for(shape: tuple, axes: tuple, mesh, rules: Optional[dict] = None) -> P:
    """The spec of one array, honoring divisibility and the
    at-most-once-per-mesh-axis constraint; trailing ``None`` entries dropped."""
    rules = rules or default_rules(mesh)
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        cand = rules.get(logical, ())
        chosen = ()
        # try the full tuple first, then each single axis
        options = [cand] + [tuple(a for a in cand if a == x) for x in cand]
        for opt in options:
            opt = tuple(a for a in opt if a not in used)
            if opt and dim % _axis_size(mesh, opt) == 0:
                chosen = opt
                break
        used.update(chosen)
        parts.append(_entry(chosen))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def tree_specs(axes_tree, shapes_tree, mesh, rules: Optional[dict] = None):
    """Spec tree from (logical axes, shapes) trees of one structure (nested
    dicts and lists); a shape leaf is anything with ``shape``."""
    if isinstance(axes_tree, dict):
        return {k: tree_specs(axes_tree[k], shapes_tree[k], mesh, rules) for k in axes_tree}
    if isinstance(axes_tree, list):
        return [tree_specs(a, s, mesh, rules) for a, s in zip(axes_tree, shapes_tree)]
    return spec_for(tuple(shapes_tree.shape), axes_tree, mesh, rules)


def batch_spec(mesh, batch: Optional[int] = None) -> P:
    axes = fsdp_axes(mesh)
    if batch is not None and batch % _axis_size(mesh, axes) != 0:
        return P()
    return P(axes)


def div_spec(mesh, shape: tuple, *parts) -> P:
    """Spec with non-divisible axes dropped."""
    out = []
    for dim, p in zip(shape, parts):
        if p is None:
            out.append(None)
            continue
        axes = p if isinstance(p, tuple) else (p,)
        out.append(p if dim % _axis_size(mesh, axes) == 0 else None)
    return P(*out)


def cache_spec(shape: tuple, kind: str, mesh) -> P:
    """Sharding for decode caches.

    Attention KV (B, S, KVH, Dh): batch→fsdp when divisible; kv_heads→model
    when divisible, else seq→model (split-KV decode); with batch=1 the seq
    dim absorbs the fsdp axes too (sequence parallelism for long_500k).
    Recurrent states (B, ...): batch→fsdp; the last dim→model when divisible.
    """
    fsdp = fsdp_axes(mesh)
    model = mesh_shape(mesh)["model"]
    used: set = set()
    if kind == "kv" and len(shape) == 4:
        b, s, kvh, _ = shape
        parts: list = [None, None, None, None]
        if b % _axis_size(mesh, fsdp) == 0:
            parts[0] = _entry(fsdp)
            used.update(fsdp)
        if kvh % model == 0:
            parts[2] = "model"
            used.add("model")
        seq_axes = tuple(a for a in (*fsdp, "model") if a not in used)
        if seq_axes and s % _axis_size(mesh, seq_axes) == 0:
            parts[1] = _entry(seq_axes)
        return P(*parts)
    parts = [None] * len(shape)
    if shape and shape[0] % _axis_size(mesh, fsdp) == 0:
        parts[0] = _entry(fsdp)
    if len(shape) > 1 and shape[-1] % model == 0:
        parts[-1] = "model"
    return P(*parts)


def placements(spec, mesh) -> tuple:
    """The spec as DTensor placements, one for each mesh dimension: a
    dimension split over axes ``(a, b)`` is ``Shard(d)`` on both.  DTensor
    splits a dimension sharded on several mesh dimensions in mesh-dimension
    order, which is the spec's major-to-minor order only when the axes follow
    the mesh's; so they must (every spec of ``repro``'s rules does).  An
    axis of size 1 splits nothing and is ``Replicate()`` (DTensor refuses to
    reshape a dimension it holds as sharded, even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def tree_placements(specs_tree, mesh):
    """Placements tree from a spec tree (``repro``'s ``tree_shardings``)."""
    if isinstance(specs_tree, dict):
        return {k: tree_placements(v, mesh) for k, v in specs_tree.items()}
    if isinstance(specs_tree, list):
        return [tree_placements(v, mesh) for v in specs_tree]
    return placements(specs_tree, mesh)


def spec_of(placements_, mesh) -> P:
    """The spec of DTensor placements (the inverse of :func:`placements`)."""
    names = axis_names(mesh)
    per_dim: dict = {}
    for i, pl in enumerate(placements_):
        if pl.is_shard():
            per_dim.setdefault(pl.dim, []).append(names[i])
    ndim = max(per_dim, default=-1) + 1
    return P(*(_entry(tuple(per_dim.get(d, ()))) for d in range(ndim)))
