"""Train, prefill and serve steps: ``repro.train.train_step``.

``make_train_step`` builds the ``(model, opt_state, step, batch) ->
(opt_state, step, metrics)`` step: the loss's gradient by autograd, summed in
f32 over ``cfg.microbatches`` slices of the batch, then ``opt_update``;
``make_prefill`` the last-position logits of a full forward;
``make_serve_step`` the one-token decode with the cache updated in place.

Without a mesh each step runs on ``device`` (``cuda`` unless the caller asks
for the CPU) and moves the batch there; the model and its state must already
live there.  With a ``DeviceMesh`` (``launch.mesh``) the model, its optimizer
state and the decode cache are DTensors placed by ``repro``'s specs
(:func:`shard_model`, ``optimizer.opt_init`` on the placed parameters,
:func:`shard_cache`); each step places the batch by :func:`batch_specs` and
runs under the activation rules.  ``compressed`` on a mesh with a ``pod``
axis reduces the gradients over the pods as int8 with a per-tensor scale
(:func:`_podwise_compressed_grads`); on any other mesh it is the plain step,
as in ``repro``.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.graph.csr import resolve_device
from repro_torch.models import blocks
from repro_torch.models import model as m
from repro_torch.models.layers import activation_mesh, from_local
from repro_torch.train import optimizer as opt


def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _device(device) -> torch.device:
    """The step's device; a bare ``cuda`` is pinned to the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_device(mesh) -> torch.device:
    return _device(mesh.device_type)


def _check_model(model: m.DecoderLM, cfg: ModelConfig, dev: torch.device, mesh=None) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is {model.cfg.name}")
    on_mesh = isinstance(model.embed, DTensor)
    if mesh is not None and not (on_mesh and model.embed.device_mesh == mesh):
        raise ValueError("the step runs on a mesh: place the model with shard_model(model, mesh)")
    if mesh is None and on_mesh:
        raise ValueError("the model is placed on a mesh: build the step with that mesh")
    if model.embed.device != dev:
        raise ValueError(f"step runs on {dev}, model is on {model.embed.device}")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _rules(cfg: ModelConfig, mesh) -> dict:
    return shd.default_rules(mesh, tp=cfg.tp_mode != "dp")


def activation_rules(cfg: ModelConfig, mesh) -> dict:
    if cfg.tp_mode == "dp":
        return {"batch": shd.fsdp_axes(mesh) + ("model",), "model": ()}
    return {}


def batch_specs(cfg: ModelConfig, mesh, global_batch: int | None = None) -> dict:
    axes = shd.fsdp_axes(mesh)
    if cfg.tp_mode == "dp":
        axes = axes + ("model",)
    if global_batch is not None:
        # drop trailing axes until the batch divides (e.g. batch 256 in dp
        # mode on 512 chips keeps ("pod","data") and leaves model replicated)
        sizes = shd.mesh_shape(mesh)
        while axes and global_batch % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
    bspec = shd.P(axes) if axes else shd.P()
    specs = {"tokens": bspec, "labels": bspec}
    if cfg.frontend != "none":
        specs["frontend_emb"] = bspec
    return specs


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """Each parameter's spec, keyed by name."""
    axes = m.param_logical_axes(cfg)
    shapes = m.abstract_params(cfg)
    rules = _rules(cfg, mesh)
    return {n: shd.spec_for(tuple(shapes[n].shape), axes[n], mesh, rules) for n in axes}


def _cache_spec(name: str, shape: tuple, mesh):
    return shd.cache_spec(shape, "kv" if name in ("k", "v") else "state", mesh)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh) -> dict:
    """Spec tree of the decode cache (``models.init_cache``'s structure; one
    entry a layer, no scan axis)."""
    shapes = m.abstract_cache(cfg, batch, max_len)
    return {"layers": [{n: _cache_spec(n, tuple(t.shape), mesh) for n, t in layer.items()}
                       for layer in shapes["layers"]],
            "index": shd.P()}


# ---------------------------------------------------------------------------
# placing models, state, caches and batches on a mesh
# ---------------------------------------------------------------------------


def _distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor of ``spec``:
    each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(t, mesh, shd.placements(spec, mesh), src_data_rank=None)


@torch.no_grad()
def shard_model(model: m.DecoderLM, mesh) -> m.DecoderLM:
    """Place ``model``'s parameters on ``mesh`` by :func:`param_specs`, in
    place; every rank must hold the same weights (one seed).  Returns it."""
    specs = param_specs(model.cfg, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(
            _distribute(p.detach().to(_mesh_device(mesh)), mesh, specs[name]))
    return model


def shard_tree(tree, specs, mesh):
    """A tree of whole tensors (the same on every rank) placed by a spec tree
    of the same structure; other leaves kept."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return _distribute(tree.to(_mesh_device(mesh)), mesh, specs)
    return tree


def shard_cache(cache: dict, mesh) -> dict:
    """A decode cache (``models.init_cache``) placed by :func:`cache_specs`."""
    specs = [{n: _cache_spec(n, tuple(t.shape), mesh) for n, t in layer.items()}
             for layer in cache["layers"]]
    return dict(cache, layers=shard_tree(cache["layers"], specs, mesh))


def batch_rows(mesh, spec) -> tuple[int, int]:
    """This rank's (index, count) along the batch spec's axes: the share of
    each batch it reads.  Ranks that differ only along other axes read the
    same rows."""
    axes = spec[0] if len(spec) else ()
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = shd.axis_names(mesh)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        i = names.index(a)
        index = index * mesh.size(i) + coord[i]
        count *= mesh.size(i)
    return index, count


def place_batch(batch: dict, mesh, specs: dict, *, local: bool = False) -> dict:
    """The batch as DTensors by ``specs``.  ``local=False``: each value is the
    whole batch, the same on every rank; ``local=True``: each rank's own rows
    (:func:`batch_rows`), in rank order."""
    dev = _mesh_device(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        t = torch.as_tensor(v).to(dev)
        if local:
            pl = shd.placements(specs[k], mesh)
            shape = (t.shape[0] * batch_rows(mesh, specs[k])[1],) + tuple(t.shape[1:])
            out[k] = from_local(t.contiguous(), mesh, pl, shape)
        else:
            out[k] = _distribute(t, mesh, specs[k])
    return out


def _whole(v: torch.Tensor) -> torch.Tensor:
    return v.full_tensor() if isinstance(v, DTensor) else v


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _runner(cfg: ModelConfig, mesh, device, specs: dict):
    """Where a step runs: ``(device, place, scope)``.  Without a mesh the
    batch is moved to ``device`` and the scope does nothing; on a mesh the
    batch is placed by ``specs`` and the scope sets the activation rules."""
    if mesh is None:
        dev = _device(device)
        return dev, (lambda batch: _on(batch, dev)), contextlib.nullcontext
    rules = activation_rules(cfg, mesh)
    return (_mesh_device(mesh), (lambda batch: place_batch(batch, mesh, specs)),
            (lambda: activation_mesh(mesh, rules)))


def _microbatch(v: torch.Tensor, i: int, mb: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mb``: the ``i``-th slice of a tensor's rows; of
    a DTensor, the ``i``-th slice of each rank's own rows, so a sharded
    batch is never gathered (the microbatches then hold other rows than the
    one-process step's, and together the same batch)."""
    if not isinstance(v, DTensor):
        per = v.shape[0] // mb
        return v[i * per:(i + 1) * per]
    local = v.to_local()
    per = local.shape[0] // mb
    return from_local(local[i * per:(i + 1) * per], v.device_mesh, v.placements,
                      (v.shape[0] // mb,) + tuple(v.shape[1:]))


def _pin(grads: dict, params: dict) -> dict:
    """Each gradient in its parameter's layout (a partial sum over the batch
    slices reduced into the parameter's shards)."""
    return {n: g if tuple(g.placements) == tuple(params[n].placements)
            else g.redistribute(params[n].device_mesh, params[n].placements)
            for n, g in grads.items()}


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig, mesh=None, *, device="cuda",
                    compressed: bool = False, global_batch: int | None = None):
    """Returns ``step_fn(model, opt_state, step, batch) -> (opt_state, step + 1,
    metrics)``: the model's parameters and ``opt_state`` are updated in place;
    ``metrics`` holds ``loss``, ``grad_norm`` (0-d device tensors) and
    ``step``.  ``batch`` = ``{tokens, labels[, frontend_emb]}``: on a mesh
    the whole batch on every rank, or DTensors (:func:`place_batch`)."""
    group, pods = 1, False
    bspecs = None
    if mesh is not None:
        bspecs = batch_specs(cfg, mesh, global_batch)
        axes = bspecs["tokens"][0] if len(bspecs["tokens"]) else ()
        sizes = shd.mesh_shape(mesh)
        group = math.prod(sizes[a] for a in (axes if isinstance(axes, tuple) else (axes,)))
        pods = compressed and "pod" in shd.axis_names(mesh)
    dev, place, scope = _runner(cfg, mesh, device, bspecs)

    def grads_of(model, params, batch):
        if pods:
            return _podwise_compressed_grads(model, params, cfg, batch, mesh)
        loss = m.loss_fn(model, batch["tokens"], batch["labels"], batch.get("frontend_emb"))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        return loss.detach(), grads if mesh is None else _pin(grads, params)

    def step_fn(model, opt_state, step: int, batch: dict):
        _check_model(model, cfg, dev, mesh)
        batch = place(batch)
        params = dict(model.named_parameters())
        mb = cfg.microbatches
        with scope():
            if mb > 1:
                b = batch["tokens"].shape[0]
                if b % mb:
                    raise ValueError(f"batch {b} does not split into {mb} microbatches "
                                     f"({cfg.name})")
                per = b // mb
                # a microbatch the batch-sharding group does not divide would
                # replicate compute on every rank: refuse it, as repro does
                if per % group:
                    raise ValueError(f"microbatch {per} not divisible by batch-sharding group "
                                     f"{group} — would replicate compute ({cfg.name})")
                # gradient accumulation in f32: activations scale 1/mb
                gsum = {n: opt.state_zeros(p) for n, p in params.items()}
                lsum = None
                for i in range(mb):
                    loss, grads = grads_of(model, params,
                                           {k: _microbatch(v, i, mb) for k, v in batch.items()})
                    for n, g in grads.items():
                        gsum[n] += g
                    lsum = loss if lsum is None else lsum + loss
                grads = {n: g / mb for n, g in gsum.items()}
                loss = lsum / mb
            else:
                loss, grads = grads_of(model, params, batch)
            opt_state, gnorm = opt.opt_update(ocfg, grads, opt_state, params, step,
                                              model.update_groups())
        return opt_state, step + 1, {"loss": _whole(loss), "grad_norm": _whole(gnorm),
                                     "step": step + 1}

    return step_fn


@contextlib.contextmanager
def _swapped(model: m.DecoderLM, new: dict):
    """``model`` with its parameters replaced by ``new`` (name → tensor)
    for the block."""
    old = {}
    for name, t in new.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        old[name] = (mod, leaf, mod._parameters[leaf])
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in old.values():
            mod._parameters[leaf] = p


def _podwise_compressed_grads(model, params: dict, cfg: ModelConfig, batch: dict, mesh):
    """Per-pod gradients on the ``("data", "model")`` sub-mesh (each pod its
    slice of the batch, the weights whole over the pods), each leaf
    quantized to int8 with a per-tensor scale ``max|g| / 127``, ``q ·
    scale`` summed in f32 over the pod group and divided by the pod count;
    the loss averaged over the pods.  Stateless, as ``repro``'s."""
    names = shd.axis_names(mesh)
    inner = mesh["data", "model"]
    pod = names.index("pod")
    pod_group = mesh["pod"].get_group()
    npods = mesh.size(pod)

    def to_pod(t: DTensor) -> DTensor:
        """``t`` whole over the pods, as a DTensor of the pod's sub-mesh."""
        pl = list(t.placements)
        pl[pod] = Replicate()
        t = t.redistribute(mesh, pl)
        return from_local(t.to_local(), inner, pl[:pod] + pl[pod + 1:], tuple(t.shape))

    def pod_rows(t: DTensor) -> DTensor:
        """This pod's slice of a batch tensor (its shard along ``pod``), as
        a DTensor of the pod's sub-mesh; nothing is sent."""
        pl, shape = list(t.placements), list(t.shape)
        if pl[pod].is_shard():
            shape[pl[pod].dim] //= npods
        return from_local(t.to_local(), inner, pl[:pod] + pl[pod + 1:], tuple(shape))

    sub = {n: to_pod(p.detach()).requires_grad_() for n, p in params.items()}
    pod_batch = {k: pod_rows(v) for k, v in batch.items()}
    with _swapped(model, sub), activation_mesh(inner, activation_rules(cfg, inner)):
        loss = m.loss_fn(model, pod_batch["tokens"], pod_batch["labels"],
                         pod_batch.get("frontend_emb"))
        grads = torch.autograd.grad(loss, list(sub.values()))

    out = {}
    for (n, p), g in zip(params.items(), grads):
        g = g.redistribute(inner, sub[n].placements)
        scale = torch.clamp(torch.amax(torch.abs(g)).full_tensor(), min=1e-8) / 127.0
        q = torch.clamp(torch.round(g.to_local() / scale), -127, 127).to(torch.int8)
        summed = q.float() * scale
        dist.all_reduce(summed, group=pod_group)
        local = (summed / npods).to(g.dtype)
        pl = list(g.placements)
        pl.insert(pod, Replicate())
        out[n] = from_local(local, mesh, pl, tuple(g.shape)).redistribute(mesh, p.placements)
    loss = loss.full_tensor()
    dist.all_reduce(loss, group=pod_group)
    return loss / npods, out


def make_prefill(cfg: ModelConfig, mesh=None, *, device="cuda"):
    """Prefill: ``prefill(model, batch) -> (B, V)``, the last position's
    logits of a full forward.  Only that position goes through the head, so
    the (B, S, V) logits never materialize.  On a mesh the logits are a
    DTensor, batch on the FSDP axes and vocabulary on ``model`` where they
    divide."""
    bspecs = None if mesh is None else batch_specs(cfg, mesh)
    dev, place, scope = _runner(cfg, mesh, device, bspecs)

    @torch.no_grad()
    def prefill(model, batch):
        _check_model(model, cfg, dev, mesh)
        with scope():
            batch = place({k: v for k, v in batch.items() if k != "labels"})
            x, _ = m.forward_hidden(model, batch["tokens"], batch.get("frontend_emb"))
            logits = m.logits_of(model, x[:, -1:])[:, 0]
        if mesh is None:
            return logits
        spec = shd.div_spec(mesh, tuple(logits.shape), shd.fsdp_axes(mesh), "model")
        return logits.redistribute(mesh, shd.placements(spec, mesh))

    return prefill


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int, mesh=None, *, device="cuda"):
    """One-token decode: ``serve(model, cache, tokens) -> (logits (B, 1, V),
    cache)`` on a cache from ``models.init_cache(cfg, batch, max_len)``,
    updated in place; on a mesh the cache placed by :func:`shard_cache` and
    the tokens the whole (B, 1) batch."""
    tok_spec = None if mesh is None else shd.batch_spec(mesh, batch)
    dev, place, scope = _runner(cfg, mesh, device, {"tokens": tok_spec})

    def check(model, cache, tokens):
        _check_model(model, cfg, dev, mesh)
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"serve step takes tokens ({batch}, 1), got {tuple(tokens.shape)}")
        for kind, c in zip(cfg.layer_kinds(), cache["layers"]):
            rows = next(iter(c.values())).shape[0]
            if rows != batch or ("k" in c and c["k"].shape[1]
                                 != blocks.cache_len(cfg, kind, max_len)):
                raise ValueError(f"serve step takes a cache of {batch} × {max_len} tokens")

    @torch.no_grad()
    def serve(model, cache, tokens):
        check(model, cache, tokens if isinstance(tokens, DTensor) else torch.as_tensor(tokens))
        with scope():
            logits, cache = m.decode_step(model, place({"tokens": tokens})["tokens"], cache)
        if mesh is None:
            return logits, cache
        # the new recurrent states back in the cache's layout
        cache["layers"] = [
            {n: t.redistribute(mesh, shd.placements(_cache_spec(n, tuple(t.shape), mesh), mesh))
             for n, t in layer.items()} for layer in cache["layers"]]
        spec = shd.div_spec(mesh, tuple(logits.shape), tok_spec[0] if len(tok_spec) else None,
                            None, "model")
        return logits.redistribute(mesh, shd.placements(spec, mesh)), cache

    return serve
