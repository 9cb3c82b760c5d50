"""Decoder LM: parameters, train forward, chunked loss, prefill and decode.

The port of ``repro.models.model`` as an ``nn.Module``.  ``repro`` stacks the
parameters of the ``n_rep`` whole repetitions of ``cfg.pattern`` on a leading
axis and scans over them; the port keeps one module a layer, in the order of
``cfg.layer_kinds()`` (layer ``r·len(pattern) + j`` is repetition ``r``'s
``j``-th block, the tail after them), with ``repro``'s weight layouts, so
``models.convert`` maps one onto the other leaf for leaf.  ``remat`` wraps
each pattern repetition in ``torch.utils.checkpoint``, as ``repro`` wraps its
scanned superblock.

Modality frontends (musicgen audio frames, internvl2 patch embeddings) are
stubs, as in ``repro``: the caller supplies precomputed embeddings, projected
by ``frontend_proj`` and prepended to the token embeddings.

On a device mesh (``train.train_step.shard_model``) the parameters are
DTensors in ``repro``'s layouts.  Each layer's weights are gathered over the
FSDP axes at use (:func:`_gather_fsdp`, inside the checkpointed repetition so
that backward gathers again; a decode step whose batch the FSDP axes do not
split keeps the shards, each product then partial sums over them), the
activations are constrained where
``repro`` constrains them, and two computations run as explicit regions on
the local shards: the embedding lookup and the chunked cross entropy over a
vocabulary split over ``model`` (each rank's vocabulary slice, its partial
sums reduced over the ranks; the (B, C, V) logits are never gathered).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import P, fsdp_axes, placements
from repro_torch.graph.csr import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import pick_chunk
from repro_torch.models.layers import (
    ParamDef, ParamTree, ashard, axes_tree, const, einsum_f32, from_local, idle, idle_axes,
    local_span, rms_norm, rp_einsum, shape_tree, softcap, torch_dtype)


def model_defs(cfg: ModelConfig) -> dict:
    """The parameter defs, ``layers`` a list of one block's defs a layer;
    each def's logical axes are ``repro``'s without its stacked ``layers``
    axis."""
    d = cfg.d_model
    defs: dict = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "layers": [blocks.block_defs(cfg, kind) for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.frontend != "none":
        defs["frontend_proj"] = ParamDef((d, d), ("embed", None))
    return defs


def _flat(tree, prefix: str = "") -> dict:
    """A defs-shaped tree keyed by parameter name (``layers.3.attn.wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def abstract_params(cfg: ModelConfig) -> dict:
    """Meta tensors of every parameter, keyed by name (no allocation)."""
    return _flat(shape_tree(model_defs(cfg), torch_dtype(cfg.param_dtype)))


def param_logical_axes(cfg: ModelConfig) -> dict:
    """Each parameter's logical axes, keyed by name."""
    return _flat(axes_tree(model_defs(cfg)))


# logical param axes that map to the model (TP) mesh axis; everything else
# (fsdp-sharded dims) is gathered at use time.
_MODEL_AXES = {"heads", "kv_heads", "mlp", "experts", "rnn", "vocab"}


def _gather_fsdp(params: dict, defs: dict, tp: bool = True) -> dict:
    """FSDP weight gathering: each DTensor weight redistributed so that only
    its model (TP) axes stay sharded (``tp=False`` gathers everything).  The
    identity on plain tensors."""
    out: dict = {}
    for name, p in params.items():
        d = defs[name]
        if isinstance(p, dict):
            out[name] = _gather_fsdp(p, d, tp)
            continue
        if not isinstance(p, DTensor):
            out[name] = p
            continue
        mesh = p.device_mesh
        model = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 0)
        parts: list = [None] * p.ndim
        for i, (a, dim) in enumerate(zip(d.axes, d.shape)):
            # a mesh axis may appear at most once
            if tp and model and a in _MODEL_AXES and dim % model == 0 and "model" not in parts:
                parts[i] = "model"
        want = placements(P(*parts), mesh)
        out[name] = p if tuple(p.placements) == want else p.redistribute(mesh, want)
    return out


class DecoderLM(ParamTree):
    """The decoder of ``cfg`` on ``device`` (``cuda`` unless the caller asks
    for the CPU), its weights in ``cfg.param_dtype`` drawn from ``seed``.
    Parameters are named as ``repro``'s tree with the stacking undone:
    ``embed``, ``final_norm``, ``layers.<i>.attn.wq``,
    ``layers.<i>.moe.wi`` (experts first: ``(e, d, f)``),
    ``layers.<i>.rnn.lam``, ``layers.<i>.cell.r``, ``head``, ..."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        super().__init__(model_defs(cfg), torch_dtype(cfg.param_dtype), dev)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.init_from(gen)

    def forward(self, tokens, frontend_emb=None):
        return forward(self, tokens, frontend_emb)

    def update_groups(self) -> list:
        """Parameter names grouped as ``repro``'s leaves hold them: the same
        parameter of one pattern position across the ``n_rep`` repetitions
        is one stacked leaf there, every other parameter a leaf of its own.
        Adafactor clips its update by the RMS of a whole leaf."""
        cfg, per = self.cfg, len(self.cfg.pattern)
        stacked = cfg.n_rep * per
        groups: dict = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers" and int(parts[1]) < stacked:
                key = ("stack", int(parts[1]) % per, ".".join(parts[2:]))
            else:
                key = (name,)
            groups.setdefault(key, []).append(name)
        return list(groups.values())


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a mesh, with the table's vocabulary split over
    ``model``: each rank looks up the tokens in its slice (zero rows for the
    others), and the rows are summed over the slices."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    table = table.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                      for p in table.placements])  # the fsdp dim gathered
    tokens = const(table, tokens)
    split = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    batch = [i for i, p in enumerate(tokens.placements) if p.is_shard(0)]
    lo, n = local_span(table, 0)
    # the table's gradient is partial over the ranks that hold other rows
    t = table.to_local(grad_placements=[Partial() if i in batch else p
                                        for i, p in enumerate(table.placements)])
    ids = tokens.to_local().long() - lo
    mine = (ids >= 0) & (ids < n)
    rows = t[torch.clamp(ids, 0, n - 1)] * mine[..., None].to(t.dtype)
    out = [Partial() if i in split else Shard(0) if i in batch else Replicate()
           for i in range(mesh.ndim)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    rows = from_local(rows, mesh, out, shape)
    return rows.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out])


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, frontend_emb) -> torch.Tensor:
    x = _lookup(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    if cfg.emb_scale:
        x = x * const(x, torch.sqrt(torch.tensor(cfg.d_model, dtype=torch.float32,
                                                 device=x.device))).to(x.dtype)
    if cfg.frontend != "none" and frontend_emb is not None:
        fe = torch.einsum("bsd,de->bse", frontend_emb.to(device=x.device, dtype=x.dtype),
                          params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    return ashard(x, "batch", None, None)


def forward_hidden(
    model: DecoderLM,
    tokens: torch.Tensor,  # (B, S)
    frontend_emb: Optional[torch.Tensor] = None,  # (B, F, D) for audio/vlm stubs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder trunk. Returns (final-normed hidden (B, S_total, D), aux)."""
    cfg = model.cfg
    params = model.tree()
    x = _embed(params, cfg, tokens, frontend_emb)
    positions = const(x, torch.arange(x.shape[1], device=x.device)[None, :])
    aux_total = const(x, torch.zeros((), dtype=torch.float32, device=x.device))
    kinds = cfg.layer_kinds()
    per = len(cfg.pattern)
    tp = cfg.tp_mode != "dp"
    defs = model_defs(cfg)["layers"]

    def superblock(x, first):
        aux = const(x, torch.zeros((), dtype=torch.float32, device=x.device))
        for i in range(first, first + per):
            lp = _gather_fsdp(params["layers"][i], defs[i], tp)
            x, a = blocks.block_train(lp, cfg, kinds[i], x, positions)
            x = ashard(x, "batch", None, None)
            aux = aux + a
        return x, aux

    # "dots" keeps the matmul outputs in repro; here it recomputes them like
    # "full" (the difference is memory, not values)
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    for r in range(cfg.n_rep):
        if remat:
            x, a = checkpoint(superblock, x, r * per, use_reentrant=False)
        else:
            x, a = superblock(x, r * per)
        aux_total = aux_total + a
    for i in range(cfg.n_rep * per, cfg.num_layers):
        lp = _gather_fsdp(params["layers"][i], defs[i], tp)
        x, a = blocks.block_train(lp, cfg, kinds[i], x, positions)
        aux_total = aux_total + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["head"] if not cfg.tie_embeddings else params["embed"].T


def logits_of(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """The head and the logit softcap over hidden states ``x`` (B, S, D); the
    head's FSDP shards gathered first, or kept where a decode step leaves
    the FSDP axes idle (:func:`_decode_idle`), the product then partial sums
    over them."""
    cfg = model.cfg
    head = _head(model.tree(), cfg)
    if not (isinstance(head, DTensor) and set(fsdp_axes(head.device_mesh)) & set(idle())):
        head = ashard(head, None, "model")
    logits = rp_einsum("bsd,dv->bsv", x, head.to(x.dtype), cfg.reduce_dtype)
    return ashard(softcap(logits, cfg.logit_softcap), "batch", None, "model")


def forward(
    model: DecoderLM,
    tokens: torch.Tensor,
    frontend_emb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with logits (prefill/decode-scale shapes only —
    training uses loss_fn's chunked CE so (B,S,V) never materializes)."""
    x, aux_total = forward_hidden(model, tokens, frontend_emb)
    return logits_of(model, x), aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Decode cache: one entry a layer (an attention layer's ``{"k", "v"}``,
    a ring buffer of the window for a local layer; a recurrent layer's
    state) and ``index``, the tokens already in it."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return {
        "layers": [blocks.block_cache_init(cfg, kind, batch, max_len, dtype, dev)
                   for kind in cfg.layer_kinds()],
        "index": 0,
    }


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """:func:`init_cache`'s tree as meta tensors (no allocation)."""
    return init_cache(cfg, batch, max_len, device="meta")


def decode_step(model: DecoderLM, tokens: torch.Tensor, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, 1, V), cache),
    the cache updated in place: the attention layers' buffers written, the
    recurrent layers' new states stored in ``cache["layers"]``."""
    cfg = model.cfg
    params = model.tree()
    x = _embed(params, cfg, tokens, None)
    index = cache["index"]
    defs, tp = model_defs(cfg)["layers"], cfg.tp_mode != "dp"
    # repro leaves the weights in their FSDP shards and GSPMD places each
    # product: where the batch splits over the FSDP axes each rank takes
    # its rows against the gathered weights; where it does not (a batch of
    # 1), the shards stay, each product partial sums over them
    # (``rp_einsum``), so the FSDP ranks do not all repeat the whole layer
    gather = not tp or not isinstance(x, DTensor) or any(p.is_shard(0) for p in x.placements)
    with idle_axes(_decode_idle(x, gather)):
        for i, kind in enumerate(cfg.layer_kinds()):
            lp = _gather_fsdp(params["layers"][i], defs[i], tp) if gather else params["layers"][i]
            x, cache["layers"][i] = blocks.block_decode(lp, cfg, kind, x, cache["layers"][i],
                                                        index)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_of(model, x)
    cache["index"] = index + 1
    return logits, cache


def _decode_idle(x: torch.Tensor, gather: bool) -> tuple:
    """The mesh dimensions a decode step leaves idle, over which
    ``rp_einsum`` splits a contraction that neither operand splits, as GSPMD
    places the step (the dry runs' records): ``model`` on a mesh without a
    ``pod`` axis (a projection whose heads or vocabulary it does not divide;
    on 2 × 16 × 16 GSPMD runs those whole on each ``model`` rank), and the
    FSDP axes where the batch does not split over them (``gather`` false)."""
    if not isinstance(x, DTensor):
        return ()
    names = x.device_mesh.mesh_dim_names or ()
    model = ("model",) if "model" in names and "pod" not in names else ()
    return model + (() if gather else fsdp_axes(x.device_mesh))


def _chunk_nll(xc, lc, head, cap):
    if isinstance(xc, DTensor):
        return _chunk_nll_split(xc, lc, head, cap)
    logits = softcap(einsum_f32("bcd,dv->bcv", xc, head), cap)
    mask = lc >= 0
    safe = torch.clamp(lc, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask, dtype=torch.int32)


def _chunk_nll_split(xc, lc, head, cap):
    """:func:`_chunk_nll` with the head's vocabulary split over ranks: each
    rank's logits over its vocabulary slice, never gathered.  The
    log-sum-exp is the max over the slices, then the sum of each slice's
    exponentials, each reduced over the ranks; the gold logit comes from
    the slice that holds the label (zero from the others), summed."""
    mesh = xc.device_mesh
    # the rows as the batch splits them, each rank's rows whole (after a
    # tail layer the sequence may still be split, as its attention left it)
    rows = [p if p.is_shard(0) else Replicate() for p in xc.placements]
    if rows != list(xc.placements):
        xc = xc.redistribute(mesh, rows)
    lc = const(xc, lc).redistribute(mesh, xc.placements)
    split = [i for i, p in enumerate(head.placements) if p.is_shard(1)]
    batch = [i for i, p in enumerate(xc.placements) if p.is_shard(0)]
    row = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    if not split:  # the whole vocabulary on each rank: each its own rows
        x = xc.to_local()
        w = head.to_local(grad_placements=[Partial() if i in batch else p
                                           for i, p in enumerate(head.placements)])
        nll, cnt = _chunk_nll(x, lc.to_local(), w, cap)
        part = [Partial() if i in batch else Replicate() for i in range(mesh.ndim)]
        return (DTensor.from_local(nll, mesh, part, run_check=False),
                DTensor.from_local(cnt, mesh, part, run_check=False))
    # the gradient of x is partial over the vocabulary slices, the head's
    # over the batch slices
    x = xc.to_local(grad_placements=[Partial() if i in split else p
                                     for i, p in enumerate(xc.placements)])
    w = head.to_local(grad_placements=[Partial() if i in batch else p
                                       for i, p in enumerate(head.placements)])
    labels = lc.to_local()
    logits = softcap(einsum_f32("bcd,dv->bcv", x, w), cap)
    lo, n = local_span(head, 1)

    def reduce(t, op):
        part = [Partial(op) if i in split else p for i, p in enumerate(row)]
        return from_local(t, mesh, part, tuple(lc.shape)).redistribute(mesh, row)

    m = reduce(torch.amax(logits, dim=-1).detach(), "max").to_local()
    total = reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1), "sum")
    ids = torch.clamp(labels, min=0).long() - lo
    mine = (ids >= 0) & (ids < n)
    gold = torch.gather(logits, -1, torch.clamp(ids, 0, n - 1)[..., None])[..., 0]
    gold = reduce(torch.where(mine, gold, torch.zeros((), device=gold.device)), "sum")
    m = from_local(m, mesh, row, tuple(lc.shape))
    logz = torch.log(total) + m
    mask = lc >= 0
    return torch.sum((logz - gold) * mask), torch.sum(mask, dtype=torch.int32)


def loss_fn(
    model: DecoderLM,
    tokens: torch.Tensor,  # (B, S) inputs
    labels: torch.Tensor,  # (B, S) targets (-100 = masked)
    frontend_emb: Optional[torch.Tensor] = None,
    aux_weight: float = 0.01,
    loss_chunk: int | None = None,
) -> torch.Tensor:
    """Cross entropy with *chunked* logits: the (B, S, V) tensor never
    materializes.  Each sequence chunk computes logits → logsumexp → NLL
    in f32 under ``checkpoint``, so its backward recomputes the chunk's
    logits instead of keeping them (``repro`` remats the chunk the same
    way, whatever ``cfg.remat`` says)."""
    cfg = model.cfg
    x, aux = forward_hidden(model, tokens, frontend_emb)
    if cfg.frontend != "none" and frontend_emb is not None:
        x = x[:, frontend_emb.shape[1]:]
    # gather the head's fsdp (embed) dim; keep vocab sharded on model
    head = ashard(_head(model.tree(), cfg).to(x.dtype), None, "model")
    labels = labels.to(x.device)
    b, s, _ = x.shape
    c = pick_chunk(s, loss_chunk or cfg.loss_chunk)
    nll = const(x, torch.zeros((), dtype=torch.float32, device=x.device))
    cnt = const(x, torch.zeros((), dtype=torch.int32, device=x.device))
    for lo in range(0, s, c):
        xc, lc = x[:, lo:lo + c], labels[:, lo:lo + c]
        if torch.is_grad_enabled():
            n, k = checkpoint(_chunk_nll, xc, lc, head, cfg.logit_softcap, use_reentrant=False)
        else:
            n, k = _chunk_nll(xc, lc, head, cfg.logit_softcap)
        nll, cnt = nll + n, cnt + k
    return nll / torch.clamp(cnt, min=1) + aux_weight * aux
