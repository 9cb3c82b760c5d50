"""The ranks of the port's mesh tests: each a process of a gloo world.

``run(job, world, timeout, **args)`` starts ``world`` interpreters, each
running ``job`` as one rank of a gloo process group that meets in a
``FileStore`` (no network), and returns what rank 0's job returned (JSON).
Every rank runs on one intra-op thread, as ``torch_threads`` runs the
worker.  A job is a function of this module taking ``(rank, world,
**args)``.
"""
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def run(job: str, world: int, timeout: float = 300, **args) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
        procs, logs = [], []
        for rank in range(world):
            spec = json.dumps(dict(job=job, rank=rank, world=world, store=os.path.join(
                tmp, "store"), out=out, tmp=tmp, timeout=timeout, args=args))
            # each rank's output to a file: a rank blocked on a full pipe
            # would hold up the others' collectives
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import torch_mesh_child as c; c.main({spec!r})"],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        errs = []
        try:
            for p, log in zip(procs, logs):
                p.wait(timeout=timeout)
                if p.returncode:
                    log.seek(0)
                    errs.append(log.read()[-3000:])
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        assert not errs, errs[0]
        with open(out) as f:
            return json.load(f)


def main(spec: str) -> None:
    import torch
    import torch.distributed as dist

    s = json.loads(spec)
    # a rank still running near the parent's timeout prints its stack and exits
    faulthandler.dump_traceback_later(max(s["timeout"] - 10, 1), exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(s["store"], s["world"]),
                            rank=s["rank"], world_size=s["world"])
    try:
        res = globals()[s["job"]](s["rank"], s["world"], tmp=s["tmp"], **s["args"])
        if s["rank"] == 0:
            with open(s["out"], "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _batch(cfg, rows: int, seq: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend != "none":
        batch["frontend_emb"] = rng.standard_normal(
            (rows, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _train(cfg, ocfg, mesh, batch, steps: int, first_step: int = 1):
    """``steps`` train steps of a fresh seed-0 model (on ``mesh`` when it is
    given): each step's (loss, grad norm) and the final parameters (whole,
    numpy)."""
    import torch

    from repro_torch.models import model as m
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    model = m.DecoderLM(cfg, seed=0, device="cpu")
    if mesh is not None:
        model = ts.shard_model(model, mesh)
    state = opt.opt_init(ocfg, dict(model.named_parameters()))
    step_fn = ts.make_train_step(cfg, ocfg, mesh, device="cpu")
    out = []
    for i in range(first_step, first_step + steps):
        state, _, met = step_fn(model, state, i, batch)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    params = {}
    for n, p in model.named_parameters():
        p = p.detach()
        params[n] = (p.full_tensor() if hasattr(p, "full_tensor") else p).to(torch.float32).numpy()
    return out, params


def _compare(cfg, ocfg, mesh, batch, steps: int) -> dict:
    plain, pp = _train(cfg, ocfg, None, batch, steps)
    meshed, mp = _train(cfg, ocfg, mesh, batch, steps)
    return {"plain": plain, "mesh": meshed,
            "param_err": max(float(np.max(np.abs(pp[n] - mp[n]))) for n in pp),
            "param_scale": max(float(np.max(np.abs(pp[n]))) for n in pp),
            "param_equal": all(np.array_equal(pp[n], mp[n]) for n in pp)}


def _decode(cfg, mesh, tokens, n: int):
    """Prefill logits and ``n`` greedy decode steps' logits (whole, numpy)."""
    import torch

    from repro_torch.models import model as m
    from repro_torch.train import train_step as ts

    model = m.DecoderLM(cfg, seed=0, device="cpu")
    rows = tokens.shape[0]
    cache = m.init_cache(cfg, rows, tokens.shape[1] + n, device="cpu")
    if mesh is not None:
        model = ts.shard_model(model, mesh)
        cache = ts.shard_cache(cache, mesh)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    pre = whole(ts.make_prefill(cfg, mesh, device="cpu")(model, {"tokens": tokens}))
    serve = ts.make_serve_step(cfg, rows, tokens.shape[1] + n, mesh, device="cpu")
    tok = torch.from_numpy(tokens[:, :1])
    steps = []
    for _ in range(n):
        lg, cache = serve(model, cache, tok)
        lg = whole(lg)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        steps.append(lg.numpy())
    return pre.numpy(), steps


def _compressed(pods, arch: str) -> dict:
    """The int8 pod reduction on ``pods`` against one process, on 8 rows of
    which each pod takes 4.  One process computes the gradient of the whole
    batch (``g``), of each pod's rows (``g_p``), and the reduction emulated
    per tensor: ``mean_p(round(g_p / s_p) · s_p)``, ``s_p = max|g_p| / 127``.
    The port's ``_podwise_compressed_grads`` on the mesh gives ``c``.  Per
    leaf: ``max|c - g|`` against its bound ``sum_p max|g_p| / (254 · pods)``
    (half a quantum a pod), and the share of entries where ``c`` and the
    emulation differ by more than 1e-5 of ``max|g|`` (a rounding flip near a
    half quantum).  Then one compressed train step against the one-process
    step: loss, gradient norm (against ``|g|`` with the bound's 2-norm and
    against the emulation's), and the parameters after the AdamW update,
    where an entry with ``|g|`` above twice its leaf's bound keeps its
    update's sign."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as m
    from repro_torch.models.layers import activation_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = get_smoke_config(arch)
    ocfg = opt.OptConfig(kind="adamw", lr=1e-3, warmup_steps=1)
    batch = _batch(cfg, 8, seed=1)
    npods, per = pods.size(0), 8 // pods.size(0)

    def grads(rows):
        model = m.DecoderLM(cfg, seed=0, device="cpu")
        b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        loss = m.loss_fn(model, b["tokens"], b["labels"], b.get("frontend_emb"))
        names, ps = zip(*model.named_parameters())
        return dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, ps))))

    g = grads(slice(None))
    parts = [grads(slice(p * per, (p + 1) * per)) for p in range(npods)]
    emul, bound = {}, {}
    for n in g:
        acc = np.zeros(g[n].shape, np.float32)
        for gp in parts:
            scale = np.float32(max(np.abs(gp[n]).max(), 1e-8)) / np.float32(127)
            acc += np.clip(np.round(gp[n] / scale), -127, 127).astype(np.float32) * scale
        emul[n] = acc / np.float32(npods)
        bound[n] = sum(float(np.abs(gp[n]).max()) for gp in parts) / (254 * npods)

    model = ts.shard_model(m.DecoderLM(cfg, seed=0, device="cpu"), pods)
    params = dict(model.named_parameters())
    placed = ts.place_batch(batch, pods, ts.batch_specs(cfg, pods, 8))
    with activation_mesh(pods, ts.activation_rules(cfg, pods)):
        _, c = ts._podwise_compressed_grads(model, params, cfg, placed, pods)
    c = {n: v.full_tensor().numpy() for n, v in c.items()}
    leaves = {}
    for n in g:
        scale = float(np.abs(g[n]).max())
        leaves[n] = {"err": float(np.abs(c[n] - g[n]).max()), "bound": bound[n],
                     "scale": scale, "flip_share": float(np.mean(
                         np.abs(c[n] - emul[n]) > 1e-5 * scale))}

    plain, pp = _train(cfg, ocfg, None, batch, 1)
    state = opt.opt_init(ocfg, dict(model.named_parameters()))
    _, _, met = ts.make_train_step(cfg, ocfg, pods, compressed=True)(model, state, 1, batch)
    step_err = {"sure": 0.0, "unsure": 0.0}
    for n, p in model.named_parameters():
        d = np.abs(p.detach().full_tensor().numpy() - pp[n])
        sure = np.abs(g[n]) > 2 * bound[n]
        step_err["sure"] = max(step_err["sure"], float(d[sure].max(initial=0)))
        step_err["unsure"] = max(step_err["unsure"], float(d[~sure].max(initial=0)))
    return {"plain": plain[0], "compressed": (float(met["loss"]), float(met["grad_norm"])),
            "leaves": leaves, "lr": ocfg.lr, "step_err": step_err,
            "norm": float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                                      for v in g.values()))),
            "emul_norm": float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                                           for v in emul.values()))),
            "norm_bound": float(np.sqrt(sum(g[n].size * bound[n] ** 2 for n in g)))}


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def one_rank_steps(rank, world, tmp, archs, serve_archs):
    """A world of one, mesh (1, 1): a train step of each smoke config on and
    off the mesh (equal bits), then prefill and decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt

    mesh = make_host_mesh(device="cpu")
    out = {"mesh": list(mesh.shape), "train": {}, "serve": {}}
    for arch in archs:
        cfg = get_smoke_config(arch)
        ocfg = opt.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
        out["train"][arch] = _compare(cfg, ocfg, mesh, _batch(cfg, 4), 1)
    for arch in serve_archs:
        cfg = get_smoke_config(arch)
        tokens = _batch(cfg, 4, 24)["tokens"]
        pre, steps = _decode(cfg, None, tokens, 2)
        pre_m, steps_m = _decode(cfg, mesh, tokens, 2)
        out["serve"][arch] = {
            "prefill_equal": bool(np.array_equal(pre, pre_m)),
            "decode_equal": all(np.array_equal(a, b) for a, b in zip(steps, steps_m)),
            "tokens": [np.argmax(s[:, -1], -1).tolist() for s in steps],
            "tokens_mesh": [np.argmax(s[:, -1], -1).tolist() for s in steps_m]}
    return out


def _train_archs(mesh, archs) -> tuple[dict, dict]:
    """2 train steps of each smoke config on ``mesh`` against one process
    (:func:`_compare`), and the seconds each took."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import optimizer as opt

    res, secs = {}, {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        ocfg = opt.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
        res[arch] = _compare(cfg, ocfg, mesh, _batch(cfg, 8), 2)
        secs[arch] = time.perf_counter() - t0
    return res, secs


def four_rank_steps(rank, world, tmp, archs, mb_arch):
    """4 ranks: the (data 2, model 2) mesh's train steps against the
    one-process step; ``mb_arch`` again at 2 microbatches, and the guard on
    a microbatch the data group does not divide; the launcher's rows by
    rank; the compressed pod gradients on (pod 2, data 1, model 2)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as m
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    mesh = make_host_mesh(model=2, device="cpu")
    out = {"mesh": list(mesh.shape)}
    out["train"], out["seconds"] = _train_archs(mesh, archs)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_smoke_config(mb_arch), microbatches=2)
    ocfg = opt.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
    out["microbatches"] = _compare(cfg, ocfg, mesh, _batch(cfg, 8), 2)
    model = ts.shard_model(m.DecoderLM(cfg, seed=0, device="cpu"), mesh)
    state = opt.opt_init(ocfg, dict(model.named_parameters()))
    try:  # 2 rows: a microbatch of 1 row on a data group of 2
        ts.make_train_step(cfg, ocfg, mesh)(model, state, 1, _batch(cfg, 2))
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    out["seconds"]["microbatches"] = time.perf_counter() - t0

    # rp_einsum on a contraction split over model: the partial sums of bf16
    # products reduced in f32 ("f32") or in bf16 ("bf16")
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import einsum_f32, rp_einsum

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 64, generator=gen).to(torch.bfloat16)
    w = torch.randn(64, 32, generator=gen).to(torch.bfloat16)
    xd = distribute_tensor(x, mesh, [Replicate(), Shard(2)])
    wd = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
    want = einsum_f32("bsf,fd->bsd", x, w)
    out["rp_einsum"] = {}
    for mode in ("f32", "bf16"):
        y = rp_einsum("bsf,fd->bsd", xd, wd, mode)
        y = y.redistribute(mesh, [Replicate(), Replicate()])
        out["rp_einsum"][mode] = {
            "dtype": str(y.dtype), "err": float((y.to_local().float() - want).abs().max()),
            "scale": float(want.abs().max())}

    # the launcher's rows by rank, on this mesh
    seen = []
    real = launch.place_batch

    def spy(batch, *a, **k):
        seen.append(batch["tokens"].tolist())
        return real(batch, *a, **k)

    launch.place_batch = spy
    launch.make_host_mesh = lambda device: make_host_mesh(model=2, device=device)
    launch.main(["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu", "--steps", "2",
                 "--batch", "4", "--seq", "16", "--ckpt-dir", os.path.join(tmp, f"l{rank}")])
    rows = [None] * world
    dist.all_gather_object(rows, {"coord": mesh.get_coordinate(), "rows": seen})
    out["rows"] = rows
    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(get_smoke_config("internlm2_1_8b").vocab_size, 4, 16)
    out["one_process_rows"] = [pipe.next()["tokens"].tolist() for _ in range(2)]

    out["seconds"]["rp_einsum_and_rows"] = time.perf_counter() - t0

    # compressed pod gradients on (pod 2, data 1, model 2)
    t0 = time.perf_counter()
    pods = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))
    out["compressed"] = _compressed(pods, "internlm2_1_8b")
    out["seconds"]["compressed"] = time.perf_counter() - t0
    return out


def _split_cfg(arch: str, split: bool = True):
    """``arch``'s smoke config in ``tp_mode="model"``, with 3 heads at a
    width of 48, which a ``model`` axis of 2 does not divide (``split``), or
    with its own heads, which it divides."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), tp_mode="model")
    return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3, d_model=48) if split else cfg


def four_rank_more(rank, world, tmp, archs, serve_archs, split_archs=(), single_archs=()):
    """4 ranks, the (data 2, model 2) mesh: 2 train steps of ``archs``
    against one process, and of ``split_archs`` in ``tp_mode="model"``, with
    their own heads, which the ``model`` axis divides, and with 3 heads at a
    width of 48, which it does not divide (one
    head, at the smoke width, is ill-conditioned: its one-process gradients
    move by 1e-4 of their scale under a 1e-7 jitter of the weights, 3 heads
    at 48 by 1.8e-6, the smoke config's 2 by 2.4e-6); then prefill and
    greedy decode of ``serve_archs`` at 4 rows and of ``single_archs`` at 1
    row, and of ``split_archs``' split config at both."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt

    mesh = make_host_mesh(model=2, device="cpu")
    out = {"mesh": list(mesh.shape)}
    out["train"], out["seconds"] = _train_archs(mesh, archs)
    for arch, split in [(a, s) for a in split_archs for s in (True, False)]:
        t0 = time.perf_counter()
        cfg = _split_cfg(arch, split)
        ocfg = opt.OptConfig(kind=cfg.optimizer, lr=1e-3, warmup_steps=1)
        key = f"{arch}_split" if split else f"{arch}_model"
        out["train"][key] = _compare(cfg, ocfg, mesh, _batch(cfg, 8), 2)
        out["seconds"][key] = time.perf_counter() - t0
    # prefill of 4 (or 1) × 24 tokens and 2 greedy decode steps on the
    # (2, 2) mesh
    t0 = time.perf_counter()
    out["serve"] = {}
    runs = ([(a, get_smoke_config(a), 4, a) for a in serve_archs]
            + [(a, get_smoke_config(a), 1, f"{a}_rows1") for a in single_archs]
            + [(a, _split_cfg(a), r, f"{a}_split_rows{r}") for a in split_archs for r in (4, 1)])
    for arch, cfg, rows, key in runs:
        tokens = _batch(cfg, rows, 24)["tokens"]
        pre, steps = _decode(cfg, None, tokens, 2)
        pre_m, steps_m = _decode(cfg, mesh, tokens, 2)
        out["serve"][key] = {
            "prefill_err": float(np.abs(pre_m - pre).max()),
            "prefill_scale": float(np.abs(pre).max()),
            "decode_err": [float(np.abs(b - a).max()) for a, b in zip(steps, steps_m)],
            "decode_scale": [float(np.abs(a).max()) for a in steps],
            "tokens": [np.argmax(a[:, -1], -1).tolist() for a in steps],
            "tokens_mesh": [np.argmax(b[:, -1], -1).tolist() for b in steps_m]}
    out["seconds"]["serve"] = time.perf_counter() - t0
    return out


def elastic_save(rank, world, tmp, directory):
    """A sharded tree saved from the (2, 2) mesh of 4 ranks."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import CheckpointManager

    mesh = make_host_mesh(model=2, device="cpu")
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(4)}
    sharded = {"w": distribute_tensor(tree["w"], mesh, [Shard(0), Shard(1)]),
               "b": distribute_tensor(tree["b"], mesh, [Replicate(), Replicate()])}
    CheckpointManager(directory, keep=2, fingerprint="elastic").save(3, sharded)
    return {"mesh": list(mesh.shape), "w_local": list(sharded["w"].to_local().shape)}


def elastic_restore(rank, world, tmp, directory):
    """Restore the checkpoint a (2, 2) mesh wrote onto the mesh
    ``elastic_remesh`` builds over this world."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh

    mesh = elastic_remesh(model_axis=2, device="cpu")
    tree = {"w": torch.zeros(8, 8), "b": torch.zeros(4)}
    shardings = {"w": (mesh, [Shard(0), Shard(1)]), "b": (mesh, [Replicate(), Replicate()])}
    restored, manifest = CheckpointManager(directory, fingerprint="elastic").restore(
        tree, shardings=shardings)
    w = restored["w"]
    return {"mesh": list(mesh.shape), "step": manifest["step"],
            "w": w.full_tensor().tolist(), "b": restored["b"].full_tensor().tolist(),
            "w_ranks": sorted(set(w.device_mesh.mesh.flatten().tolist())),
            "w_local": list(w.to_local().shape)}


def fake_safe_layouts(rank, world, tmp):
    """The layout helpers the dry run needed at the production meshes, on
    real values of a (2, 2) mesh: ``rp_einsum`` on rows split in strides (as
    sequence-block attention leaves them; its weight's gradient partial
    over the rows), ``splittable`` before a reshape the heads' split does
    not divide, and ``local_span`` against DTensor's own offsets."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import local_span, rp_einsum, splittable

    mesh = make_host_mesh(model=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x5 = torch.randn(4, 2, 4, 3, 5, generator=gen)  # (B, nq, Cq, H, K)
    w = torch.randn(3, 5, 6, generator=gen)
    # each model rank a share of every query chunk
    xs = distribute_tensor(x5, mesh, [Shard(0), Shard(2)]).reshape(4, 8, 3, 5)
    wd = distribute_tensor(w, mesh, [Replicate(), Replicate()]).requires_grad_()
    y = rp_einsum("bshk,hkd->bsd", xs, wd)
    y.sum().backward()
    wp = w.clone().requires_grad_()
    yp = torch.einsum("bshk,hkd->bsd", x5.reshape(4, 8, 3, 5), wp)
    yp.sum().backward()

    q = torch.randn(4, 1, 6, 2, generator=gen)  # 6 heads in 3 groups, split over 2 ranks
    qd = splittable(distribute_tensor(q, mesh, [Shard(0), Shard(2)]), 2, 3)
    spans = []
    for shape, pl in (((9, 7), [Shard(0), Shard(1)]), ((9, 7), [Shard(1), Shard(1)]),
                      ((5, 3), [Shard(0), Shard(0)])):
        t = distribute_tensor(torch.zeros(shape), mesh, pl)
        local, offset = compute_local_shape_and_global_offset(t.shape, mesh, t.placements)
        spans.append([[list(local_span(t, d)) for d in range(2)],
                      [[offset[d], local[d]] for d in range(2)]])
    return {"strided": any(isinstance(p, _StridedShard) for p in xs.placements),
            "y_err": float((y.full_tensor() - yp).abs().max()),
            "dw_err": float((wd.grad.full_tensor() - wp.grad).abs().max()),
            "q_err": float((qd.reshape(4, 1, 3, 2, 2).full_tensor()
                            - q.reshape(4, 1, 3, 2, 2)).abs().max()),
            "spans": spans}
