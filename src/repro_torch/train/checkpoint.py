"""Checkpoints on disk in ``repro.train.checkpoint``'s form.

Layout:  <dir>/step_<N>/  with one ``leaf_XXXXX.npy`` per leaf +
``manifest.json`` (step, leaf count, config fingerprint, each leaf's dtype,
and the caller's ``extra``).  A tree's leaves are its tensors, numpy arrays
and scalars in a fixed order: dict keys sorted, lists and tuples in order
(the order ``jax.tree_util`` flattens a dict in), so ``(model.state_dict(),
opt_state)`` gives the same leaf numbering on every save.
Guarantees:
  - atomic: written to ``step_<N>.tmp`` then ``os.rename`` (restart never
    sees a torn checkpoint);
  - keep-k garbage collection;
  - async: ``save_async`` copies the leaves to host memory synchronously and
    writes in a background thread, one save in flight at a time;
  - a restore checks the fingerprint, and each leaf's shape against the
    template, and places each leaf on its template leaf's device and dtype;
  - elastic restore: a DTensor leaf is written whole (every rank gathers it,
    rank 0 writes), and read on the host and placed on the *target* mesh —
    the template leaf's, or the ``shardings`` tree's — so a checkpoint
    written on one mesh restores onto any other.

numpy holds no bfloat16 without ``ml_dtypes`` (which the card's machine
does not have), so a bf16 leaf is stored as its ``uint16`` words and its
dtype recorded in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def flatten(tree) -> list:
    """The leaves of a nested dict / list / tuple, in the fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def _leaves_like(tree, template) -> list:
    """``tree``'s nodes at ``template``'s leaves, in the fixed order (a
    node there may be anything, a ``(mesh, placements)`` pair too)."""
    if isinstance(template, dict):
        return [x for k in sorted(template) for x in _leaves_like(tree[k], template[k])]
    if isinstance(template, (list, tuple)):
        return [x for v, t in zip(tree, template) for x in _leaves_like(v, t)]
    return [tree]


def _unflatten(template, leaves):
    if isinstance(template, dict):
        out = {k: None for k in template}  # keep the template's key order
        for k in sorted(template):
            out[k] = _unflatten(template[k], leaves)
        return type(template)(out) if type(template) is not dict else out
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only
    process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as (host copy, dtype name); bf16 as its 16-bit words; a
    DTensor whole (a collective: every rank of its mesh calls it)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(x, copy=True)
    return a, a.dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, fingerprint: str = ""):
        self.directory = directory
        self.keep = keep
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- writing -----------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        host = [_to_host(x) for x in flatten(tree)]
        path = os.path.join(self.directory, f"step_{step:08d}")
        return self._write(step, host, extra or {}) if _writer() else path

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()  # one in-flight save at a time
        host = [_to_host(x) for x in flatten(tree)]  # snapshot now
        if not _writer():
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, extra: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (arr, _) in enumerate(host_leaves):
            np.save(os.path.join(tmp, _leaf_name(i)), arr)
        manifest = {
            "step": step,
            "num_leaves": len(host_leaves),
            "fingerprint": self.fingerprint,
            "dtypes": [dt for _, dt in host_leaves],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- reading -----------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None, shardings: Any = None):
        """Restore into the structure of ``template`` (the latest step by
        default).  A tensor leaf comes back as a tensor on its template
        leaf's device and in its dtype, any other leaf as a numpy array in
        the template's dtype.  ``shardings``: a tree of the template's
        structure whose leaves are ``(mesh, placements)`` or None; a leaf
        with one is placed on that mesh (the elastic rescale), as is a
        template leaf that is a DTensor.  Returns (tree, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if self.fingerprint and manifest["fingerprint"] != self.fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {manifest['fingerprint']!r} != expected {self.fingerprint!r}"
            )
        flat_t = flatten(template)
        if len(flat_t) != manifest["num_leaves"]:
            raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, template "
                             f"{len(flat_t)}")
        flat_s = (_leaves_like(shardings, template) if shardings is not None
                  else [None] * len(flat_t))
        leaves = []
        for i, (t, dt, sh) in enumerate(zip(flat_t, manifest["dtypes"], flat_s)):
            arr = np.load(os.path.join(d, _leaf_name(i)))
            if tuple(arr.shape) != tuple(np.shape(t)):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, template "
                                 f"{tuple(np.shape(t))}")
            if isinstance(t, torch.Tensor):
                x = torch.from_numpy(arr.view(np.int16) if dt == "bfloat16" else arr)
                if dt == "bfloat16":
                    x = x.view(torch.bfloat16)
                if sh is None and isinstance(t, DTensor):
                    sh = (t.device_mesh, t.placements)
                x = x.to(device=t.device, dtype=t.dtype)
                if sh is not None:
                    x = distribute_tensor(x, *sh, src_data_rank=None)
                leaves.append(x)
            else:
                leaves.append(arr.astype(np.asarray(t).dtype))
        return _unflatten(template, iter(leaves)), manifest
