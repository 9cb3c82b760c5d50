"""A one-axis mesh of devices and the collectives the sharded drain uses.

The port's counterpart of ``jax.sharding.Mesh`` with the ``shard_map``
collectives ``repro.shard`` runs: one process drives a list of devices, a
shard each, as JAX's single-controller drain does.  A device may repeat:
``ShardMesh.on("cuda:0", 4)`` puts four shards on one card, so the exchange,
the hub hops and the deferral run for real on one card, and
``ShardMesh.on("cpu", D)`` is what the CPU tests use.  Between shards on one
device a collective is a gather on that device; between devices it is a
device-to-device copy.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.graph.csr import resolve_device


class ShardMesh:
    """Devices along one axis, one shard each (repeats allowed).

    A ``cuda`` device without an index is pinned to the current card; a
    CUDA device without a card raises (:func:`~repro_torch.graph.csr.resolve_device`).
    """

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        self.devices = tuple(devs)

    @classmethod
    def on(cls, device, n: int) -> "ShardMesh":
        """``n`` shards on one device."""
        return cls([device] * int(n))

    @property
    def size(self) -> int:
        return len(self.devices)

    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``bufs[p]`` is shard ``p``'s ``(D, slots, ...)`` buffer; returns,
        for each shard ``d``, the ``(D, slots, ...)`` tensor whose row ``p``
        is ``bufs[p][d]``, on ``d``'s device (``lax.all_to_all`` with
        ``split_axis = concat_axis = 0``, tiled)."""
        d_ = self.size
        if len(bufs) != d_ or any(b.shape[0] != d_ for b in bufs):
            raise ValueError(f"all_to_all over {d_} shards needs {d_} buffers of {d_} rows")
        return [torch.stack([bufs[p][d].to(dev, non_blocking=True) for p in range(d_)])
                for d, dev in enumerate(self.devices)]

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the shards' tensors, on every shard's device."""
        return self._reduce(xs, torch.add)

    def pmax(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum of the shards' tensors, on every shard's
        device."""
        return self._reduce(xs, torch.maximum)

    def _reduce(self, xs, op) -> List[torch.Tensor]:
        if len(xs) != self.size:
            raise ValueError(f"a reduction over {self.size} shards got {len(xs)} tensors")
        home = self.devices[0]
        total = xs[0].to(home)
        for x in xs[1:]:
            total = op(total, x.to(home, non_blocking=True))
        return [total if dev == home else total.to(dev) for dev in self.devices]
