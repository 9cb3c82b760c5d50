"""Fixed-capacity owner routing: the mesh frontier-exchange layer (§V-D).

The semantics of ``repro.shard.exchange`` on tensors:

- :class:`ShardQueue` with :func:`queue_push` / :func:`queue_pop` — one
  front-packed frontier queue per shard, generic over an entry's fields
  (vertex, instance, depth, prev, and any carried state such as the
  previous vertex's neighbor row);
- :func:`route_by_owner` — bucket a batch of live entries by destination
  shard with ``core.frontier.owner_compaction`` (one stable sort), into
  fixed ``(D, slots)`` send buffers; entries past a destination's
  ``slots`` come back as a front-packed *leftover* batch that the caller
  offers again next round (deferred, never dropped);
- :func:`all_to_all_fields` — the one collective, over a
  :class:`~repro_torch.shard.mesh.ShardMesh`: row ``p`` of shard ``d``'s
  result is the batch shard ``p`` addressed to ``d``.

Where the reference groups a batch with a stable sort by a 0/1 key, the
grouping permutation here comes from two cumsums and one scatter to
distinct slots (:func:`_front_order`), and every placement is a gather, as
the reference's; a pop shifts the survivors to the front in place.  Nothing
reads back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.frontier import owner_compaction

#: fill value of empty slots in every int32 entry field
EMPTY = -1


def entry_nbytes(widths: Sequence[int]) -> int:
    """Wire footprint of ONE queue entry, in bytes: 4 for each scalar lane
    (width 0) and ``4·K`` for each ``K``-wide payload lane (all int32)."""
    return 4 * sum(max(int(w), 1) for w in widths)


def _masked(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``vals`` where ``mask`` (broadcast over payload dims), else EMPTY."""
    m = mask.reshape(tuple(mask.shape) + (1,) * (vals.dim() - mask.dim()))
    return torch.where(m, vals, EMPTY)


@dataclasses.dataclass
class ShardQueue:
    """One shard's frontier queue: front-packed fixed-capacity fields.

    ``fields``: one ``(cap,)`` or ``(cap, K)`` int32 tensor per entry field,
    front-packed together (-1 = empty slot).  Field 1 is the instance id,
    whose non-negativity marks a live entry.  ``count``: ``()`` live
    entries; ``dropped``: ``()`` entries lost to overflow on push.
    """

    fields: Tuple[torch.Tensor, ...]
    count: torch.Tensor
    dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.fields[0].shape[0]


def make_queue(capacity: int, widths: Sequence[int], device="cpu") -> ShardQueue:
    """An empty queue; ``widths[i] > 0`` adds a payload dim."""
    fields = tuple(
        torch.full((capacity, w) if w > 0 else (capacity,), EMPTY, dtype=torch.int32,
                   device=device)
        for w in widths
    )
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    return ShardQueue(fields, zero(), zero())


def _front_order(mask: torch.Tensor):
    """``(order, count)``: the permutation of a batch that puts the entries
    of ``mask`` first and the rest after, each in batch order (the
    reference's stable ``argsort(where(mask, 0, 1))``), and the count of
    ``mask``.  Two cumsums and a scatter to distinct slots."""
    m = mask.to(torch.int64)
    count = m.sum()
    pos = torch.where(mask, torch.cumsum(m, 0) - 1, count + torch.cumsum(1 - m, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(pos.shape[0], device=pos.device)
    return order, count


def queue_push(q: ShardQueue, entries: Tuple[torch.Tensor, ...],
               valid: torch.Tensor) -> ShardQueue:
    """Append the ``valid`` entries of a batch (``(N, ...)`` per field) at
    the tail, in batch order.  Entries past the capacity are dropped and
    counted.  Updates ``q`` in place and returns it."""
    n = valid.shape[0]
    if n == 0:
        return q
    cap = q.capacity
    order, nvalid = _front_order(valid)
    j = torch.arange(cap, device=valid.device) - q.count  # incoming rank of each slot
    fill = (j >= 0) & (j < nvalid)
    src = order[torch.clamp(j, 0, n - 1)]
    for f, e in zip(q.fields, entries):
        m = fill.reshape((cap,) + (1,) * (f.dim() - 1))
        f.copy_(torch.where(m, e[src].to(torch.int32), f))
    new_count = torch.clamp(q.count + nvalid, max=cap).to(torch.int32)
    q.dropped += (nvalid - (new_count - q.count)).to(torch.int32)
    q.count.copy_(new_count)
    return q


def queue_pop(q: ShardQueue, n: int, limit=None):
    """Pop up to ``n`` entries off the (front-packed) queue head.

    Returns ``(entries, taken, q)``: ``(n, ...)`` fields padded with -1 and
    the count taken (a 0-d tensor); ``limit`` (a 0-d tensor or int) caps
    the take without changing shapes.  The survivors move to the front in
    place.
    """
    cap = q.capacity
    if n > cap:
        raise ValueError(f"pop width {n} exceeds queue capacity {cap}")
    dev = q.count.device
    take = torch.clamp(q.count, max=n)
    if limit is not None:
        take = torch.minimum(take, torch.clamp(torch.as_tensor(limit, device=dev), min=0))
    keep = q.count - take
    out_mask = torch.arange(n, device=dev) < take
    keep_mask = torch.arange(cap, device=dev) < keep
    src = torch.remainder(torch.arange(cap, device=dev) + take, cap)
    entries = []
    for f in q.fields:
        entries.append(_masked(out_mask, f[:n]))
        f.copy_(_masked(keep_mask, f[src]))
    q.count.copy_(keep)
    return tuple(entries), take, q


def route_by_owner(entries: Tuple[torch.Tensor, ...], dest: torch.Tensor, valid: torch.Tensor,
                   num_dest: int, slots: int):
    """Compact a batch of entries into per-destination send buffers.

    ``entries``: ``(N, ...)`` fields; ``dest``: ``(N,)`` destination shard
    of each entry; ``valid``: live mask.  Returns ``(send, sent, leftover,
    left_count)``: ``(num_dest, slots, ...)`` buffers, row ``p`` front-packed
    with the first ``slots`` entries addressed to ``p`` in batch order (so
    older deferred entries keep priority when the caller puts them first);
    the ``(num_dest,)`` counts sent; the ``(N, ...)`` front-packed batch of
    the valid entries that did not fit their destination's slots (deferred,
    not dropped); and their count.
    """
    n = valid.shape[0]
    dev = valid.device
    order, adds, offset = owner_compaction(dest, valid, num_dest)
    sent = torch.clamp(adds, max=slots)
    j = torch.arange(slots, device=dev)
    fill = j[None, :] < sent[:, None]
    src = order[torch.clamp(offset[:, None] + j[None, :], 0, max(n - 1, 0))]
    send = tuple(_masked(fill, f[src]) for f in entries)

    # each entry's rank within its destination: its sorted position minus
    # its group's start; entries ranked past `slots` wait for the next round
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    rank = inv - offset[torch.clamp(dest, 0, num_dest - 1).long()]
    overflow = valid & (rank >= slots)
    order2, left_count = _front_order(overflow)  # overflow first
    left_mask = torch.arange(n, device=dev) < left_count
    leftover = tuple(_masked(left_mask, f[order2]) for f in entries)
    return send, sent, leftover, left_count.to(torch.int32)


def all_to_all_fields(sends, mesh):
    """Exchange every shard's ``(D, slots, ...)`` send buffers over
    ``mesh``: ``sends[d]`` is shard ``d``'s tuple of field buffers; returns
    each shard's received buffers, row ``p`` the batch shard ``p`` addressed
    to it, on its device."""
    per_field = [mesh.all_to_all([s[f] for s in sends]) for f in range(len(sends[0]))]
    return [tuple(per_field[f][d] for f in range(len(per_field))) for d in range(mesh.size)]
