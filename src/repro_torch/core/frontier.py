"""Device-resident frontier queues for the out-of-memory scheduler (paper §V).

The semantics of ``repro.core.frontier``: one fixed-capacity queue per graph
partition, stacked as ``(P, cap)`` int32 tensors with a count per partition,
and the two cursor operations the §V drain needs:

- :func:`push_many` — append a batch of entries to the queues of their
  owning partitions in one scatter (the cross-partition redistribution,
  paper Fig. 8); overflow past ``cap`` is dropped and counted.
- :func:`pop_chunk` — take up to ``n`` entries off the front of one
  partition's queue and left-compact the rest, optionally only the head
  entry's instance (the paper's Fig. 13 per-instance baseline).

Entry metadata is the paper's §V-C batched queue entry: vertex, InstanceID,
CurrDepth, and the predecessor vertex (for prev-dependent biases such as
node2vec).  Empty slots hold -1.

Where the reference merges a push into every ``(P, cap)`` slot with a mask,
each entry here is scattered straight to its slot ``count[p] + rank``; both
operations update the queues in place (and return them, so callers read as
the reference's functional ones).  Neither reads anything back to the host:
a drain chunk runs without a device sync.  Every sort is stable, so ties
break as ``jnp.argsort``'s do.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FrontierQueues:
    """Per-partition frontier queues as stacked device tensors.

    ``data`` is ``(4, P·cap + 1)`` int32: the vertex, instance, depth and
    prev fields of every slot, queue ``p`` at columns ``[p·cap, (p+1)·cap)``,
    and one last column that scatters of nothing write to (never read).
    count: ``(P,)`` int32 live entries per partition (front-packed);
    dropped: ``()`` int32 entries discarded to capacity overflow.
    """

    data: torch.Tensor
    count: torch.Tensor
    dropped: torch.Tensor
    num_partitions: int
    capacity: int

    def _field(self, i: int) -> torch.Tensor:
        return self.data[i, :-1].view(self.num_partitions, self.capacity)

    @property
    def vertex(self) -> torch.Tensor:
        return self._field(0)

    @property
    def instance(self) -> torch.Tensor:
        return self._field(1)

    @property
    def depth(self) -> torch.Tensor:
        return self._field(2)

    @property
    def prev(self) -> torch.Tensor:
        return self._field(3)


def make_queues(num_partitions: int, capacity: int, device="cpu") -> FrontierQueues:
    """Empty queues: every slot -1, zero counts."""
    return FrontierQueues(
        data=torch.full((4, num_partitions * capacity + 1), -1, dtype=torch.int32, device=device),
        count=torch.zeros(num_partitions, dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
        num_partitions=num_partitions, capacity=capacity,
    )


def owner_compaction(pid: torch.Tensor, valid: torch.Tensor, num_buckets: int):
    """Group a batch by owner, as ``repro.core.frontier.owner_compaction``.

    A stable sort by owner groups the valid entries of each bucket in batch
    order; invalid entries sort last (bucket ``num_buckets``).  Returns
    ``(order, adds, offset)``: the grouping permutation of the ``(E,)``
    batch (int64), the entries per bucket ``(B,)`` and the start of each
    bucket's group in the sorted batch ``(B,)``, so sorted entry
    ``order[offset[b] + s]`` is entry ``s`` of bucket ``b``.
    """
    pidv = torch.where(valid, pid, num_buckets).long()
    order = torch.argsort(pidv, stable=True)
    # a histogram, not a scatter-add: most of a batch may be invalid, and
    # atomics on the one invalid bucket would serialize
    adds = torch.bincount(pidv, minlength=num_buckets + 1)[:num_buckets].to(torch.int32)
    offset = torch.cumsum(adds, 0, dtype=torch.int32) - adds
    return order, adds, offset


def push_many(q: FrontierQueues, pid, vertex, instance, depth, prev, valid) -> FrontierQueues:
    """Append the ``valid`` entries to the tails of their partitions' queues.

    All arguments are flat ``(E,)`` tensors; ``pid`` names each entry's
    owning partition.  Entry ``s`` (in batch order) of partition ``p``'s
    group goes to slot ``count[p] + s``; entries past ``cap`` are dropped
    and counted in ``q.dropped``.  Updates ``q`` in place and returns it.
    """
    num_parts, cap = q.num_partitions, q.capacity
    order, adds, offset = owner_compaction(pid, valid, num_parts)
    owner = torch.where(valid, pid, num_parts).long()[order]  # the sorted batch's owners
    live = owner < num_parts
    p = torch.clamp(owner, max=num_parts - 1)
    rank = torch.arange(owner.shape[0], device=owner.device) - offset[p]
    slot = q.count[p] + rank
    keep = live & (slot < cap)
    col = torch.where(keep, p * cap + slot, num_parts * cap)
    vals = torch.stack([vertex, instance, depth, prev]).to(torch.int32)[:, order]
    q.data.scatter_(1, col[None].expand(4, -1), vals)
    new_count = torch.clamp(q.count + adds, max=cap)
    q.dropped += adds.sum(dtype=torch.int32) - (new_count - q.count).sum(dtype=torch.int32)
    q.count.copy_(new_count)
    return q


def pop_chunk(q: FrontierQueues, pid: int, n: int, limit=None, match_head_instance: bool = False):
    """Pop up to ``n`` entries off the front of queue ``pid``.

    Returns ``((vertex, instance, depth, prev), taken, q)``: the entries as
    ``(n,)`` tensors in queue order, padded with -1, and ``taken`` the
    number popped (a 0-d tensor).  ``limit`` (a 0-d tensor or int) caps the
    take without changing shapes (the drain's balance budget; at most 0
    takes nothing).  With ``match_head_instance`` only entries of the front
    entry's instance are taken.  The survivors are left-compacted so the
    queue's front stays at slot 0.  Updates ``q`` in place.
    """
    cap = q.capacity
    take_n = min(n, cap)
    rows = q.data[:, pid * cap:(pid + 1) * cap]  # (4, cap) view of the queue
    idx = torch.arange(cap, device=rows.device)
    cnt = q.count[pid]
    live = idx < cnt
    sel = live & (rows[1] == rows[1, 0]) if match_head_instance else live
    rank = torch.cumsum(sel, 0) - 1
    lim = take_n if limit is None else torch.clamp(torch.as_tensor(limit, device=rows.device),
                                                   max=take_n)
    take = sel & (rank < lim)
    taken = take.sum(dtype=torch.int32)
    out = torch.full((4, n + 1), -1, dtype=torch.int32, device=rows.device)
    out.scatter_(1, torch.where(take, rank, n)[None].expand(4, -1), rows)
    keep = live & ~take
    kept = torch.full((4, cap + 1), -1, dtype=torch.int32, device=rows.device)
    kept.scatter_(1, torch.where(keep, torch.cumsum(keep, 0) - 1, cap)[None].expand(4, -1), rows)
    rows.copy_(kept[:, :cap])
    q.count[pid] = cnt - taken
    return (out[0, :n], out[1, :n], out[2, :n], out[3, :n]), taken, q
