"""The port's frontier queues and OOM plan against ``repro``'s.

The contracts of ``tests/test_frontier.py`` (cross-partition pushes, tail
appends, invalid entries, overflow counted, FIFO pops with compaction,
padding, the dynamic limit, the per-instance baseline, one partition at a
time), each also held field for field against ``repro.core.frontier`` on
the same inputs, plus random push/pop sequences and the scheduler's
``_plan`` with ties in the counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import frontier as jfr  # noqa: E402
from repro.core.oom import _plan as j_plan  # noqa: E402
from repro_torch.core import frontier  # noqa: E402
from repro_torch.core.oom import _plan  # noqa: E402


def _args(pid, v, inst=None, d=None, prev=None, valid=None):
    n = len(pid)
    inst = np.arange(n) if inst is None else inst
    d = np.zeros(n) if d is None else d
    prev = np.full(n, -1) if prev is None else prev
    valid = np.ones(n, bool) if valid is None else valid
    return [np.asarray(a, np.int32) for a in (pid, v, inst, d, prev)] + [np.asarray(valid, bool)]


class Both:
    """The port's queues and the reference's, driven by the same calls."""

    def __init__(self, parts, cap):
        self.t = frontier.make_queues(parts, cap)
        self.j = jfr.make_queues(parts, cap)

    def push(self, *args, **kw):
        a = _args(*args, **kw)
        frontier.push_many(self.t, *(torch.from_numpy(x) for x in a))
        self.j = jfr.push_many(self.j, *(jnp.asarray(x) for x in a))
        self.check()

    def pop(self, pid, n, limit=None, match_head_instance=False):
        got, taken, _ = frontier.pop_chunk(
            self.t, pid, n, limit=None if limit is None else torch.tensor(limit, dtype=torch.int32),
            match_head_instance=match_head_instance)
        want, jtaken, self.j = jfr.pop_chunk(
            self.j, jnp.int32(pid), n, limit=None if limit is None else jnp.int32(limit),
            match_head_instance=match_head_instance)
        assert int(taken) == int(jtaken)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        self.check()
        return [a.numpy() for a in got], int(taken)

    def check(self):
        for name in ("vertex", "instance", "depth", "prev", "count", "dropped"):
            np.testing.assert_array_equal(getattr(self.t, name).numpy(),
                                          np.asarray(getattr(self.j, name)), err_msg=name)


def test_cross_partition_scatter():
    q = Both(3, 8)
    q.push(pid=[0, 2, 0, 1, 2], v=[10, 20, 30, 40, 50])
    np.testing.assert_array_equal(q.t.count.numpy(), [2, 1, 2])
    np.testing.assert_array_equal(q.t.vertex[0, :2].numpy(), [10, 30])
    np.testing.assert_array_equal(q.t.instance[0, :2].numpy(), [0, 2])
    assert int(q.t.dropped) == 0


def test_appends_after_existing_tail():
    q = Both(2, 8)
    q.push(pid=[0, 0], v=[1, 2])
    q.push(pid=[0, 1], v=[3, 4])
    np.testing.assert_array_equal(q.t.vertex[0, :3].numpy(), [1, 2, 3])


def test_invalid_entries_not_pushed():
    q = Both(2, 8)
    q.push(pid=[0, 0, 1], v=[1, 2, 3], valid=[True, False, True])
    np.testing.assert_array_equal(q.t.vertex[0, :2].numpy(), [1, -1])


def test_overflow_dropped_and_counted():
    q = Both(1, 4)
    q.push(pid=[0] * 6, v=list(range(6)))
    np.testing.assert_array_equal(q.t.vertex[0].numpy(), [0, 1, 2, 3])
    assert int(q.t.dropped) == 2
    q.push(pid=[0, 0], v=[8, 9])  # a full queue drops every new entry
    assert int(q.t.dropped) == 4


def test_fifo_pops_and_compaction():
    q = Both(1, 8)
    q.push(pid=[0] * 5, v=[10, 11, 12, 13, 14])
    (v, inst, _, _), taken = q.pop(0, 3)
    assert taken == 3 and list(v) == [10, 11, 12] and list(inst) == [0, 1, 2]
    np.testing.assert_array_equal(q.t.vertex[0, :3].numpy(), [13, 14, -1])


def test_pop_pads_with_minus_one_and_empty_pops():
    q = Both(2, 8)
    q.push(pid=[0], v=[7])
    (v, *_), taken = q.pop(0, 4)
    assert taken == 1 and list(v) == [7, -1, -1, -1]
    (v, *_), taken = q.pop(0, 4)
    assert taken == 0 and (v == -1).all()
    q.pop(1, 16)  # wider than the queue


@pytest.mark.parametrize("limit", [2, 0, -3, 9])
def test_dynamic_limit(limit):
    q = Both(1, 8)
    q.push(pid=[0] * 5, v=list(range(5)))
    (v, *_), taken = q.pop(0, 4, limit=limit)
    assert taken == max(0, min(limit, 4))


def test_match_head_instance():
    q = Both(1, 8)
    q.push(pid=[0] * 4, v=[1, 2, 3, 4], inst=[3, 3, 5, 3])
    (v, inst, *_), taken = q.pop(0, 8, match_head_instance=True)
    assert taken == 3 and list(v[:3]) == [1, 2, 4]
    np.testing.assert_array_equal(q.t.instance[0, :2].numpy(), [5, -1])
    q.pop(0, 8, limit=0, match_head_instance=True)


def test_pop_targets_one_partition():
    q = Both(3, 4)
    q.push(pid=[0, 1, 2], v=[10, 20, 30])
    (v, *_), taken = q.pop(1, 4)
    assert taken == 1 and v[0] == 20
    np.testing.assert_array_equal(q.t.count.numpy(), [1, 0, 1])


@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_equal_reference(seed):
    """Random pushes (invalid entries, overflow) and pops (limits, the
    per-instance baseline) leave the port's queues equal to repro's."""
    rng = np.random.default_rng(seed)
    parts, cap = 4, 16
    q = Both(parts, cap)
    for _ in range(12):
        n = int(rng.integers(1, 24))
        q.push(pid=rng.integers(0, parts, n), v=rng.integers(0, 100, n),
               inst=rng.integers(0, 6, n), d=rng.integers(0, 5, n), prev=rng.integers(-1, 50, n),
               valid=rng.random(n) < 0.8)
        q.pop(int(rng.integers(0, parts)), int(rng.integers(1, 20)),
              limit=int(rng.integers(-2, 12)) if rng.random() < 0.5 else None,
              match_head_instance=bool(rng.random() < 0.3))


def test_owner_compaction_equals_reference():
    rng = np.random.default_rng(7)
    pid = rng.integers(0, 5, 64).astype(np.int32)
    valid = rng.random(64) < 0.7
    order, adds, offset = frontier.owner_compaction(torch.from_numpy(pid),
                                                    torch.from_numpy(valid), 5)
    jorder, jadds, joffset = jfr.owner_compaction(jnp.asarray(pid), jnp.asarray(valid), 5)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(adds.numpy(), np.asarray(jadds))
    np.testing.assert_array_equal(offset.numpy(), np.asarray(joffset))


@pytest.mark.parametrize("counts", [
    [5, 5, 0, 5, 1], [0, 0, 3, 3], [7, 1, 7, 1, 7, 0], [2, 2, 2, 2], [1000, 1, 1, 998],
])
@pytest.mark.parametrize("workload_aware", [True, False])
@pytest.mark.parametrize("balance", [True, False])
def test_plan_equals_reference_with_ties(counts, workload_aware, balance):
    """Equal counts order by partition id (a stable sort), as
    ``jnp.argsort`` orders them; budgets in f32 as the reference's."""
    c = np.asarray(counts, np.int32)
    kw = dict(workload_aware=workload_aware, balance=balance, num_streams=2, chunk=96)
    order, budgets = _plan(torch.from_numpy(c), **kw)
    jorder, jbudgets = j_plan(jnp.asarray(c), **kw)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(budgets.numpy(), np.asarray(jbudgets))
