"""The port's streaming sampling service (``repro_torch.serve.stream``) on the CPU.

Every contract of ``tests/test_stream.py`` held by the port: the window,
fill and slack triggers launch for the right reason; launch order is EDF
with priority tiers and then arrival order breaking ties; streamed results
equal the standalone padded walk; tenant token buckets reject with the
named limit; a failed launch fails exactly its unserved members' futures;
close, latency accounting, the launch-cost EMA, the OOM placement and the
background thread.

Then the cross-package parity: one fake-clock script drives ``repro``'s
``StreamingSamplingService`` (reference backend) and the port's in the
deterministic mode (``start=False``); the launches (reason, request ids),
every request's walks and every ``ServiceStats`` field, latencies included,
must be equal.  Exact tolerance throughout (vertex ids).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro.core import algorithms as jalg  # noqa: E402
from repro.graph import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro.graph.partition import partition_by_vertex_range as j_partition  # noqa: E402
from repro.serve import AdmissionError as JAdmissionError  # noqa: E402
from repro.serve import Priority as JPriority  # noqa: E402
from repro.serve import SamplingService as JSamplingService  # noqa: E402
from repro.serve import ServiceConfig as JServiceConfig  # noqa: E402
from repro.serve import StreamConfig as JStreamConfig  # noqa: E402
from repro.serve import StreamingSamplingService as JStreaming  # noqa: E402
from repro.serve import TenantQuota as JTenantQuota  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.engine import random_walk  # noqa: E402
from repro_torch.core.rng import PRNGKey, fold_in  # noqa: E402
from repro_torch.graph import csr_from_arrays, partition_by_vertex_range  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    DrainError,
    Priority,
    SamplingService,
    ServiceConfig,
    StreamConfig,
    StreamingSamplingService,
    TenantQuota,
)
from repro_torch.serve.queue import _pow2_bucket  # noqa: E402
from repro_torch.serve.stream import percentile  # noqa: E402


@pytest.fixture(scope="module")
def graphs():
    """``repro``'s test graph and the port's copy of it."""
    g = j_powerlaw_graph(2000, exponent=2.1, seed=3, weighted=True)
    tg = csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.weights),
                         device="cpu")
    return g, tg


@pytest.fixture(scope="module")
def graph(graphs):
    return graphs[1]


class FakeClock:
    """Injectable monotonic clock: time moves only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def make_stream(graph, config=None, svc_config=None, **svc_kwargs):
    clk = FakeClock()
    svc = SamplingService(graph, device="cpu", key=PRNGKey(7), config=svc_config, **svc_kwargs)
    return StreamingSamplingService(svc, config, clock=clk, start=False), clk


class TestWindowPolicy:
    def test_window_trigger(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=20))
        f1 = stream.submit([0, 1, 2], depth=4, spec=alg.deepwalk())
        clk.t = 0.005
        f2 = stream.submit([3, 4], depth=4, spec=alg.deepwalk())
        clk.t = 0.019  # window not elapsed for either
        assert stream.poll() == 0 and stream.pending == 2
        clk.t = 0.0201  # f1's window elapsed; f2 rides along (same cohort)
        assert stream.poll() == 1
        assert stream.pending == 0 and f1.done() and f2.done()
        assert f1.latency.reason == "window"
        assert f1.result().walks.shape == (3, 5)
        assert f2.result().walks.shape == (2, 5)

    def test_fill_trigger(self, graph):
        stream, clk = make_stream(
            graph, StreamConfig(max_batch_window_ms=1000),
            svc_config=ServiceConfig(max_requests_per_launch=3),
        )
        futs = [stream.submit([i], depth=4, spec=alg.deepwalk()) for i in range(3)]
        assert stream.poll() == 1  # no clock advance needed
        assert all(f.done() for f in futs)
        assert futs[0].latency.reason == "fill"

    def test_slack_trigger(self, graph):
        stream, clk = make_stream(graph, StreamConfig(
            max_batch_window_ms=1000, slack_factor=2.0, launch_cost_prior_ms=10.0))
        f = stream.submit([0, 1], depth=4, spec=alg.deepwalk(), deadline_ms=100)
        clk.t = 0.079  # launch point is 100ms - 2x10ms = 80ms
        assert stream.poll() == 0
        clk.t = 0.081
        assert stream.poll() == 1
        assert f.latency.reason == "slack"
        assert f.latency.deadline_met is True

    def test_loose_deadline_overrides_window(self, graph):
        stream, clk = make_stream(graph, StreamConfig(
            max_batch_window_ms=20, slack_factor=1.0, launch_cost_prior_ms=10.0))
        stream.submit([0], depth=4, spec=alg.deepwalk(), deadline_ms=500)
        clk.t = 0.100  # well past the window, well before 500ms - 10ms
        assert stream.poll() == 0
        clk.t = 0.491
        assert stream.poll() == 1

    def test_batching_false_launches_per_request(self, graph):
        stream, clk = make_stream(graph, StreamConfig(batching=False, max_batch_window_ms=1000))
        f1 = stream.submit([0, 1], depth=4, spec=alg.deepwalk())
        f2 = stream.submit([2, 3], depth=4, spec=alg.deepwalk())
        assert stream.poll() == 2  # no co-batching despite identical key
        assert f1.latency.reason == "immediate"
        assert f2.latency.reason == "immediate"
        assert stream.stats.stream_launches == 2

    def test_flush_launches_everything(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000))
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        assert stream.poll() == 0  # not due
        assert stream.flush() == 1
        assert f.latency.reason == "flush"


class TestLaunchOrder:
    def test_edf_across_cohorts(self, graph):
        stream, clk = make_stream(graph, StreamConfig(slack_factor=1.0, launch_cost_prior_ms=1.0))
        fa = stream.submit([0], depth=4, spec=alg.deepwalk(), deadline_ms=100)
        fb = stream.submit([1], depth=4, spec=alg.weighted_random_walk(), deadline_ms=50)
        clk.t = 0.200  # both overdue
        assert stream.poll() == 2
        order = [lat.request_id for lat in stream.stats.stream_latencies]
        assert order == [fb.request_id, fa.request_id]

    def test_priority_breaks_deadline_ties(self, graph):
        stream, clk = make_stream(graph, StreamConfig(slack_factor=1.0, launch_cost_prior_ms=1.0))
        fa = stream.submit([0], depth=4, spec=alg.deepwalk(), deadline_ms=50)
        fb = stream.submit([1], depth=4, spec=alg.weighted_random_walk(), deadline_ms=50,
                           priority=Priority.INTERACTIVE)
        clk.t = 0.200
        assert stream.poll() == 2
        order = [lat.request_id for lat in stream.stats.stream_latencies]
        assert order == [fb.request_id, fa.request_id]
        assert fb.latency.tier == int(Priority.INTERACTIVE)

    def test_fifo_breaks_full_ties(self, graph):
        stream, clk = make_stream(graph, StreamConfig(slack_factor=1.0, launch_cost_prior_ms=1.0))
        fa = stream.submit([0], depth=4, spec=alg.deepwalk(), deadline_ms=50)
        fb = stream.submit([1], depth=4, spec=alg.weighted_random_walk(), deadline_ms=50)
        clk.t = 0.200
        stream.poll()
        order = [lat.request_id for lat in stream.stats.stream_latencies]
        assert order == [fa.request_id, fb.request_id]


class TestStreamedParity:
    def test_streamed_matches_standalone_padded_call(self, graph):
        g = graph
        clk = FakeClock()
        svc = SamplingService(g, device="cpu", key=PRNGKey(7))
        stream = StreamingSamplingService(svc, StreamConfig(max_batch_window_ms=10), clock=clk,
                                          start=False)
        rng = np.random.default_rng(5)
        subs = []
        for i in range(4):
            seeds = rng.integers(0, g.num_vertices, int(rng.integers(3, 20)))
            key = fold_in(PRNGKey(42), i)
            fut = stream.submit(seeds, depth=6, spec=alg.deepwalk(), key=key,
                                deadline_ms=float(rng.integers(5, 100)))
            subs.append((fut, seeds, key))
            clk.t += 0.003
        clk.t += 1.0
        stream.poll()
        cfg = svc.config
        for fut, seeds, key in subs:
            width = _pow2_bucket(len(seeds), cfg.min_walker_bucket)
            row = np.full((width,), -1, np.int32)
            row[: len(seeds)] = seeds
            solo = random_walk(g, row, key, depth=_pow2_bucket(6, cfg.min_depth_bucket),
                               spec=alg.deepwalk(), max_degree=g.max_degree(), device="cpu")
            np.testing.assert_array_equal(fut.result().walks, solo.walks.numpy()[: len(seeds), :7])


class TestQuota:
    def test_over_quota_rejected_with_named_limit(self, graph):
        stream, clk = make_stream(graph, StreamConfig(
            tenant_quotas={"acme": TenantQuota(walkers_per_s=10, burst_walkers=20)}))
        stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="acme")
        with pytest.raises(AdmissionError) as ei:
            stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="acme")
        msg = str(ei.value)
        assert "tenant_quotas['acme'].walkers_per_s=10" in msg
        assert "burst_walkers=20" in msg
        assert stream.stats.stream_quota_rejections == 1
        # unmetered tenants (and tenant-less requests) are unaffected
        stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="other")
        stream.submit(np.arange(16), depth=4, spec=alg.deepwalk())
        assert stream.pending == 3
        stream.flush()

    def test_bucket_refills_over_time(self, graph):
        stream, clk = make_stream(graph, StreamConfig(
            tenant_quotas={"t": TenantQuota(walkers_per_s=100, burst_walkers=16)}))
        stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="t")
        with pytest.raises(AdmissionError):
            stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="t")
        clk.t = 0.16  # 100 walkers/s x 0.16s = 16 tokens back
        stream.submit(np.arange(16), depth=4, spec=alg.deepwalk(), tenant="t")
        assert stream.pending == 2
        stream.flush()

    def test_backpressure_limits_apply_to_backlog(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000),
                                  svc_config=ServiceConfig(max_pending_requests=2))
        stream.submit([0], depth=4, spec=alg.deepwalk())
        stream.submit([1], depth=4, spec=alg.deepwalk())
        with pytest.raises(AdmissionError, match="max_pending_requests=2"):
            stream.submit([2], depth=4, spec=alg.deepwalk())
        stream.flush()  # launching frees capacity
        stream.submit([2], depth=4, spec=alg.deepwalk())
        stream.flush()


class TestDelivery:
    def test_partial_failure_isolates_members(self, graph, monkeypatch):
        stream, clk = make_stream(graph, svc_config=ServiceConfig(fuse=False))
        f1 = stream.submit([0, 1], depth=4, spec=alg.deepwalk())
        f2 = stream.submit([2, 3], depth=4, spec=alg.deepwalk())  # same cohort
        f3 = stream.submit([4, 5], depth=4, spec=alg.node2vec())  # separate
        import repro_torch.serve.service as service_mod

        real = service_mod.random_walk
        calls = {"n": 0}

        def flaky(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected launch failure")
            return real(*args, **kwargs)

        monkeypatch.setattr(service_mod, "random_walk", flaky)
        stream.flush()
        assert f1.result().walks.shape == (2, 5)  # served before the failure
        with pytest.raises(DrainError) as ei:
            f2.result()
        assert "1/2 cohort members completed" in str(ei.value)
        assert sorted(ei.value.completed) == [f1.request_id]
        assert isinstance(ei.value.__cause__, RuntimeError)
        assert f3.result().walks.shape == (2, 5)  # other cohort unaffected
        assert stream.stats.stream_failed_requests == 1

    def test_fused_failure_fails_whole_cohort_only(self, graph, monkeypatch):
        stream, clk = make_stream(graph)
        f1 = stream.submit([0, 1], depth=4, spec=alg.deepwalk())
        f2 = stream.submit([2, 3], depth=4, spec=alg.node2vec())
        import repro_torch.serve.service as service_mod

        def boom(*args, **kwargs):
            raise RuntimeError("injected launch failure")

        monkeypatch.setattr(service_mod, "random_walk_segments", boom)
        stream.flush()
        for f in (f1, f2):
            exc = f.exception()
            assert isinstance(exc, DrainError)
            assert "0/1 cohort members completed" in str(exc)
            assert exc.completed == {}
        assert stream.stats.stream_failed_requests == 2

    def test_done_callbacks(self, graph):
        stream, clk = make_stream(graph)
        seen = []
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        f.add_done_callback(lambda fut: seen.append(("pre", fut.request_id)))
        stream.flush()
        f.add_done_callback(lambda fut: seen.append(("post", fut.request_id)))
        assert seen == [("pre", f.request_id), ("post", f.request_id)]

    def test_result_timeout(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000))
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        with pytest.raises(TimeoutError):
            f.result(timeout=0.01)
        stream.flush()
        assert f.result(timeout=0).walks.shape == (1, 5)


class TestLifecycle:
    def test_close_flush_serves_backlog(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000))
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        stream.close()
        assert f.result(timeout=0).walks.shape == (1, 5)

    def test_close_without_flush_cancels(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000))
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        stream.close(flush=False)
        with pytest.raises(DrainError, match="cancelled"):
            f.result(timeout=0)
        assert stream.pending == 0

    def test_submit_after_close_rejected(self, graph):
        stream, clk = make_stream(graph)
        stream.close()
        with pytest.raises(AdmissionError, match="closed"):
            stream.submit([0], depth=4, spec=alg.deepwalk())


class TestLatencyAccounting:
    def test_queue_and_total_latency_from_clock(self, graph):
        stream, clk = make_stream(graph, StreamConfig(max_batch_window_ms=1000))
        f = stream.submit([0], depth=4, spec=alg.deepwalk())
        clk.t = 0.050
        stream.flush()
        lat = f.latency
        assert lat.queue_ms == pytest.approx(50.0)
        assert lat.total_ms == pytest.approx(50.0)  # fake clock: 0ms launch
        assert lat.deadline_met is None
        assert stream.stats.stream_requests == 1
        assert stream.stats.stream_launches == 1
        assert stream.stats.stream_latencies == [lat]

    def test_deadline_miss_counted(self, graph):
        stream, clk = make_stream(graph)
        f = stream.submit([0], depth=4, spec=alg.deepwalk(), deadline_ms=10)
        clk.t = 1.0  # poll far too late: result lands past the deadline
        stream.poll()
        assert f.latency.deadline_met is False
        assert stream.stats.stream_deadline_misses == 1
        assert f.result(timeout=0).walks.shape == (1, 5)  # still served

    def test_launch_cost_ema(self, graph, monkeypatch):
        stream, clk = make_stream(graph, StreamConfig(launch_cost_prior_ms=25.0,
                                                      launch_cost_alpha=0.25))
        svc = stream._svc
        real = svc._run_cohort
        advance = {"by": 0.008}

        def timed(cohort, out):
            clk.t += advance["by"]
            return real(cohort, out)

        monkeypatch.setattr(svc, "_run_cohort", timed)
        spec = alg.deepwalk()
        assert stream.launch_cost_ms(spec, depth=4, width=1) == pytest.approx(25.0)
        stream.submit([0], depth=4, spec=spec)
        stream.flush()
        assert stream.launch_cost_ms(spec, depth=4, width=1) == pytest.approx(8.0)
        advance["by"] = 0.004
        stream.submit([1], depth=4, spec=spec)
        stream.flush()
        # EMA: 0.25 x 4ms + 0.75 x 8ms = 7ms
        assert stream.launch_cost_ms(spec, depth=4, width=1) == pytest.approx(7.0)

    def test_percentile(self):
        assert np.isnan(percentile([], 50))
        assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
        assert percentile([5.0], 99) == 5.0


class TestPlacements:
    def test_oom_streaming_merges_depths(self, graph):
        g = graph
        clk = FakeClock()
        svc = SamplingService(partitions=partition_by_vertex_range(g, 4),
                              total_vertices=g.num_vertices, device="cpu", oom_chunk=128)
        stream = StreamingSamplingService(svc, clock=clk, start=False)
        fa = stream.submit(np.arange(30), depth=4, spec=alg.deepwalk())
        fb = stream.submit(np.arange(20), depth=9, spec=alg.deepwalk())
        clk.t = 1.0
        assert stream.poll() == 1
        assert svc.stats.oom_launches == 1
        assert fa.result(timeout=0).walks.shape == (30, 5)
        assert fb.result(timeout=0).walks.shape == (20, 10)


class TestThreadMode:
    def test_background_scheduler_serves_bursts(self, graph):
        svc = SamplingService(graph, device="cpu", key=PRNGKey(3))
        with StreamingSamplingService(svc, StreamConfig(max_batch_window_ms=5)) as stream:
            futs = [stream.submit([i, i + 1], depth=4, spec=alg.deepwalk(), deadline_ms=300)
                    for i in range(4)]
            for f in futs:
                assert f.result(timeout=120).walks.shape == (2, 5)
        assert stream.pending == 0
        assert stream.stats.stream_requests == 4
        assert len(stream.stats.stream_latencies) == 4

    def test_thread_results_equal_unfused_service_and_prewarm_takes_the_lock(self, graph):
        """Launches from the scheduler thread give what the unfused batch
        service gives; a prewarm issued while the thread runs waits for the
        launch lock."""
        rng = np.random.default_rng(8)
        reqs = [(rng.integers(0, graph.num_vertices, int(rng.integers(9, 17))),
                 fold_in(PRNGKey(23), i)) for i in range(12)]
        svc = SamplingService(graph, device="cpu", key=PRNGKey(3),
                              config=ServiceConfig(max_requests_per_launch=4))
        with StreamingSamplingService(svc, StreamConfig(max_batch_window_ms=2)) as stream:
            assert not stream._launch_lock.locked()
            seen = []
            real = svc.prewarm
            svc.prewarm = lambda *a, **k: (seen.append(stream._launch_lock.locked()),
                                           real(*a, **k))[1]
            stream.prewarm(alg.deepwalk(), depth=8, width=16)
            futs = [stream.submit(s, depth=8, spec=alg.deepwalk(), key=k) for s, k in reqs]
            got = [f.result(timeout=120) for f in futs]
        assert seen == [True]
        assert stream._thread is None  # close() joined the scheduler
        base = SamplingService(graph, device="cpu", config=ServiceConfig(fuse=False))
        ids = [base.submit(s, depth=8, spec=alg.deepwalk(), key=k) for s, k in reqs]
        want = base.drain()
        for f, res, rid in zip(futs, got, ids):
            np.testing.assert_array_equal(res.walks, want[rid].walks)
        assert svc.stats.stream_failed_requests == 0


    def test_concurrent_submitters_stress(self, graph):
        """Submitters on more threads than cores against the scheduler
        thread, with a short switch interval: every request is admitted
        once, served once, and equals the unfused service's answer."""
        import os
        import sys
        import threading

        n_threads, per_thread = 2 * (os.cpu_count() or 4), 6
        rng = np.random.default_rng(12)
        reqs = [[(rng.integers(0, graph.num_vertices, int(rng.integers(1, 9))),
                  fold_in(PRNGKey(44), t * per_thread + j)) for j in range(per_thread)]
                for t in range(n_threads)]
        svc = SamplingService(graph, device="cpu", key=PRNGKey(3),
                              config=ServiceConfig(max_requests_per_launch=8))
        futs = [[] for _ in range(n_threads)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with StreamingSamplingService(svc, StreamConfig(max_batch_window_ms=1)) as stream:
                def submit(t):
                    for seeds, key in reqs[t]:
                        futs[t].append(stream.submit(seeds, depth=3, spec=alg.deepwalk(), key=key))

                threads = [threading.Thread(target=submit, args=(t,)) for t in range(n_threads)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                assert not any(th.is_alive() for th in threads)
                got = [[f.result(timeout=120) for f in fs] for fs in futs]
        finally:
            sys.setswitchinterval(old)
        n = n_threads * per_thread
        ids = [f.request_id for fs in futs for f in fs]
        assert len(set(ids)) == n and svc.stats.stream_requests == n
        assert svc.stats.requests_served == n and len(svc.stats.stream_latencies) == n
        assert svc.stats.stream_failed_requests == 0
        base = SamplingService(graph, device="cpu", config=ServiceConfig(fuse=False))
        flat = [r for rs in reqs for r in rs]
        bids = [base.submit(seeds, depth=3, spec=alg.deepwalk(), key=key) for seeds, key in flat]
        want = base.drain()
        for res, rid in zip([r for rs in got for r in rs], bids):
            np.testing.assert_array_equal(res.walks, want[rid].walks)


# ---------------------------------------------------------------------------
# Cross-package parity: one fake-clock script, two services
# ---------------------------------------------------------------------------


def _script(pkg, prio, quota, n_vertices):
    """The clock script: (time, submit kwargs or None for a poll) — mixed
    specs (node2vec from one factory call), priorities, deadlines, window-
    bound requests, a tenant over quota, and a fill."""
    specs = [pkg.deepwalk(), pkg.weighted_random_walk(), pkg.node2vec(), pkg.deepwalk()]
    rng = np.random.default_rng(13)
    steps = []
    t = 0.0
    for i in range(18):
        t += float(rng.choice([0.001, 0.004, 0.012]))
        tier = [prio.INTERACTIVE, prio.STANDARD, prio.BULK][i % 3]
        deadline = {0: 15.0, 1: None, 2: 300.0}[i % 3]
        kw = dict(seeds=rng.integers(0, n_vertices, int(rng.integers(3, 20))),
                  depth=int(rng.choice([3, 6, 9])), spec=specs[i % 4],
                  deadline_ms=deadline, priority=tier,
                  tenant="metered" if i % 5 == 0 else None, key_index=i if i % 2 else None)
        steps.append((t, kw))
        if i % 3 == 2:
            steps.append((t + 0.002, None))
    steps.append((t + 0.003, None))  # bulk requests still forming: flush() takes them
    return steps, {"metered": quota(walkers_per_s=50.0, burst_walkers=20.0)}


def _drive(stream, clk, steps, key_of, admission_error):
    launches, futs, rejected = [], {}, []
    real = stream._execute

    def recording(cohort, members, reason):
        launches.append((reason, [p.req.request_id for p in members]))
        return real(cohort, members, reason)

    stream._execute = recording
    for t, kw in steps:
        clk.t = t
        if kw is None:
            stream.poll()
            continue
        kw = dict(kw)
        idx = kw.pop("key_index")
        seeds = kw.pop("seeds")
        try:
            f = stream.submit(seeds, key=None if idx is None else key_of(idx), **kw)
            futs[f.request_id] = f
        except admission_error as e:
            rejected.append(str(e))
    stream.flush()
    return launches, {rid: f.result(timeout=0) for rid, f in futs.items()}, rejected


@pytest.mark.parametrize("placement", ["memory", "oom"])
@pytest.mark.parametrize("batching", [True, False], ids=["batching", "per_request"])
def test_stream_equals_repro(graphs, placement, batching):
    g, tg = graphs
    jsteps, jquotas = _script(jalg, JPriority, JTenantQuota, g.num_vertices)
    tsteps, tquotas = _script(alg, Priority, TenantQuota, g.num_vertices)
    cfg = dict(max_batch_window_ms=8.0, slack_factor=1.5, launch_cost_prior_ms=4.0,
               batching=batching)
    svc_cfg = dict(max_requests_per_launch=3)
    if placement == "memory":
        jsvc = JSamplingService(g, backend="reference", key=jax.random.PRNGKey(11),
                                config=JServiceConfig(**svc_cfg))
        tsvc = SamplingService(tg, device="cpu", key=PRNGKey(11), config=ServiceConfig(**svc_cfg))
    else:
        jsvc = JSamplingService(partitions=j_partition(g, 4), total_vertices=g.num_vertices,
                                backend="reference", oom_chunk=128, key=jax.random.PRNGKey(11),
                                config=JServiceConfig(**svc_cfg))
        tsvc = SamplingService(partitions=partition_by_vertex_range(tg, 4),
                               total_vertices=tg.num_vertices, device="cpu", oom_chunk=128,
                               key=PRNGKey(11), config=ServiceConfig(**svc_cfg))
    jclk, tclk = FakeClock(), FakeClock()
    jstream = JStreaming(jsvc, JStreamConfig(tenant_quotas=jquotas, **cfg), clock=jclk,
                         start=False)
    tstream = StreamingSamplingService(tsvc, StreamConfig(tenant_quotas=tquotas, **cfg),
                                       clock=tclk, start=False)
    jl, jres, jrej = _drive(jstream, jclk, jsteps,
                            lambda i: jax.random.fold_in(jax.random.PRNGKey(23), i),
                            JAdmissionError)
    tl, tres, trej = _drive(tstream, tclk, tsteps, lambda i: fold_in(PRNGKey(23), i),
                            AdmissionError)
    assert tl == jl
    assert trej == jrej and len(trej) > 0  # the metered tenant ran out
    assert {r for r, _ in tl} == ({"fill", "slack", "window", "flush"} if batching
                                   else {"immediate"})
    assert sorted(tres) == sorted(jres)
    for rid in tres:
        np.testing.assert_array_equal(tres[rid].walks, np.asarray(jres[rid].walks))
        assert tres[rid].sampled_edges == jres[rid].sampled_edges
    td, jd = dataclasses.asdict(tsvc.stats), dataclasses.asdict(jsvc.stats)
    td["stream_latencies"] = [tuple(x) for x in td["stream_latencies"]]
    jd["stream_latencies"] = [tuple(x) for x in jd["stream_latencies"]]
    assert td == jd
