"""The port's batch sampling service (``repro_torch.serve``) on the CPU.

Every contract of ``tests/test_serve.py`` held by the port: admission and
back-pressure, cohort formation and its FIFO ordering, fused = unfused =
standalone padded walks, the out-of-memory route with per-request depth
limits, prewarm invisibility and the drain-failure requeue.  The sharded
placement's contracts are held in ``test_torch_shard.py``.

Then the cross-package parity: the same requests (seeds, depths, specs
from each package's factories, the same key words or no key at all) go
through ``repro``'s ``SamplingService(backend="reference")`` and the
port's on the CPU; every request's walks, lengths and sampled edges, and
every ``ServiceStats`` field, must be equal — fused, unfused and
out-of-memory.  Exact tolerance throughout (vertex ids).
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
from repro.serve import SamplingService as JSamplingService  # noqa: E402
from repro.serve import ServiceConfig as JServiceConfig  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.engine import random_walk, random_walk_segments  # noqa: E402
from repro_torch.core.oom import oom_random_walk  # noqa: E402
from repro_torch.core.rng import PRNGKey, fold_in, split  # noqa: E402
from repro_torch.graph import csr_from_arrays, partition_by_vertex_range  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    DrainError,
    RequestQueue,
    SamplingRequest,
    SamplingService,
    ServiceConfig,
    cohort_key,
)
from repro_torch.serve.queue import _pow2_bucket  # noqa: E402


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


def _mixed_requests(svc, g, n_requests=9, seed=11):
    """Submit a heterogeneous burst; returns {rid: (seeds, depth, spec)}."""
    rng = np.random.default_rng(seed)
    specs = [alg.deepwalk(), alg.weighted_random_walk(), alg.node2vec()]
    subs = {}
    for i in range(n_requests):
        spec = specs[i % len(specs)]
        seeds = rng.integers(0, g.num_vertices, int(rng.integers(4, 40)))
        depth = int(rng.integers(2, 12))
        rid = svc.submit(seeds, depth=depth, spec=spec)
        subs[rid] = (seeds, depth, spec)
    return subs


def _assert_walks_valid(g, walks):
    ip, ind = g.indptr.numpy(), g.indices.numpy()
    for row in np.asarray(walks):
        for a, b in zip(row[:-1], row[1:]):
            if a < 0 or b < 0:
                break
            assert b in ind[ip[a] : ip[a + 1]], (a, b)


def _req(rid, n, depth, spec, key=0):
    return SamplingRequest(
        request_id=rid, seeds=np.zeros(n, np.int32), depth=depth, spec=spec,
        key=PRNGKey(key),
    )


def _service(g, **kw):
    return SamplingService(g, device="cpu", **kw)


class TestRequestQueue:
    def test_admission_rejects_malformed(self):
        q = RequestQueue(ServiceConfig(max_walkers_per_request=64, max_depth=16))
        with pytest.raises(AdmissionError):  # empty seeds
            q.submit(_req(0, 0, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError):  # oversized request
            q.submit(_req(1, 65, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError):  # depth out of range
            q.submit(_req(2, 4, 17, alg.deepwalk()))
        with pytest.raises(AdmissionError):  # zero depth
            q.submit(_req(3, 4, 0, alg.deepwalk()))
        assert len(q) == 0

    def test_admission_backpressure(self):
        q = RequestQueue(ServiceConfig(max_pending_requests=2))
        q.submit(_req(0, 4, 4, alg.deepwalk()))
        q.submit(_req(1, 4, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError):
            q.submit(_req(2, 4, 4, alg.deepwalk()))
        qw = RequestQueue(ServiceConfig(max_pending_walkers=10))
        qw.submit(_req(0, 8, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError):
            qw.submit(_req(1, 8, 4, alg.deepwalk()))
        qw.take_cohorts()  # draining frees capacity
        qw.submit(_req(1, 8, 4, alg.deepwalk()))
        assert qw.pending_walkers == 8

    def test_cohorts_never_mix_programs(self):
        q = RequestQueue(ServiceConfig())
        for r in [
            _req(0, 8, 4, alg.deepwalk()),
            _req(1, 8, 4, alg.weighted_random_walk()),
            _req(2, 8, 4, alg.node2vec()),
            _req(3, 8, 4, alg.deepwalk()),
            _req(4, 8, 4, alg.metropolis_hastings_walk()),
        ]:
            q.submit(r)
        cohorts = q.take_cohorts()
        for c in cohorts:
            keys = {cohort_key(r.spec) for r in c.requests}
            assert len(keys) == 1 and next(iter(keys)) == c.key
        # the two deepwalk requests DO fuse; the rest are singletons
        assert sorted(len(c.requests) for c in cohorts) == [1, 1, 1, 2]

    def test_equal_programs_from_separate_factory_calls_fuse(self):
        # module-level flat-bias hooks => equal lowered programs
        assert cohort_key(alg.deepwalk()) == cohort_key(alg.deepwalk())
        assert cohort_key(alg.weighted_random_walk()) == cohort_key(alg.weighted_random_walk())
        assert cohort_key(alg.biased_random_walk()) == cohort_key(alg.biased_random_walk())
        # node2vec closes its hook per call => distinct programs, no fusion
        assert cohort_key(alg.node2vec()) != cohort_key(alg.node2vec())
        n2v = alg.node2vec()
        assert cohort_key(n2v) == cohort_key(n2v)

    def test_shape_buckets_split_and_pad(self):
        q = RequestQueue(ServiceConfig(min_walker_bucket=8, min_depth_bucket=4))
        q.submit(_req(0, 5, 3, alg.deepwalk()))  # -> (8, 4)
        q.submit(_req(1, 8, 4, alg.deepwalk()))  # -> (8, 4) fuses with 0
        q.submit(_req(2, 9, 4, alg.deepwalk()))  # width 16: separate cohort
        q.submit(_req(3, 8, 5, alg.deepwalk()))  # depth 8: separate cohort
        geo = sorted((c.width, c.depth, len(c.requests)) for c in q.take_cohorts())
        assert geo == [(8, 4, 2), (8, 8, 1), (16, 4, 1)]

    def test_max_requests_per_launch_splits(self):
        q = RequestQueue(ServiceConfig(max_requests_per_launch=4))
        for i in range(10):
            q.submit(_req(i, 8, 4, alg.deepwalk()))
        assert sorted(len(c.requests) for c in q.take_cohorts()) == [2, 4, 4]

    def test_oom_grouping_merges_depths(self):
        q = RequestQueue(ServiceConfig())
        q.submit(_req(0, 8, 3, alg.deepwalk()))
        q.submit(_req(1, 40, 11, alg.deepwalk()))
        (c,) = q.take_cohorts(bucket_by_shape=False)
        assert len(c.requests) == 2 and c.depth >= 11 and c.width == 40

    def test_admission_errors_name_violated_limits(self):
        q = RequestQueue(ServiceConfig(
            max_walkers_per_request=64, max_depth=16,
            max_pending_requests=1, max_pending_walkers=10,
        ))
        with pytest.raises(AdmissionError, match="max_walkers_per_request=64"):
            q.submit(_req(0, 65, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError, match="max_depth=16"):
            q.submit(_req(1, 4, 17, alg.deepwalk()))
        q.submit(_req(2, 4, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError, match="max_pending_requests=1"):
            q.submit(_req(3, 4, 4, alg.deepwalk()))
        qw = RequestQueue(ServiceConfig(max_pending_walkers=10))
        qw.submit(_req(0, 8, 4, alg.deepwalk()))
        with pytest.raises(AdmissionError, match="max_pending_walkers=10"):
            qw.submit(_req(1, 8, 4, alg.deepwalk()))

    def test_take_cohorts_ordering_contract(self):
        def feed(q):
            q.submit(_req(0, 8, 4, alg.deepwalk()))
            q.submit(_req(1, 8, 4, alg.weighted_random_walk()))
            q.submit(_req(2, 8, 4, alg.deepwalk()))
            q.submit(_req(3, 40, 4, alg.deepwalk()))  # width 64: own cohort
            q.submit(_req(4, 8, 4, alg.weighted_random_walk()))
            q.submit(_req(5, 8, 4, alg.deepwalk()))
            return [[r.request_id for r in c.requests] for c in q.take_cohorts()]

        got = feed(RequestQueue(ServiceConfig()))
        assert got == [[0, 2, 5], [1, 4], [3]]
        assert feed(RequestQueue(ServiceConfig())) == got

    def test_take_cohorts_split_groups_stay_in_member_order(self):
        q = RequestQueue(ServiceConfig(max_requests_per_launch=2))
        for i in range(5):
            q.submit(_req(i, 8, 4, alg.deepwalk()))
        got = [[r.request_id for r in c.requests] for c in q.take_cohorts()]
        assert got == [[0, 1], [2, 3], [4]]


class TestFusedParity:
    def test_fused_matches_per_request_engine_calls(self, graph):
        """Fused multi-request results equal standalone ``random_walk``
        calls at the cohort's padded geometry."""
        g = graph
        svc = _service(g)
        rng = np.random.default_rng(11)
        specs = [alg.deepwalk(), alg.weighted_random_walk(), alg.node2vec()]
        subs = {}
        for i in range(6):
            spec = specs[i % len(specs)]
            seeds = rng.integers(0, g.num_vertices, int(rng.integers(4, 40)))
            depth = int(rng.integers(2, 12))
            key = fold_in(PRNGKey(42), i)
            rid = svc.submit(seeds, depth=depth, spec=spec, key=key)
            subs[rid] = (seeds, depth, spec, key)
        results = svc.drain()
        assert sorted(results) == sorted(subs)
        cfg = svc.config
        for rid, (seeds, depth, spec, key) in subs.items():
            width = _pow2_bucket(len(seeds), cfg.min_walker_bucket)
            depth_b = _pow2_bucket(depth, cfg.min_depth_bucket)
            row = np.full((width,), -1, np.int32)
            row[: len(seeds)] = seeds
            solo = random_walk(g, row, key, depth=depth_b, spec=spec,
                               max_degree=g.max_degree(), device="cpu")
            expect = solo.walks.numpy()[: len(seeds), : depth + 1]
            np.testing.assert_array_equal(results[rid].walks, expect)

    def test_fused_matches_unfused_service(self, graph):
        g = graph
        runs = []
        for fuse in (True, False):
            svc = _service(g, key=PRNGKey(5), config=ServiceConfig(fuse=fuse))
            _mixed_requests(svc, g, n_requests=6)
            runs.append(svc.drain())
        fused, seq = runs
        assert sorted(fused) == sorted(seq)
        for rid in fused:
            np.testing.assert_array_equal(fused[rid].walks, seq[rid].walks)
            np.testing.assert_array_equal(fused[rid].lengths, seq[rid].lengths)
            assert fused[rid].sampled_edges == seq[rid].sampled_edges

    def test_fused_uses_fewer_launches(self, graph):
        g = graph
        svc = _service(g)
        rng = np.random.default_rng(0)
        for _ in range(8):  # homogeneous: all 8 fuse into one launch
            svc.submit(rng.integers(0, g.num_vertices, 16), depth=4, spec=alg.deepwalk())
        svc.drain()
        assert svc.stats.requests_served == 8
        assert svc.stats.launches == 1

    def test_results_are_valid_walks(self, graph):
        g = graph
        svc = _service(g)
        subs = _mixed_requests(svc, g, n_requests=5)
        results = svc.drain()
        for rid, (seeds, depth, _) in subs.items():
            r = results[rid]
            assert r.walks.shape == (len(seeds), depth + 1)
            np.testing.assert_array_equal(r.walks[:, 0], seeds.astype(np.int32))
            assert int(r.lengths.max()) <= depth + 1
            _assert_walks_valid(g, r.walks)


class TestSegmentsEngine:
    def test_rows_match_standalone(self, graph):
        g = graph
        keys = np.stack([fold_in(PRNGKey(2), r) for r in range(3)])
        seeds = np.random.default_rng(3).integers(0, g.num_vertices, (3, 16))
        spec = alg.node2vec()
        fused = random_walk_segments(g, seeds, keys, depth=5, spec=spec,
                                     max_degree=g.max_degree(), device="cpu")
        assert tuple(fused.walks.shape) == (3, 16, 6)
        for r in range(3):
            solo = random_walk(g, seeds[r], keys[r], depth=5, spec=spec,
                               max_degree=g.max_degree(), device="cpu")
            assert torch.equal(fused.walks[r], solo.walks)
            assert int(fused.sampled_edges[r]) == int(solo.sampled_edges)


class TestOOMService:
    def test_oom_routed_requests(self, graph):
        """Partitioned service: heterogeneous requests merge into one
        frontier-queue drain; every walk is a real path that stops at its
        own request's depth."""
        g = graph
        svc = SamplingService(partitions=partition_by_vertex_range(g, 4),
                              total_vertices=g.num_vertices, device="cpu", oom_chunk=128)
        rng = np.random.default_rng(1)
        a = svc.submit(rng.integers(0, g.num_vertices, 30), depth=4, spec=alg.deepwalk())
        b = svc.submit(rng.integers(0, g.num_vertices, 20), depth=9, spec=alg.deepwalk())
        c = svc.submit(rng.integers(0, g.num_vertices, 10), depth=9, spec=alg.node2vec())
        results = svc.drain()
        # deepwalk requests with different depths share ONE scheduler pass
        assert svc.stats.oom_launches == 2
        for rid, depth in ((a, 4), (b, 9), (c, 9)):
            r = results[rid]
            assert r.walks.shape[1] == depth + 1
            _assert_walks_valid(g, r.walks)
        assert int(results[a].lengths.max()) <= 5
        assert int(results[b].lengths.max()) == 10

    def test_oom_depth_limits_direct(self, graph):
        g = graph
        parts = partition_by_vertex_range(g, 4)
        seeds = np.random.default_rng(0).integers(0, g.num_vertices, 48)
        limits = np.random.default_rng(1).integers(1, 8, 48)
        walks, _ = oom_random_walk(
            parts, g.num_vertices, seeds, PRNGKey(0), depth=8, spec=alg.deepwalk(),
            max_degree=g.max_degree(), chunk=128, depth_limits=limits, device="cpu",
        )
        lengths = (walks >= 0).sum(axis=1)
        assert (lengths <= limits + 1).all()

    def test_service_seed_range_admission(self, graph):
        g = graph
        svc = _service(g)
        with pytest.raises(AdmissionError):
            svc.submit([g.num_vertices], depth=4, spec=alg.deepwalk())
        with pytest.raises(AdmissionError):
            svc.submit([-1], depth=4, spec=alg.deepwalk())
        assert svc.pending == 0

    def test_oom_depth_limits_range_validated(self, graph):
        g = graph
        with pytest.raises(ValueError):
            oom_random_walk(
                partition_by_vertex_range(g, 4), g.num_vertices, np.arange(8), PRNGKey(0),
                depth=4, spec=alg.deepwalk(), max_degree=g.max_degree(),
                depth_limits=np.full(8, 9), device="cpu",
            )

    def test_oom_requests_equal_their_slice_of_a_direct_call(self, graph):
        """What the card's smoke checks: one cohort is one
        ``oom_random_walk`` call under the service's first launch key, each
        request a slice of its flat instance axis."""
        g = graph
        parts = partition_by_vertex_range(g, 4)
        svc = SamplingService(partitions=parts, total_vertices=g.num_vertices, device="cpu",
                              key=PRNGKey(9), oom_chunk=128)
        rng = np.random.default_rng(4)
        subs = [(rng.integers(0, g.num_vertices, 16), int(rng.choice([4, 8, 16])))
                for _ in range(6)]
        rids = [svc.submit(s, depth=d, spec=alg.biased_random_walk()) for s, d in subs]
        results = svc.drain()
        assert svc.stats.oom_launches == 1
        seeds = np.full(128, -1, np.int32)
        limits = np.zeros(128, np.int32)
        for i, (s, d) in enumerate(subs):
            seeds[16 * i : 16 * i + 16], limits[16 * i : 16 * i + 16] = s, d
        launch_key = fold_in(split(PRNGKey(9))[1], 1)  # the OOM stream's first launch
        walks, _ = oom_random_walk(parts, g.num_vertices, seeds, launch_key, depth=16,
                                   spec=alg.biased_random_walk(), max_degree=svc.max_degree,
                                   depth_limits=limits, chunk=128, device="cpu")
        for i, (rid, (s, d)) in enumerate(zip(rids, subs)):
            np.testing.assert_array_equal(results[rid].walks, walks[16 * i : 16 * i + 16, : d + 1])


class TestPrewarm:
    def _drain_one(self, svc, g, n=12, depth=6):
        rid = svc.submit(np.arange(n) % g.num_vertices, depth=depth, spec=alg.deepwalk())
        return svc.drain()[rid]

    def test_memory_prewarm_records_placement_and_stays_invisible(self, graph):
        g = graph
        cold = _service(g, key=PRNGKey(4))
        warm = _service(g, key=PRNGKey(4))
        methods = warm.prewarm(alg.deepwalk(), depth=6, width=12)
        warm.prewarm(alg.deepwalk(), depth=6, width=12)  # idempotent
        assert len(methods) > 0
        assert warm.stats.prewarmed_placements == ("memory",)
        assert warm.stats.plans_prewarmed == 2
        assert warm.stats.launches == 0  # the warm launch is not counted
        np.testing.assert_array_equal(self._drain_one(warm, g).walks,
                                      self._drain_one(cold, g).walks)

    def test_partitioned_prewarm(self, graph):
        g = graph
        parts = partition_by_vertex_range(g, 4)
        mk = lambda: SamplingService(  # noqa: E731
            partitions=parts, total_vertices=g.num_vertices, device="cpu",
            oom_chunk=128, key=PRNGKey(4),
        )
        cold, warm = mk(), mk()
        assert warm.prewarm(alg.deepwalk(), depth=6, width=12) == ()
        assert warm.stats.prewarmed_placements == ("oom",)
        # no launch key consumed: the first real drain samples identically
        np.testing.assert_array_equal(self._drain_one(warm, g).walks,
                                      self._drain_one(cold, g).walks)
        assert warm.stats.oom_launches == 1  # only the real drain counted

    def test_partitioned_prewarm_builds_every_partition_table(self, graph):
        """The OOM prewarm builds each partition's host plan and tables,
        which the drain would otherwise build at the partition's first
        residency, and a walk after it samples as a cold one."""
        from repro_torch.core import oom

        g = graph
        parts = partition_by_vertex_range(g, 4)
        spec = alg.biased_random_walk()
        oom._PLAN_CACHE.clear()
        svc = SamplingService(partitions=parts, total_vertices=g.num_vertices, device="cpu",
                              oom_chunk=128, key=PRNGKey(4))
        assert svc.prewarm(spec) == () and svc.stats.plans_prewarmed == 0  # as repro
        plans = {k[0]: v for k, v in oom._PLAN_CACHE.items()}
        assert set(plans) == {p.uid for p in parts}
        assert all("prob" in plan._host for plan in plans.values())  # biased -> alias
        methods = oom.prewarm_plans(parts, g.num_vertices, spec, device="cpu")
        assert "alias" in methods and len(oom._PLAN_CACHE) == len(parts)  # cached, not rebuilt
        assert oom.prewarm_plans(parts, g.num_vertices, alg.node2vec(), device="cpu") == ()
        warm = self._drain_one(svc, g)
        oom._PLAN_CACHE.clear()
        cold = SamplingService(partitions=parts, total_vertices=g.num_vertices, device="cpu",
                               oom_chunk=128, key=PRNGKey(4))
        np.testing.assert_array_equal(warm.walks, self._drain_one(cold, g).walks)


class TestRobustness:
    def test_submit_copies_seeds(self, graph):
        g = graph
        svc = _service(g)
        a = np.zeros(8, np.int32)
        rid = svc.submit(a, depth=4, spec=alg.deepwalk())
        a[:] = 10**9
        res = svc.drain()[rid]
        np.testing.assert_array_equal(res.walks[:, 0], np.zeros(8, np.int32))

    def test_drain_failure_requeues_and_keeps_completed(self, graph, monkeypatch):
        g = graph
        svc = _service(g)
        a = svc.submit([0, 1], depth=4, spec=alg.deepwalk())
        b = svc.submit([2, 3], depth=4, spec=alg.node2vec())  # separate cohort
        import repro_torch.serve.service as service_mod

        real = service_mod.random_walk_segments
        calls = {"n": 0}

        def flaky(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected launch failure")
            return real(*args, **kwargs)

        monkeypatch.setattr(service_mod, "random_walk_segments", flaky)
        with pytest.raises(DrainError) as ei:
            svc.drain()
        completed = ei.value.completed
        assert len(completed) == 1
        assert svc.pending == 1  # the failed cohort's request is back
        served = {**completed, **svc.drain()}
        assert sorted(served) == sorted([a, b])
        for rid in (a, b):
            assert served[rid].walks.shape == (2, 5)

    def test_device_defaults_to_cuda_and_raises_without_a_card(self, graph, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SamplingService(graph)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SamplingService(partitions=partition_by_vertex_range(graph, 2),
                            total_vertices=graph.num_vertices)

    def test_seeds_as_tensors_and_results_on_the_host(self, graph):
        svc = _service(graph, key=PRNGKey(1))
        ref = _service(graph, key=PRNGKey(1))
        a = svc.submit(torch.arange(5, dtype=torch.int64), depth=3, spec=alg.deepwalk())
        b = ref.submit(np.arange(5), depth=3, spec=alg.deepwalk())
        got, want = svc.drain()[a], ref.drain()[b]
        assert isinstance(got.walks, np.ndarray) and got.walks.dtype == np.int32
        np.testing.assert_array_equal(got.walks, want.walks)


# ---------------------------------------------------------------------------
# Cross-package parity: repro's reference service and the port's, request by
# request and counter by counter
# ---------------------------------------------------------------------------


def _parity_requests(n_vertices, seed=21):
    """(spec name, seeds, depth, key index or None) for a mixed burst: three
    programs, several width and depth buckets, node2vec from one factory
    call (so its requests fuse)."""
    rng = np.random.default_rng(seed)
    names = ["deepwalk", "weighted", "node2vec", "deepwalk", "biased"]
    out = []
    for i in range(10):
        n = int(rng.integers(3, 30))
        out.append((names[i % len(names)], rng.integers(0, n_vertices, n),
                    int(rng.integers(1, 12)), i))
    return out


def _specs(pkg):
    return {"deepwalk": pkg.deepwalk(), "weighted": pkg.weighted_random_walk(),
            "node2vec": pkg.node2vec(), "biased": pkg.biased_random_walk()}


def _asdict(stats):
    d = dataclasses.asdict(stats)
    d["stream_latencies"] = [tuple(x) for x in d["stream_latencies"]]
    return d


@pytest.mark.parametrize("placement", ["fused", "unfused", "oom"])
@pytest.mark.parametrize("keyed", [True, False], ids=["keys", "no_keys"])
def test_service_equals_repro(graphs, placement, keyed):
    g, tg = graphs
    jspecs, tspecs = _specs(jalg), _specs(alg)
    if placement == "oom":
        js = JSamplingService(partitions=j_partition(g, 4), total_vertices=g.num_vertices,
                              backend="reference", oom_chunk=128, key=jax.random.PRNGKey(3))
        ts = SamplingService(partitions=partition_by_vertex_range(tg, 4),
                             total_vertices=tg.num_vertices, device="cpu", oom_chunk=128,
                             key=PRNGKey(3))
    else:
        fuse = placement == "fused"
        cfg = dict(max_requests_per_launch=3, fuse=fuse)
        js = JSamplingService(g, backend="reference", config=JServiceConfig(**cfg))
        ts = SamplingService(tg, device="cpu", config=ServiceConfig(**cfg))
    js.prewarm(jspecs["deepwalk"])
    ts.prewarm(tspecs["deepwalk"])
    rids = []
    for name, seeds, depth, i in _parity_requests(g.num_vertices):
        jkey = jax.random.fold_in(jax.random.PRNGKey(42), i) if keyed else None
        tkey = np.asarray(jkey) if keyed else None
        a = js.submit(seeds, depth=depth, spec=jspecs[name], key=jkey)
        b = ts.submit(seeds, depth=depth, spec=tspecs[name], key=tkey)
        assert a == b
        rids.append(a)
    jres, tres = js.drain(), ts.drain()
    assert sorted(jres) == sorted(tres) == rids
    for rid in rids:
        np.testing.assert_array_equal(tres[rid].walks, np.asarray(jres[rid].walks))
        np.testing.assert_array_equal(tres[rid].lengths, np.asarray(jres[rid].lengths))
        assert tres[rid].sampled_edges == jres[rid].sampled_edges
    assert _asdict(ts.stats) == _asdict(js.stats)
