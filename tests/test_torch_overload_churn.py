"""The port's overload control (``repro_torch.core.overload``) and
instance churn (``Router.mark_failed`` / ``mark_drained`` /
``mark_recovered``, the factory's ``on_instance_failed``, the
simulator's fail/drain/recover events and retraction) against the JAX
package's, on the CPU.

Ports of the simulator cases of ``tests/test_chaos.py``: mid-run churn
recovers; churn fates are identical across backends (serial and thread;
process marked ``process``) and the index equals a rebuild from the
radix trees afterwards; churn telemetry is counted exactly once; with
every control off the decisions are the frozen scalar reference's; the
controls change nothing at low load; a hardware class's outage sheds its
requests and the class rejoins.

Beyond them, parity: ``ClusterSim`` with ``OverloadControl(admission,
retraction)`` (and retraction alone) under a fail/drain/recover schedule
gives the reference's finished tuples, dropped requests (reason and
time), ``overload_stats()`` and ``churn_recovery`` exactly.  Arrivals
are rounded to a tick so that waves form: the port sends each wave of
two or more through ``route_score``'s plain version while every
instance is live, and never while one is down (the wave path resumes
after recovery, from a mirror that took the zeroed columns).  The
reference routes its waves request by request (its router's
``route_batch`` replaced, so that its admission gate still runs), or
through its own wave path under the jax 0.9 ``enable_x64`` shim.
``router_from_numpy_state(alive=...)`` carries a mid-churn state over.
"""
import collections
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scalar_ref import make_scalar_policy  # noqa: E402
import repro_torch.cluster.metrics as tmetrics  # noqa: E402
import repro_torch.cluster.simulator as tsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.prefix_index import AggregatedPrefixIndex  # noqa: E402
from repro_torch.kernels import route_score  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402
import repro.cluster.metrics as rmetrics  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
TICK = 0.1


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture(scope="module")
def spec():
    return tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES)


def rspec():
    return rcore.spec_from_config(ref_config("qwen2_7b"))


def quantize(trace, tick=TICK):
    for r in trace:
        r.arrival = round(r.arrival / tick) * tick
    trace.sort(key=lambda r: r.arrival)
    return trace


def fates(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish,
             r.retries) for r in done]


def drops(sim):
    return [(r.rid, r.drop_reason, r.t_drop, r.prefill_done)
            for r in sim.dropped]


def sequential(router):
    """Route the reference's waves request by request (its wave path
    needs the x64 shim); the admission gate and obs hooks in
    ``_on_arrivals`` still run."""
    router.route_batch = lambda reqs, now: [router.route(r, now)
                                            for r in reqs]
    return router


class Waves:
    """Records each ``route_batch`` call of a port router: its size and
    whether every instance was live, and checks that ``route_score`` is
    never called while one is not."""

    def __init__(self, router, monkeypatch):
        self.calls = []
        self.submits = 0
        inner = router.route_batch

        def route_batch(reqs, now):
            self.calls.append((len(reqs), router.policy.alive is None))
            return inner(reqs, now)
        router.route_batch = route_batch
        submit = route_score.route_wave_submit

        def counted(*a):
            assert router.policy.alive is None, "scored with one down"
            self.submits += 1
            return submit(*a)
        monkeypatch.setattr(route_score, "route_wave_submit", counted)

    def live_waves(self):
        """Waves of two or more routed while every instance was live."""
        return sum(1 for k, live in self.calls if k > 1 and live)


def _assert_index_matches_rebuild(factory):
    """The live aggregated index equals a from-scratch flat rebuild over
    the per-instance radix trees."""
    fresh = AggregatedPrefixIndex(factory.n)
    probes = []
    for inst in factory.instances:
        for chain in inst.kv.chains():
            fresh.add(inst.iid, chain)
        probes.extend(tuple(c) for c in list(inst.kv.chains())[:3])
    rng = np.random.default_rng(3)
    probes += [tuple(int(x) for x in rng.integers(0, 50, size=5))
               for _ in range(8)]
    assert np.array_equal(fresh.match_depths_many(probes),
                          factory._agg.match_depths_many(probes))


# ---------------------------------------------------------------------------
# ports of tests/test_chaos.py
# ---------------------------------------------------------------------------
def _churn_run(spec, n_shards=1, walk_backend=None, n=16, obs=None):
    trace = ttraces.make_trace("chatbot", qps=16.0, duration=72.0, seed=21)
    router = tcore.Router(tcore.make_policy("lmetric"), n,
                          kv_capacity_tokens=200_000, n_shards=n_shards,
                          walk_backend=walk_backend, obs=obs, device="cpu")
    sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec))
    sim.fail_at(30.0, 2)
    sim.fail_at(45.0, 7)
    sim.recover_at(60.0, 2)
    sim.recover_at(60.0, 7)
    done = sim.run(copy.deepcopy(trace))
    return trace, router, sim, done


def test_mid_run_churn_recovers(spec):
    trace, router, sim, done = _churn_run(spec)
    with router:
        assert len(done) == len(trace)
        assert len(sim.churn_events) == 4
        orphans = [r for r in done if r.retries > 0]
        assert orphans
        assert len(sim.churn_recovery) == len(orphans)
        assert all(lat > 0.0 for lat in sim.churn_recovery)
        for r in done:
            if 30.0 <= r.t_sched < 60.0:
                assert r.sched_to != 2
            if 45.0 <= r.t_sched < 60.0:
                assert r.sched_to != 7
        assert router.policy.alive is None
        late = [r for r in done if r.t_sched >= 60.0]
        assert {r.sched_to for r in late} & {2, 7}


@pytest.mark.parametrize("n_shards", [1, 4])
def test_churn_decisions_identical_across_backends(spec, n_shards):
    got = {}
    for backend in (None, "thread"):
        _, router, _, done = _churn_run(spec, n_shards=n_shards,
                                        walk_backend=backend)
        with router:
            got[backend] = [(r.rid, r.sched_to, r.hit_tokens, r.retries)
                            for r in done]
            _assert_index_matches_rebuild(router.factory)
    assert got["thread"] == got[None]


@pytest.mark.process
def test_churn_decisions_identical_process_backend(spec):
    _, router, _, done = _churn_run(spec, n_shards=4)
    want = [(r.rid, r.sched_to, r.hit_tokens, r.retries) for r in done]
    _, router, _, done = _churn_run(spec, n_shards=4,
                                    walk_backend="process")
    with router:
        assert [(r.rid, r.sched_to, r.hit_tokens, r.retries)
                for r in done] == want
        _assert_index_matches_rebuild(router.factory)


def test_churn_telemetry_exactly_once_through_sim(spec):
    obs = make_obs(metrics=True, trace=True, sample_every=1)
    trace, router, sim, done = _churn_run(spec, obs=obs)
    with router:
        assert len(done) == len(trace)
        c = obs.registry.counters
        assert c["churn.fail"] == 2
        assert c["churn.recover"] == 2
        inst = collections.Counter(
            e["name"] for e in obs.tracer.to_json()["traceEvents"]
            if e["ph"] == "i")
        assert inst["churn.fail"] == 2
        assert inst["churn.recover"] == 2
        snap = sim.metrics_snapshot()
        assert snap["counters"]["sim.churn_events"] == \
            len(sim.churn_events) == 4
        assert snap["hists"]["churn.recovery_s"]["count"] == \
            len(sim.churn_recovery)


def test_disabled_controls_bit_identical_to_scalar_ref(spec):
    """``overload=None``, the all-off ``OverloadControl()`` and the
    reference's frozen scalar policy decide the same."""
    tt = ttraces.make_trace("chatbot", qps=12.0, duration=60.0, seed=4)
    rt = rtraces.make_trace("chatbot", qps=12.0, duration=60.0, seed=4)

    def key(done):
        return [(r.rid, r.sched_to, r.hit_tokens, r.t_finish)
                for r in sorted(done, key=lambda r: r.rid)]

    def port(overload):
        router = tcore.Router(tcore.make_policy("lmetric"), 8,
                              kv_capacity_tokens=150_000, device="cpu")
        sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec),
                              overload=overload)
        done = sim.run(copy.deepcopy(tt))
        assert not sim.dropped
        return key(done)

    ref_policy = make_scalar_policy("lmetric")
    ref_policy.on_finish = lambda iid, req: None
    ref_policy.batch_supported = lambda k: False
    ref = rsim.ClusterSim(rcore.Router(ref_policy, 8,
                                       kv_capacity_tokens=150_000),
                          rspec(), rcore.LatencyModel(rspec()))
    want = key(ref.run(copy.deepcopy(rt)))
    assert port(None) == want
    assert port(tcore.OverloadControl()) == want


def test_overload_controls_change_nothing_at_low_load(spec):
    trace = ttraces.make_trace("chatbot", qps=8.0, duration=60.0, seed=6)

    def run(overload):
        router = tcore.Router(tcore.make_policy("lmetric"), 8,
                              kv_capacity_tokens=150_000, device="cpu")
        sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec),
                              overload=overload)
        done = sim.run(copy.deepcopy(trace))
        stats = sim.overload_stats()
        return ([(r.rid, r.sched_to, r.hit_tokens) for r in done],
                stats["shed"], stats["retracted"])

    base, _, _ = run(None)
    ctl, shed, retracted = run(tcore.OverloadControl(admission=True,
                                                     retraction=True))
    assert shed == 0 and retracted == 0
    assert ctl == base


def _hetero_churn(pkg):
    """The fast class (instances 0-7) fails at 30 s and recovers at
    60 s; a third of the trace needs its model, a third the slow one's."""
    port = pkg is tcore
    traces = ttraces if port else rtraces
    trace = traces.make_trace("chatbot", qps=16.0, duration=90.0, seed=33)
    for i, r in enumerate(trace):
        if i % 3 == 0:
            r.model_requirement = "qwen3_30b_moe"
        elif i % 3 == 1:
            r.model_requirement = "qwen2_7b"
    if port:
        fleet = tsim.make_mixed_fleet(**REF_RATES)
        spec = tcore.spec_from_config(get_config("qwen3_30b_moe"),
                                      **REF_RATES)
        router = tcore.Router(tcore.make_policy("lmetric"), fleet.n,
                              kv_capacity_tokens=200_000, fleet=fleet,
                              device="cpu")
        sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec))
    else:
        fleet = rsim.make_mixed_fleet()
        spec = rcore.spec_from_config(ref_config("qwen3_30b_moe"))
        router = rcore.Router(rcore.make_policy("lmetric"), fleet.n,
                              kv_capacity_tokens=200_000, fleet=fleet)
        sim = rsim.ClusterSim(router, spec, rcore.LatencyModel(spec))
    for iid in range(8):
        sim.fail_at(30.0, iid)
        sim.recover_at(60.0, iid)
    done = sim.run(copy.deepcopy(trace))
    return trace, fleet, router, sim, done


def test_hetero_class_outage_semantics():
    """While the fast class is down nothing lands on it and requests
    that need its model are shed, not routed; it rejoins after; and the
    run is the reference's."""
    trace, fleet, router, sim, done = _hetero_churn(tcore)
    with router:
        fast = set(range(8))
        for r in done:
            if 30.0 <= r.t_sched < 60.0:
                assert r.sched_to not in fast
            if r.model_requirement:
                assert fleet.model_of(r.sched_to) == r.model_requirement
        shed = [r for r in sim.dropped if r.drop_reason == "shed"]
        assert shed
        assert all(r.model_requirement == "qwen3_30b_moe" for r in shed)
        assert sim._admission.capability_shed == len(shed)
        assert len(done) + len(shed) == len(trace)
        late = [r for r in done if r.t_sched >= 60.0]
        assert {r.sched_to for r in late} & fast
        assert router.policy.alive is None
        _assert_index_matches_rebuild(router.factory)
    _, _, _, rsim_, rdone = _hetero_churn(rcore)
    assert fates(done) == fates(rdone)
    assert drops(sim) == drops(rsim_)
    assert sim.churn_recovery == rsim_.churn_recovery


# ---------------------------------------------------------------------------
# parity: overload control and churn in one run
# ---------------------------------------------------------------------------
CONTROLS = {
    "admission+retraction": dict(admission=True, retraction=True),
    "retraction": dict(retraction=True),
}


def _schedule(sim):
    sim.fail_at(5.0, 1)
    sim.drain_at(8.0, 2)
    sim.recover_at(12.0, 1)
    sim.recover_at(14.0, 2)


def _overload_pair(spec, control, ref_sequential=True, monkeypatch=None):
    kw = dict(qps=80.0, duration=20.0, seed=21)
    tt = quantize(ttraces.make_trace("agent", **kw))
    rt = quantize(rtraces.make_trace("agent", **kw))
    router = tcore.Router(tcore.make_policy("lmetric"), 6,
                          kv_capacity_tokens=200_000, device="cpu")
    waves = Waves(router, monkeypatch)
    port = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec),
                           overload=tcore.OverloadControl(**control))
    rrouter = rcore.Router(rcore.make_policy("lmetric"), 6,
                           kv_capacity_tokens=200_000)
    if ref_sequential:
        sequential(rrouter)
    ref = rsim.ClusterSim(rrouter, rspec(), rcore.LatencyModel(rspec()),
                          overload=rcore.OverloadControl(**control))
    for sim in (port, ref):
        _schedule(sim)
    done, rdone = port.run(tt), ref.run(rt)
    return port, ref, done, rdone, waves, tt


@pytest.mark.parametrize("control", list(CONTROLS))
def test_overload_and_churn_equal_reference(spec, control, monkeypatch):
    port, ref, done, rdone, waves, tt = _overload_pair(
        spec, CONTROLS[control], monkeypatch=monkeypatch)
    assert fates(done) == fates(rdone)
    assert drops(port) == drops(ref)
    stats = port.overload_stats()
    assert stats == ref.overload_stats()
    assert port.churn_recovery == ref.churn_recovery
    assert port.churn_events == ref.churn_events
    assert stats["retracted"] > 0 and stats["reroutes"] > 0
    if control == "admission+retraction":
        assert stats["shed"] > 0
    assert len(done) + len(port.dropped) == len(tt)
    # the wave path ran while every instance was live, and only then
    assert waves.submits == waves.live_waves() \
        == port.router.pipeline.waves > 20
    assert any(k > 1 and not live for k, live in waves.calls)
    assert port.router.policy.alive is None
    assert tmetrics.overload_summary(done, port.dropped,
                                     port.churn_recovery) == \
        rmetrics.overload_summary(rdone, ref.dropped, ref.churn_recovery)
    _assert_index_matches_rebuild(port.router.factory)


def test_overload_and_churn_equal_reference_wave_path(spec, x64,
                                                      monkeypatch):
    """The reference's own wave path (``route_batch`` → its JAX
    ``route_score``, host path while an instance is down) gives the
    same run."""
    port, ref, done, rdone, waves, _ = _overload_pair(
        spec, CONTROLS["admission+retraction"], ref_sequential=False,
        monkeypatch=monkeypatch)
    assert fates(done) == fates(rdone)
    assert drops(port) == drops(ref)
    assert port.overload_stats() == ref.overload_stats()
    assert ref.router.pipeline.waves == port.router.pipeline.waves \
        == waves.submits


def test_failed_instance_mirror_and_index():
    """``mark_failed``: zeroed columns dirty their mirror range and
    reach the next ``device_view``; the index drops the column; the
    device plan is off until ``mark_recovered`` makes the fleet whole,
    then plans again over the zeroed state as sequential routing does."""
    reqs = quantize(ttraces.make_trace("coder", qps=20.0, duration=30.0,
                                       seed=2))[:64]
    assert len(reqs) == 64
    router = tcore.Router(tcore.make_policy("lmetric"), 8,
                          kv_capacity_tokens=1 << 30, n_shards=4,
                          device="cpu")
    twin = tcore.Router(tcore.make_policy("lmetric"), 8,
                        kv_capacity_tokens=1 << 30, n_shards=4,
                        device="cpu")
    with router, twin:
        a = router.route_batch(copy.deepcopy(reqs[:32]), 0.0)
        b = [twin.route(r, 0.0) for r in copy.deepcopy(reqs[:32])]
        assert a == b
        f = router.factory
        f.device_view()
        iid = a[0]
        assert f.total_tokens[iid] > 0
        for r in (router, twin):
            r.mark_failed(iid)
        assert f._dirty.tolist() == [s == f._mirror_owner[iid]
                                     for s in range(4)]
        view = f.device_view()
        assert int(view[3][iid]) == 0 and int(view[1][iid]) == 0
        assert not list(f[iid].kv.chains())
        assert f.hits_for(reqs[0])[iid] == 0
        assert not router.policy.batch_supported(f)
        for r in (router, twin):
            r.mark_recovered(iid)
        assert router.policy.alive is None
        assert router.policy.batch_supported(f)
        waves = router.pipeline.waves
        a = router.route_batch(copy.deepcopy(reqs[32:]), 1.0)
        b = [twin.route(r, 1.0) for r in copy.deepcopy(reqs[32:])]
        assert a == b and router.pipeline.waves == waves + 1


def test_router_from_numpy_state_carries_alive():
    """A reference router's state exported mid-churn (instance 3 failed,
    5 drained) routes on in the port as it does in the reference."""
    trace = rtraces.make_trace("chatbot", qps=20.0, duration=30.0, seed=8)
    ptrace = ttraces.make_trace("chatbot", qps=20.0, duration=30.0, seed=8)
    ref = rcore.Router(rcore.make_policy("lmetric"), 8,
                       kv_capacity_tokens=1 << 30)
    for r in trace[:200]:
        ref.route(r, r.arrival)
    ref.mark_failed(3)
    ref.mark_drained(5)
    f = ref.factory
    port = tcore.router_from_numpy_state(
        tcore.make_policy("lmetric"), 8,
        {c: getattr(f, c) for c in ("r_bs", "q_bs",
                                    "queued_prefill_tokens",
                                    "total_tokens")},
        [list(inst.kv.chains()) for inst in f.instances],
        ref.policy._tie_n, alive=ref.policy.alive,
        kv_capacity_tokens=1 << 30, device="cpu")
    assert port.policy.alive.tolist() == ref.policy.alive.tolist()
    assert port.policy.alive is not ref.policy.alive
    got = [port.route(r, r.arrival) for r in copy.deepcopy(ptrace[200:])]
    want = [ref.route(r, r.arrival) for r in trace[200:]]
    assert got == want and not {3, 5} & set(got)
    whole = tcore.router_from_numpy_state(
        tcore.make_policy("lmetric"), 2,
        {c: np.zeros(2, np.int64) for c in ("r_bs", "q_bs",
                                            "queued_prefill_tokens",
                                            "total_tokens")},
        [[], []], 0, alive=[True, True], device="cpu")
    assert whole.policy.alive is None
    with pytest.raises(ValueError, match="alive"):
        tcore.router_from_numpy_state(
            tcore.make_policy("lmetric"), 2,
            {c: np.zeros(2, np.int64) for c in ("r_bs", "q_bs",
                                                "queued_prefill_tokens",
                                                "total_tokens")},
            [[], []], 0, alive=[True], device="cpu")
