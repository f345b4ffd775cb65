"""The port's cluster simulator (``repro_torch.cluster.simulator``) against
the JAX package's, on the CPU.

* Ports of ``tests/test_simulator.py`` (conservation, ordering and the
  paper's directional claims at small scale), run on the port with the
  router's mirror on the CPU (the plain version of ``route_score``).
* Parity: the same seeded trace, its arrivals rounded to a scheduling
  tick so that same-timestamp waves form, goes through the port's
  ``ClusterSim`` (its own wave path: ``route_batch`` → ``route_score``'s
  plain version) and through a reference ``ClusterSim`` that routes
  request by request (which never reaches JAX).  The finished tuples
  ``(rid, sched_to, hit_tokens, t_first_token, t_finish)``, the
  imbalance profile and the batch timeline must be identical (exact:
  the times are sums of ``step_time`` floats taken in event order).
  One smaller case holds the port against the reference's real
  ``route_batch`` wave path, under the jax 0.9 ``enable_x64`` shim.
* The trace statistics and metric helpers the simulation reports with.
* The paths an earlier slice left raising (fleet, overload control,
  churn, observability) run, each as the reference's does.
"""
import collections
import copy
import functools
import heapq

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

import repro.cluster.metrics as rmetrics  # noqa: E402
import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
import repro_torch.cluster.metrics as tmetrics  # noqa: E402
import repro_torch.cluster.simulator as tsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import route_score  # noqa: E402
from repro_torch.obs import validate_events  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
N = 8
TICK = 0.1


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


class RefSequential(rsim.ClusterSim):
    """The reference simulator routing each wave request by request."""

    def _on_arrivals(self, reqs):
        for r in reqs:
            self._on_arrival(r)


def quantize(trace, tick=TICK):
    """Round arrivals to a scheduling tick, then re-sort (stable, so
    equal arrivals keep their rid order)."""
    for r in trace:
        r.arrival = round(r.arrival / tick) * tick
    trace.sort(key=lambda r: r.arrival)
    return trace


def finished(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
            for r in done]


def multi_waves(trace):
    """Timestamps that carry two requests or more: the waves a
    simulator routes through ``route_score``."""
    return sum(1 for c in collections.Counter(
        r.arrival for r in trace).values() if c > 1)


@pytest.fixture(scope="module")
def spec():
    return tcore.spec_from_config(get_config("qwen2_7b"), chips=1)


@pytest.fixture(scope="module")
def trace():
    return ttraces.make_trace("chatbot", qps=20.0, duration=120.0, seed=3)


def run_policy(policy, trace, spec, n=N, kv=300_000):
    router = tcore.Router(policy, n, kv_capacity_tokens=kv, device="cpu")
    sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec))
    done = sim.run(copy.deepcopy(trace))
    return done, router, sim


@pytest.fixture(scope="module")
def runs(trace, spec):
    """Memoised port runs of the unquantized trace, by (policy, KV$
    capacity)."""
    @functools.lru_cache(maxsize=None)
    def get(policy, kv=300_000):
        return run_policy(tcore.make_policy(policy), trace, spec, kv=kv)
    return get


# ---- ports of tests/test_simulator.py ------------------------------------
def test_all_requests_finish_with_sane_timestamps(trace, runs):
    done, _, _ = runs("vllm")
    assert len(done) == len(trace)
    for r in done:
        assert r.t_first_token >= r.arrival
        assert r.t_finish >= r.t_first_token
        assert r.ttft >= 0 and (r.output_len <= 1 or r.tpot > 0)


def test_kv_aware_beats_jsq_on_hits_and_ttft(runs):
    """Fig. 7 direction: KV$-awareness cuts TTFT and raises hit rate."""
    s1 = tmetrics.summarize(runs("vllm")[0])
    s2 = tmetrics.summarize(runs("lmetric")[0])
    assert s2["kv_hit_ratio"] > s1["kv_hit_ratio"] + 0.1
    assert s2["ttft_mean"] < s1["ttft_mean"]


def test_router_indicators_return_to_zero(runs):
    _, router, _ = runs("lmetric")
    for inst in router.factory:
        assert inst.r_bs == 0
        assert inst.q_bs == 0


def test_finite_kv_capacity_reduces_hits(runs):
    hits_small = tmetrics.summarize(runs("lmetric", 10_000)[0])
    hits_big = tmetrics.summarize(runs("lmetric")[0])
    assert hits_small["kv_hit_ratio"] < hits_big["kv_hit_ratio"]


def test_deterministic_given_seed(spec):
    t1 = ttraces.make_trace("agent", qps=10, duration=60, seed=9)
    t2 = ttraces.make_trace("agent", qps=10, duration=60, seed=9)
    assert [r.blocks for r in t1] == [r.blocks for r in t2]
    d1, _, _ = run_policy(tcore.LMetricPolicy(), t1, spec, n=4)
    d2, _, _ = run_policy(tcore.LMetricPolicy(), t2, spec, n=4)
    s1, s2 = tmetrics.summarize(d1), tmetrics.summarize(d2)
    assert s1["ttft_mean"] == pytest.approx(s2["ttft_mean"])


# ---- parity with the reference -------------------------------------------
def _both(policy, n_req=None, ref_sim=RefSequential, kv=300_000, n=N):
    """(port sim, reference sim, port trace) on the quantized chatbot
    trace, both at the reference's peak rates."""
    tspec = tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES)
    rspec = rcore.spec_from_config(ref_config("qwen2_7b"))
    tt = quantize(ttraces.make_trace("chatbot", qps=20.0, duration=120.0,
                                     seed=3))[:n_req]
    rt = quantize(rtraces.make_trace("chatbot", qps=20.0, duration=120.0,
                                     seed=3))[:n_req]
    port = tsim.ClusterSim(
        tcore.Router(tcore.make_policy(policy), n, kv_capacity_tokens=kv,
                     device="cpu"), tspec, tcore.LatencyModel(tspec))
    ref = ref_sim(rcore.Router(rcore.make_policy(policy), n,
                               kv_capacity_tokens=kv),
                  rspec, rcore.LatencyModel(rspec))
    assert finished(port.run(copy.deepcopy(tt))) == \
        finished(ref.run(copy.deepcopy(rt)))
    return port, ref, tt


@pytest.mark.parametrize("policy", ["lmetric", "vllm", "linear", "filter"])
def test_cluster_sim_equals_reference(policy):
    port, ref, tt = _both(policy)
    assert len(port.finished) == len(tt)
    assert port.router.pipeline.waves == multi_waves(tt) > 100
    assert port.imbalance_profile() == ref.imbalance_profile()
    assert port.batch_timeline() == ref.batch_timeline()
    for name in ("r_bs", "q_bs", "queued_prefill_tokens", "total_tokens"):
        assert np.array_equal(getattr(port.router.factory, name),
                              getattr(ref.router.factory, name)), name


def test_cluster_sim_equals_reference_with_evictions():
    """A KV$ small enough to evict mid-wave: the port's eviction guard
    hands the rest of such a wave to sequential routing."""
    port, _, _ = _both("lmetric", n_req=500, kv=6_000)
    assert port.router.factory.evictions > 0


def test_cluster_sim_equals_reference_wave_path(x64):
    """The reference's own wave path (``route_batch`` → its JAX
    ``route_score``) gives the same run as the port's."""
    port, ref, tt = _both("lmetric", n_req=300, ref_sim=rsim.ClusterSim)
    assert ref.router.pipeline.waves == port.router.pipeline.waves \
        == multi_waves(tt) > 30


def test_quantized_trace_forms_waves_and_they_take_the_wave_path(
        trace, spec, monkeypatch):
    """Unrounded arrivals almost never coincide; rounded to a tick they
    form waves, and each wave of two or more is one ``route_score`` call
    (here its plain version: the mirror is on the CPU, so no kernel is
    launched and ``LAUNCHES`` stays put)."""
    assert multi_waves(trace) == 0
    tq = quantize(copy.deepcopy(trace))
    sizes = collections.Counter(collections.Counter(
        r.arrival for r in tq).values())
    assert sum(c for k, c in sizes.items() if k > 1) > 100
    calls = []
    submit = route_score.route_wave_submit

    def counted(kind, *a):
        calls.append(kind)
        return submit(kind, *a)

    monkeypatch.setattr(route_score, "route_wave_submit", counted)
    launches = route_score.LAUNCHES
    _, router, sim = run_policy(tcore.make_policy("lmetric"), tq, spec)
    assert len(sim.finished) == len(tq)
    assert calls == ["lmetric"] * multi_waves(tq) == \
        ["lmetric"] * router.pipeline.waves
    assert route_score.LAUNCHES == launches


def test_peek_next_wave_equals_reference():
    tt = quantize(ttraces.make_trace("agent", qps=30.0, duration=20.0,
                                     seed=4))
    rt = quantize(rtraces.make_trace("agent", qps=30.0, duration=20.0,
                                     seed=4))
    spec = tcore.spec_from_config(get_config("qwen2_7b"))
    port = tsim.ClusterSim(tcore.Router(tcore.JSQPolicy(), 4, device="cpu"),
                           spec)
    ref = rsim.ClusterSim(rcore.Router(rcore.JSQPolicy(), 4),
                          rcore.spec_from_config(ref_config("qwen2_7b")))
    for sim, tr in ((port, tt), (ref, rt)):
        sim._push(-1.0, "step_end", None)    # not an arrival: no wave
        for r in tr:
            sim._push(r.arrival, "arrival", r)
    assert port._peek_next_wave() is None is ref._peek_next_wave()
    for sim in (port, ref):
        heapq.heappop(sim._events)
    sizes = []
    while port._events:
        pw, rw = port._peek_next_wave(), ref._peek_next_wave()
        assert [r.rid for r in pw] == [r.rid for r in rw]
        for sim, w in ((port, pw), (ref, rw)):
            # the peek left the pop order as it was
            assert [heapq.heappop(sim._events)[3].rid for _ in w] == \
                [r.rid for r in w]
        sizes.append(len(pw))
    assert max(sizes) > 1 and not ref._events


# ---- trace statistics and metric helpers ---------------------------------
@pytest.mark.parametrize("family", ["chatbot", "agent", "coder",
                                    "toolagent", "hotspot"])
def test_trace_stats_and_capacity_equal_reference(family):
    kw = dict(qps=8.0, duration=60.0, seed=1)
    if family == "hotspot":
        kw.update(duration=120.0)
    tt = ttraces.make_trace(family, **kw)
    rt = rtraces.make_trace(family, **kw)
    assert ttraces.trace_stats(tt) == rtraces.trace_stats(rt)
    for arch in ("qwen2_7b", "recurrentgemma_9b"):
        ts = tcore.spec_from_config(get_config(arch), **REF_RATES)
        rs = rcore.spec_from_config(ref_config(arch))
        assert ttraces.estimate_capacity_qps(ts, tt, 16) == \
            rtraces.estimate_capacity_qps(rs, rt, 16)


def test_metric_helpers_equal_reference(runs):
    done, _, sim = runs("lmetric")
    prof = sim.imbalance_profile()
    assert tmetrics.imbalance_stats(prof) == rmetrics.imbalance_stats(prof)
    assert tmetrics.imbalance_stats({}) == rmetrics.imbalance_stats({})
    ttft = [r.ttft for r in done]
    assert tmetrics.cdf(ttft) == rmetrics.cdf(ttft)
    assert tmetrics.cdf([], 7) == rmetrics.cdf([], 7)
    s = tmetrics.summarize(done)
    assert tmetrics.fmt_row("lmetric", s) == rmetrics.fmt_row("lmetric", s)
    s.pop("slo_attainment")
    assert tmetrics.fmt_row("x", s) == rmetrics.fmt_row("x", s)


# ---- paths once left to later slices -----------------------------------
def _tiny(pkg):
    return quantize(pkg.make_trace("chatbot", qps=6.0, duration=30.0,
                                   seed=2))


def _paths_pair(what):
    """The port's and the reference's (request-by-request) simulators
    over 4 instances, set up for path ``what`` the same way, run on the
    same small trace; returns (port sim, reference sim)."""
    tspec = tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES)
    rspec = rcore.spec_from_config(ref_config("qwen2_7b"))
    sims = []
    for pkg, sim_mod, spec, traces, extra in (
            (tcore, tsim, tspec, ttraces, {"device": "cpu"}),
            (rcore, rsim, rspec, rtraces, {})):
        kw = {}
        if what == "obs":
            obs_mod = (__import__("repro_torch.obs", fromlist=["make_obs"])
                       if pkg is tcore else
                       __import__("repro.obs", fromlist=["make_obs"]))
            kw["obs"] = obs_mod.make_obs(metrics=True, trace=True,
                                         provenance=True)
        n = 4
        if what == "fleet":
            fleet = (sim_mod.make_mixed_fleet(mix=(
                ("qwen3_30b_moe", "fast", 2), ("qwen2_7b", "slow", 2)),
                **(REF_RATES if pkg is tcore else {})))
            kw["fleet"] = fleet
        router = pkg.Router(pkg.make_policy("lmetric"), n,
                            kv_capacity_tokens=200_000, **kw, **extra)
        if pkg is rcore:
            router.route_batch = lambda reqs, now, _r=router: [
                _r.route(q, now) for q in reqs]
        overload = (pkg.OverloadControl(admission=True, retraction=True)
                    if what in ("overload", "overload_stats") else None)
        sim = sim_mod.ClusterSim(router, spec, pkg.LatencyModel(spec),
                                 overload=overload)
        if what in ("fail_at", "recover_at"):
            sim.fail_at(8.0, 1)
        if what in ("drain_at", "recover_at"):
            sim.drain_at(10.0, 2)
        if what == "recover_at":
            sim.recover_at(15.0, 1)
            sim.recover_at(18.0, 2)
        sim.run(_tiny(traces))
        sims.append(sim)
    return sims


def _same_run(port, ref):
    assert finished(port.finished) == finished(ref.finished)
    assert [(r.rid, r.drop_reason) for r in port.dropped] == \
        [(r.rid, r.drop_reason) for r in ref.dropped]
    assert port.churn_events == ref.churn_events
    assert port.overload_stats() == ref.overload_stats()
    return port


def _check_snapshot(port, ref):
    """The snapshots' counters agree but for wall-clock nanoseconds and
    the pipeline's (the reference here routes request by request)."""
    snap, rsnap = port.metrics_snapshot(), ref.metrics_snapshot()

    def same(c):
        return {k: v for k, v in c.items()
                if not k.endswith("_ns") and not k.startswith("pipeline.")}
    assert same(snap["counters"]) == same(rsnap["counters"])
    assert port.router.pipeline.waves == multi_waves(_tiny(ttraces)) > 0
    assert snap["counters"]["sim.finished"] == len(port.finished)


def _check_obs(port, ref):
    _same_run(port, ref)
    _check_snapshot(port, ref)
    assert port.router.obs.provenance.records == \
        ref.router.obs.provenance.records
    # the reference routes request by request here, so its trace holds
    # no wave spans; the port's holds one tree for every 8th wave
    events = port.router.obs.tracer.to_json()["traceEvents"]
    validate_events(events)
    waves = port.router.pipeline.waves
    assert sum(1 for e in events if e["name"] == "wave") == \
        2 * ((waves + 7) // 8) > 0


def _check_fleet(port, ref):
    _same_run(port, ref)
    assert port.instances[0].model is not port.instances[3].model
    assert port._admission is not None


#: each path a former slice left raising ``NotImplementedError`` (with
#: its ROADMAP Queue A item), and the check its run now passes
NOT_PORTED = {
    "fail_at": (7, lambda p, r: _same_run(p, r).churn_recovery
                == r.churn_recovery),
    "drain_at": (7, lambda p, r: _same_run(p, r).churn_events[0]["kind"]
                 == "drain"),
    "recover_at": (7, lambda p, r: _same_run(p, r).router.policy.alive
                   is None),
    "overload_stats": (7, lambda p, r: set(_same_run(p, r)
                                           .overload_stats())
                       == set(r.overload_stats())),
    "overload": (7, lambda p, r: _same_run(p, r).overload.admission),
    "metrics_snapshot": (5, lambda p, r: _check_snapshot(p, r) is None),
    "obs": (5, lambda p, r: _check_obs(p, r) is None),
    "fleet": (6, lambda p, r: _check_fleet(p, r) is None),
    "make_mixed_fleet": (6, lambda p, r: tsim.make_mixed_fleet(
        **REF_RATES).prefill_norm.tolist()
        == rsim.make_mixed_fleet().prefill_norm.tolist()),
}


@pytest.mark.parametrize("what", list(NOT_PORTED))
def test_not_ported_paths_raise(what, spec):
    """Formerly: each path raised ``NotImplementedError`` naming its
    ROADMAP Queue A item (5 observability, 6 fleets, 7 overload control
    and churn).  Now each runs, and its run equals the reference's."""
    item, check = NOT_PORTED[what]
    assert item in (5, 6, 7)
    port, ref = _paths_pair(what)
    assert check(port, ref)
