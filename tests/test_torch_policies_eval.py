"""The paper's comparison policies in the port (``repro_torch.core
.policies``: Dynamo, llm-d, PolyServe, Preble, session affinity and
LMetric's "cost" load indicator and hotspot detector) against the JAX
package, on the CPU.

* Simulator runs: the same tick-quantized trace through the port's
  ``ClusterSim`` (mirror on the CPU) and the reference's, 8 instances, a
  few hundred requests.  Every one of these policies is host-only in
  both, so the reference routes its waves request by request and never
  reaches JAX.  Finished tuples, the detector's ``history``/``events``,
  Preble's ``branch_counts``, the session pins, the routed-window rings
  and the final state of each ``LatencyModel``'s noise stream must be
  identical.
* ``scores_batch`` of each policy against the reference's on the same
  state, and the side effects it must not have.
* ``make_policy``'s names, ``Router.session_pin`` and the carry-across
  of the routed-window rings through ``router_from_numpy_state``.

Exact equality throughout: the same float64 arithmetic in the same order.
"""
import collections
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
import repro_torch.cluster.simulator as tsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.state import COLUMNS  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
N = 8
TICK = 0.1


def quantize(trace, tick=TICK):
    for r in trace:
        r.arrival = round(r.arrival / tick) * tick
    trace.sort(key=lambda r: r.arrival)
    return trace


def finished(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
            for r in done]


def rings(factory):
    return [factory.routed_window(i) for i in range(len(factory))]


#: name -> maker(core module, spec): one policy, built the same way from
#: either package (llm-d and PolyServe with the figures' 15% predictor
#: error, as ``benchmarks/common.py`` builds them)
MAKERS = {
    "dynamo": lambda m, s: m.make_policy("dynamo"),
    "llm-d": lambda m, s: m.make_policy(
        "llm-d", latency_model=m.LatencyModel(s, error_std=0.15)),
    "polyserve": lambda m, s: m.make_policy(
        "polyserve", latency_model=m.LatencyModel(s, error_std=0.15)),
    "preble": lambda m, s: m.make_policy("preble"),
    "preble-5s": lambda m, s: m.make_policy("preble", window=5.0),
    "session-affinity": lambda m, s: m.make_policy("session-affinity"),
    "cost": lambda m, s: m.make_policy(
        "lmetric", load_indicator="cost", latency_model=m.LatencyModel(s)),
    "detector": lambda m, s: m.LMetricPolicy(
        detector=m.HotspotDetector()),
}

CASES = [("dynamo", "chatbot"), ("dynamo", "agent"),
         ("llm-d", "chatbot"), ("llm-d", "coder"),
         ("polyserve", "chatbot"), ("polyserve", "toolagent"),
         ("preble", "chatbot"), ("preble", "coder"),
         ("preble-5s", "agent"),
         ("session-affinity", "agent"), ("session-affinity", "toolagent"),
         ("cost", "chatbot"), ("cost", "coder"),
         ("detector", "chatbot"), ("detector", "agent")]


def _specs():
    return (tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES),
            rcore.spec_from_config(ref_config("qwen2_7b")))


def _sims(name, tt, rt, tspec, rspec, kv=300_000):
    """Run ``name`` on the port's and the reference's ClusterSim; returns
    (port sim, reference sim) after asserting equal finished tuples."""
    port = tsim.ClusterSim(
        tcore.Router(MAKERS[name](tcore, tspec), N, kv_capacity_tokens=kv,
                     device="cpu"), tspec, tcore.LatencyModel(tspec))
    ref = rsim.ClusterSim(
        rcore.Router(MAKERS[name](rcore, rspec), N, kv_capacity_tokens=kv),
        rspec, rcore.LatencyModel(rspec))
    got = finished(port.run(copy.deepcopy(tt)))
    assert got == finished(ref.run(copy.deepcopy(rt)))
    assert len(got) == len(tt)
    return port, ref


def _same_policy_state(tp, rp):
    """Every piece of policy state the reference keeps, equal."""
    for attr in ("_tie_n", "branch_counts", "pins"):
        assert getattr(tp, attr, None) == getattr(rp, attr, None), attr
    for attr in ("model", "latency_model"):
        a, b = getattr(tp, attr, None), getattr(rp, attr, None)
        assert (a is None) == (b is None)
        if a is not None:
            assert a._rng_state == b._rng_state, attr
    a, b = getattr(tp, "detector", None), getattr(rp, "detector", None)
    if a is not None:
        assert a.history == b.history and a.events == b.events


@pytest.mark.parametrize("name,family", CASES,
                         ids=[f"{p}-{f}" for p, f in CASES])
def test_cluster_sim_equals_reference(name, family):
    tspec, rspec = _specs()
    kw = dict(qps=20.0, duration=120.0, seed=3)
    tt = quantize(ttraces.make_trace(family, **kw))[:300]
    rt = quantize(rtraces.make_trace(family, **kw))[:300]
    port, ref = _sims(name, tt, rt, tspec, rspec)
    tp, rp = port.router.policy, ref.router.policy
    assert not tp.batch_supported(port.router.factory)
    assert port.router.pipeline.waves == 0 == ref.router.pipeline.waves
    _same_policy_state(tp, rp)
    assert rings(port.router.factory) == rings(ref.router.factory)
    for c in COLUMNS:
        assert np.array_equal(getattr(port.router.factory, c),
                              getattr(ref.router.factory, c)), c
    if name.startswith("preble"):
        assert min(tp.branch_counts.values()) > 10
    if name in ("llm-d", "polyserve"):
        assert tp.model._rng_state != 1          # the stream was drawn
    if name == "session-affinity":
        assert tp.pins and all(k[0] == "c" for k in tp.pins)


def test_hotspot_trace_with_detector_equals_reference(monkeypatch):
    """The §5.2 hotspot burst on 8 instances, at the port's H100 rates on
    both sides (at the reference's own rates this burst raises alarms but
    never activates mitigation): two activations, and the same run."""
    tspec = tcore.spec_from_config(get_config("qwen2_7b"))
    monkeypatch.setattr(rlm, "PEAK_FLOPS", tspec.peak_flops)
    monkeypatch.setattr(rlm, "HBM_BW", tspec.hbm_bw)
    rspec = rcore.spec_from_config(ref_config("qwen2_7b"))
    kw = dict(qps=188.0, duration=10.0, seed=7, burst_start=1.0,
              burst_len=4.0)
    tt = quantize(ttraces.make_hotspot_trace(**kw))[:800]
    rt = quantize(rtraces.make_hotspot_trace(**kw))[:800]
    port, ref = _sims("detector", tt, rt, tspec, rspec)
    _same_policy_state(port.router.policy, ref.router.policy)
    det = port.router.policy.detector
    events = [e["event"] for e in det.events]
    assert events.count("activate") == 2 and "clear" in events
    assert sum(not h["eq2"] for h in det.history) > 0


# ---- scores_batch ---------------------------------------------------------
def _drive(router, reqs, outstanding):
    """Sequential ``route`` at each request's arrival, then the partial
    drain schedule of ``tests/test_torch_router.py``."""
    out = []
    for r in [copy.copy(r) for r in reqs]:
        iid = router.route(r, r.arrival)
        out.append((iid, r.hit_tokens))
        outstanding.append((iid, r, r.new_tokens))
        router.factory[iid].on_prefill_progress(256)
        if len(outstanding) > 12:
            did, dreq, dnew = outstanding.popleft()
            di = router.factory[did]
            di.on_prefill_progress(dnew)
            di.on_start_running(dreq)
            for _ in range(dreq.output_len % 7):
                di.on_decode_token()
            router.on_finish(did, dreq)
    return out


def _routers(name, n_req=200, family="agent"):
    """(port router, reference router, port trace, reference trace)
    after both routed the first ``n_req`` requests of one trace."""
    tspec, rspec = _specs()
    kw = dict(qps=6.0, duration=120.0, seed=8)
    tt = ttraces.make_trace(family, **kw)
    rt = rtraces.make_trace(family, **kw)
    port = tcore.Router(MAKERS[name](tcore, tspec), N,
                        kv_capacity_tokens=300_000, device="cpu")
    ref = rcore.Router(MAKERS[name](rcore, rspec), N,
                       kv_capacity_tokens=300_000)
    assert _drive(port, tt[:n_req], collections.deque()) == \
        _drive(ref, rt[:n_req], collections.deque())
    return port, ref, tt, rt


@pytest.mark.parametrize("name", list(MAKERS))
def test_scores_batch_equals_reference(name):
    """The (k, n) inspection matrix of a wave of 24 equals the
    reference's, and leaves the noise stream, the rings, the pins and the
    tie counter as they were."""
    port, ref, tt, rt = _routers(name)
    tp = port.policy
    now = tt[223].arrival
    before = (copy.deepcopy(getattr(tp, "pins", None)),
              getattr(getattr(tp, "model", None), "_rng_state", None),
              rings(port.factory), tp._tie_n)
    got = tp.scores_batch(tt[200:224], port.factory, now)
    want = ref.policy.scores_batch(rt[200:224], ref.factory, now)
    assert got.shape == (24, N) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert before == (copy.deepcopy(getattr(tp, "pins", None)),
                      getattr(getattr(tp, "model", None), "_rng_state",
                              None),
                      rings(port.factory), tp._tie_n)
    if name == "preble-5s":
        # the window is shorter than the trace: the untrimmed fallback
        # row counts less than the whole ring
        assert sum(map(len, rings(port.factory))) > 24
    _same_policy_state(tp, ref.policy)


# ---- make_policy, session pins and the carry-across ------------------------
REF_NAMES = ["vllm", "jsq", "linear", "bailian", "dynamo", "filter",
             "aibrix", "llm-d", "simulation", "preble", "polyserve",
             "lmetric", "session-affinity", "smetric", "affinity"]


@pytest.mark.parametrize("name", REF_NAMES)
def test_make_policy_builds_every_reference_name(name):
    tspec, rspec = _specs()
    got = tcore.make_policy(name, latency_model=tcore.LatencyModel(tspec))
    want = rcore.make_policy(name, latency_model=rcore.LatencyModel(rspec))
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name and got.batch_kind == want.batch_kind


def test_make_policy_needs_and_refusals():
    for name in ("route-then-balance", "rtb"):
        # built since the fleet is ported; it needs no latency model
        pol = tcore.make_policy(name)
        assert isinstance(pol, tcore.RouteThenBalancePolicy)
        assert pol.name == rcore.make_policy(name).name
    for name in ("llm-d", "polyserve"):
        with pytest.raises(ValueError):
            tcore.make_policy(name)
    with pytest.raises(ValueError):
        tcore.LMetricPolicy(load_indicator="cost")
    with pytest.raises(KeyError):
        tcore.make_policy("nope")


def test_session_pins_and_instance_failure():
    """Session requests pin by ``session_id``, open-loop ones by
    ``class_id``; ``Router.session_pin`` reads the pin (None under a
    policy without pins), and a failed instance loses its pins."""
    router = tcore.Router(tcore.make_policy("session-affinity"), 4,
                          device="cpu")
    reqs = [tcore.Request(rid=i, arrival=0.0, blocks=(i,), prompt_len=64,
                          output_len=4, class_id=i % 3,
                          session_id=(7 if i % 2 else -1))
            for i in range(6)]
    iids = [router.route(r, 0.0) for r in reqs]
    pol = router.policy
    assert router.session_pin(7) == iids[5] == pol.pins[("s", 7)]
    assert router.session_pin(8) is None
    assert ("c", 0) in pol.pins and ("c", 2) in pol.pins
    victim = router.session_pin(7)
    pol.on_instance_failed(victim, 4)
    assert victim not in pol.pins.values()
    assert router.session_pin(7) is None
    assert tcore.Router(tcore.JSQPolicy(), 2,
                        device="cpu").session_pin(7) is None


def test_carry_across_routed_window_rings():
    """Preble on the reference for 200 requests, its state carried over
    with each instance's ring, then 100 more on both: the same
    decisions and branch counts.  Without the rings the port decides
    differently, so the rings are what carries."""
    port0, ref, tt, rt = _routers("preble-5s")
    f = ref.factory

    def carried(with_rings):
        return tcore.router_from_numpy_state(
            tcore.make_policy("preble", window=5.0), N,
            {c: getattr(f, c).copy() for c in COLUMNS},
            [list(inst.kv.chains()) for inst in f], ref.policy._tie_n,
            routed=rings(f) if with_rings else None,
            kv_capacity_tokens=300_000, device="cpu")

    port, bare = carried(True), carried(False)
    assert rings(port.factory) == rings(f)
    counts0 = dict(ref.policy.branch_counts)
    want = _drive(ref, rt[200:300], collections.deque())
    assert _drive(port, tt[200:300], collections.deque()) == want
    assert _drive(bare, tt[200:300], collections.deque()) != want
    assert {k: v - counts0[k] for k, v in ref.policy.branch_counts.items()} \
        == port.policy.branch_counts
    with pytest.raises(ValueError):
        tcore.router_from_numpy_state(
            tcore.make_policy("preble"), N,
            {c: getattr(f, c).copy() for c in COLUMNS},
            [[]] * N, 0, routed=[[]] * (N - 1), device="cpu")
