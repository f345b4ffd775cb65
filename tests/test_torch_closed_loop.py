"""The port's closed loop (``repro_torch.workloads.sessions``,
``repro_torch.cluster.closed_loop``, ``make_trace(closed_loop=True)``)
against the JAX package's, on the CPU.

Ports of ``tests/test_sessions.py`` (determinism, the growing shared
prefix, fan-out barriers, SLO abandonment, disjoint block ranges, the
``make_trace`` escape hatch, mixed families) and
``tests/test_closed_loop.py`` (bit-identical runs, feedback waves routed
in batch equal to sequential routing, completion order, termination,
the SLO/goodput summary, session affinity, every policy completing, the
PD backend), each also held to the reference:

* ``make_sessions``, ``make_mixed_sessions`` and
  ``make_mixed_fleet_sessions`` issue the reference's requests (arrival,
  blocks, lengths, family, requirement) when driven the same way, and
  ``abandon_hazard`` is the reference's;
* ``ClosedLoopSim`` (with patience-driven retraction, and with
  admission and retraction) and ``ClosedLoopPDSim`` give the
  reference's finished logs and drops.  The reference routes its
  fan-out waves through its own wave path under the jax 0.9
  ``enable_x64`` shim, or request by request (its router's
  ``route_batch`` replaced).

Specs are built at the reference's peak rates, so that the floats are
the reference's.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

import repro.cluster.closed_loop as rloop  # noqa: E402
import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.sessions as rsess  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
import repro_torch.cluster.closed_loop as tloop  # noqa: E402
import repro_torch.cluster.metrics as tmetrics  # noqa: E402
import repro_torch.cluster.simulator as tsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.sessions as tsess  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import route_score  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
SPEC = tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES)
RSPEC = rcore.spec_from_config(ref_config("qwen2_7b"))
KV = 250_000


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def drive(session, ttft=0.05, tpot=0.005, max_steps=200):
    """Advance a session with a fixed-latency fake cluster; returns every
    request it issued."""
    log = []
    pending = list(session.start())
    steps = 0
    while pending and steps < max_steps:
        steps += 1
        pending.sort(key=lambda r: r.arrival)
        req = pending.pop(0)
        req.t_first_token = req.arrival + ttft
        req.t_finish = req.t_first_token + tpot * max(req.output_len - 1, 0)
        log.append(req)
        pending.extend(session.on_complete(req, req.t_finish))
    return log


def content(log):
    return [(r.arrival, r.blocks, r.prompt_len, r.output_len, r.class_id,
             r.session_id, r.family, r.model_requirement) for r in log]


def _log(done):
    return [(r.rid, r.session_id, r.sched_to, r.hit_tokens,
             r.t_first_token, r.t_finish) for r in done]


def _policy(name, pkg):
    if name in ("llm-d", "polyserve"):
        spec = SPEC if pkg is tcore else RSPEC
        return pkg.make_policy(name, latency_model=pkg.LatencyModel(
            spec, error_std=0.15, seed=7))
    return pkg.make_policy(name)


def _run(policy_name, sessions, n_inst=8, sim_cls=tloop.ClosedLoopSim,
         **kw):
    router = tcore.Router(_policy(policy_name, tcore), n_inst,
                          kv_capacity_tokens=KV, device="cpu")
    sim = sim_cls(router, SPEC, tcore.LatencyModel(SPEC), **kw)
    return sim.run_sessions(sessions), sim, router


def _ref_run(policy_name, sessions, n_inst=8, sim_cls=rloop.ClosedLoopSim,
             waves=False, **kw):
    """The reference's run; ``waves=False`` routes its waves request by
    request (no JAX), ``waves=True`` through its wave path (the x64
    shim must be installed)."""
    router = rcore.Router(_policy(policy_name, rcore), n_inst,
                          kv_capacity_tokens=KV)
    if not waves:
        router.route_batch = lambda reqs, now: [router.route(r, now)
                                                for r in reqs]
    sim = sim_cls(router, RSPEC, rcore.LatencyModel(RSPEC), **kw)
    return sim.run_sessions(sessions), sim, router


# ---------------------------------------------------------------------------
# sessions (ports of tests/test_sessions.py, held to the reference)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["chatbot", "agent", "coder",
                                    "toolagent"])
def test_make_sessions_equal_reference(family):
    t = tsess.make_sessions(family, 6, seed=9, start_rate=0.5)
    r = rsess.make_sessions(family, 6, seed=9, start_rate=0.5)
    assert [(s.sid, s.start_t, s.turns_total, s.app, s._patience)
            for s in t] == [(s.sid, s.start_t, s.turns_total, s.app,
                             s._patience) for s in r]
    for a, b in zip(t, r):
        assert content(drive(a)) == content(drive(b))
    assert tsess.session_stats(t) == rsess.session_stats(r)


def test_mixed_sessions_equal_reference():
    mix = {"chatbot": 5, "agent": 4, "coder": 3, "toolagent": 2}
    rates = {"chatbot": 0.4, "agent": 1.5}
    t = tsess.make_mixed_sessions(mix, seed=2, start_rates=rates)
    r = rsess.make_mixed_sessions(mix, seed=2, start_rates=rates)
    assert [(s.sid, s.spec.family, s.start_t) for s in t] == \
        [(s.sid, s.spec.family, s.start_t) for s in r]
    for a, b in zip(t, r):
        assert content(drive(a, ttft=0.3)) == content(drive(b, ttft=0.3))
    t = tsess.make_mixed_fleet_sessions(mix, seed=3)
    r = rsess.make_mixed_fleet_sessions(mix, seed=3)
    for a, b in zip(t, r):
        assert a.spec.model_requirement == \
            rsess.MIXED_FLEET_REQUIREMENTS.get(a.spec.family, "")
        assert content(drive(a)) == content(drive(b))
    assert tsess.MIXED_FLEET_REQUIREMENTS == rsess.MIXED_FLEET_REQUIREMENTS


def test_abandon_hazard_equals_reference():
    for mean in (0.0, 0.5, 2.0, 7.5, 40.0):
        for b in range(-1, 60):
            assert tsess.abandon_hazard(b, mean) == \
                rsess.abandon_hazard(b, mean)
    assert tsess.abandon_hazard(0, 2.0) < tsess.abandon_hazard(6, 2.0) \
        <= 1.0


def test_session_stream_deterministic():
    a = drive(tsess.make_sessions("coder", 1, seed=9)[0])
    b = drive(tsess.make_sessions("coder", 1, seed=9)[0])
    assert content(a) == content(b)
    c = drive(tsess.make_sessions("coder", 1, seed=10)[0])
    assert [r.blocks for r in a] != [r.blocks for r in c]


def test_session_content_independent_of_latency():
    fast = drive(tsess.make_sessions("coder", 1, seed=4)[0], ttft=0.01)
    slow = drive(tsess.make_sessions("coder", 1, seed=4)[0], ttft=1.0)
    assert [r.blocks for r in fast] == [r.blocks for r in slow]
    assert [r.output_len for r in fast] == [r.output_len for r in slow]
    if len(fast) > 1:
        assert slow[1].arrival > fast[1].arrival


def test_codeagent_prompt_embeds_prior_output():
    log = drive(tsess.make_sessions("coder", 1, seed=2)[0])
    assert len(log) >= 2
    for a, b in zip(log, log[1:]):
        assert b.blocks[:len(a.blocks)] == a.blocks
        assert len(b.blocks) - len(a.blocks) > max(1, a.output_len // 64)


def test_api_fanout_same_timestamp_waves():
    sess = None
    for seed in range(20):
        s = tsess.make_sessions("agent", 1, seed=seed)[0]
        if s.turns_total >= 2:
            first = s.start()
            if len(first) >= 2:
                sess = s
                break
    assert sess is not None
    assert len({r.arrival for r in first}) == 1
    for r in first[:-1]:
        r.t_first_token, r.t_finish = r.arrival + 0.01, r.arrival + 0.1
        assert sess.on_complete(r, r.t_finish) == []
    last = first[-1]
    last.t_first_token, last.t_finish = last.arrival + 0.01, \
        last.arrival + 5.0
    nxt = sess.on_complete(last, last.t_finish)
    assert nxt and all(r.arrival > last.t_finish for r in nxt)


def test_abandonment_on_slo_breach():
    sess = tsess.make_sessions("chatbot", 1, seed=1,
                               slo=tsess.SLO(ttft=0.1, tpot=0.001))[0]
    sess._patience = 2
    sess.turns_total = 50
    log = drive(sess, ttft=10.0, tpot=0.5)
    assert sess.abandoned and not sess.completed
    assert len(log) < 50
    st = tsess.session_stats([sess])
    assert st["abandoned"] == 1 and st["abandon_rate"] == 1.0


def test_no_abandonment_when_slo_met():
    sessions = tsess.make_sessions("chatbot", 5, seed=3)
    for s in sessions:
        drive(s)
    st = tsess.session_stats(sessions)
    assert st["abandoned"] == 0 and st["completed"] == 5


def test_sessions_block_ranges_disjoint():
    a, b = tsess.make_sessions("chatbot", 2, seed=0)
    pa = {blk for r in drive(a) for blk in r.blocks}
    pb = {blk for r in drive(b) for blk in r.blocks}
    shared = pa & pb
    assert len(shared) <= tsess.SESSIONS["chatbot"].app_prefix_blocks
    assert all(blk >= (1 << 60) for blk in shared)


def test_make_trace_closed_loop_escape_hatch():
    sessions = ttraces.make_trace("coder", qps=8.0, duration=60.0, seed=5,
                                  closed_loop=True)
    assert sessions and all(isinstance(s, tsess.Session) for s in sessions)
    ref = rtraces.make_trace("coder", qps=8.0, duration=60.0, seed=5,
                             closed_loop=True)
    assert [(s.sid, s.start_t, s.turns_total, s.app) for s in sessions] \
        == [(s.sid, s.start_t, s.turns_total, s.app) for s in ref]
    reqs = ttraces.make_trace("coder", qps=8.0, duration=60.0, seed=5)
    assert all(isinstance(r, Request) and r.rid >= 0 for r in reqs)
    with pytest.raises(ValueError):
        ttraces.make_trace("hotspot", qps=8.0, duration=60.0,
                           closed_loop=True)


def test_mixed_sessions_disjoint_and_deterministic():
    mix = {"chatbot": 5, "agent": 4, "coder": 3}
    a = tsess.make_mixed_sessions(mix, seed=2)
    b = tsess.make_mixed_sessions(mix, seed=2)
    assert len(a) == 12 and len({s.sid for s in a}) == 12
    assert {s.spec.family for s in a} == {"chatbot", "agent", "coder"}
    assert [(s.sid, s.spec.family, s.start_t, s.turns_total) for s in a] \
        == [(s.sid, s.spec.family, s.start_t, s.turns_total) for s in b]
    solo = tsess.make_sessions("agent", 4, seed=2)
    mixed_agents = sorted((s for s in a if s.spec.family == "agent"),
                          key=lambda s: s.sid)
    assert [s.start_t for s in mixed_agents] == [s.start_t for s in solo]
    assert all(a[i].start_t <= a[i + 1].start_t
               for i in range(len(a) - 1))


def test_blocks_to_tokens_shared_prefix():
    toks_a = tsess.blocks_to_tokens((1, 2, 3), tokens_per_block=8)
    toks_b = tsess.blocks_to_tokens((1, 2, 7), tokens_per_block=8)
    assert toks_a.dtype == np.int32 and len(toks_a) == 24
    np.testing.assert_array_equal(toks_a[:16], toks_b[:16])
    assert not np.array_equal(toks_a[16:], toks_b[16:])
    np.testing.assert_array_equal(
        toks_a, rsess.blocks_to_tokens((1, 2, 3), tokens_per_block=8))


# ---------------------------------------------------------------------------
# the closed-loop drivers (ports of tests/test_closed_loop.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,policy", [
    ("agent", "lmetric"),        # fan-out waves through route_score
    ("coder", "lmetric"),
    ("agent", "session-affinity"),
])
def test_closed_loop_bit_identical_across_runs_and_to_reference(family,
                                                                policy):
    a, _, _ = _run(policy, tsess.make_sessions(family, 40, seed=6,
                                               start_rate=2.0))
    b, _, _ = _run(policy, tsess.make_sessions(family, 40, seed=6,
                                               start_rate=2.0))
    assert len(a) > 60 and _log(a) == _log(b)
    ref, _, _ = _ref_run(policy, rsess.make_sessions(family, 40, seed=6,
                                                     start_rate=2.0))
    assert _log(a) == _log(ref)


def test_closed_loop_seed_changes_trace():
    a, _, _ = _run("lmetric", tsess.make_sessions("agent", 30, seed=1))
    b, _, _ = _run("lmetric", tsess.make_sessions("agent", 30, seed=2))
    assert [r.blocks for r in a] != [r.blocks for r in b]


class _SequentialClosedLoopSim(tloop.ClosedLoopSim):
    def _on_arrivals(self, reqs):
        for req in reqs:
            self._on_arrival(req)


def test_feedback_waves_batch_equals_sequential(monkeypatch):
    """Feedback-pushed same-timestamp waves (API fan-out) go through
    ``route_batch`` — one ``route_score`` call each — and route as
    request-by-request routing does."""
    calls = []
    submit = route_score.route_wave_submit

    def counted(kind, *a):
        calls.append(kind)
        return submit(kind, *a)
    monkeypatch.setattr(route_score, "route_wave_submit", counted)
    fast, sim, router = _run("lmetric", tsess.make_sessions(
        "agent", 60, seed=11, start_rate=4.0))
    assert calls == ["lmetric"] * router.pipeline.waves
    assert router.pipeline.waves > 20
    ref, _, _ = _run("lmetric", tsess.make_sessions(
        "agent", 60, seed=11, start_rate=4.0),
        sim_cls=_SequentialClosedLoopSim)
    assert _log(fast) == _log(ref)


def test_closed_loop_equals_reference_wave_path(x64):
    """The reference's own wave path on feedback waves gives the port's
    run."""
    t, _, router = _run("lmetric", tsess.make_sessions(
        "agent", 40, seed=12, start_rate=4.0))
    r, _, rrouter = _ref_run("lmetric", rsess.make_sessions(
        "agent", 40, seed=12, start_rate=4.0), waves=True)
    assert _log(t) == _log(r)
    assert router.pipeline.waves == rrouter.pipeline.waves > 10


def test_open_loop_same_timestamp_waves_deterministic():
    trace = ttraces.make_trace("agent", qps=20.0, duration=60.0, seed=3)
    for r in trace:
        r.arrival = round(r.arrival, 0)
    trace.sort(key=lambda r: r.arrival)
    logs = []
    for _ in range(2):
        router = tcore.Router(tcore.make_policy("lmetric"), 8,
                              kv_capacity_tokens=KV, device="cpu")
        sim = tsim.ClusterSim(router, SPEC, tcore.LatencyModel(SPEC))
        logs.append(_log(sim.run(copy.deepcopy(trace))))
    assert logs[0] == logs[1]


def test_closed_loop_arrivals_respect_completion_order():
    done, _, _ = _run("vllm", tsess.make_sessions("coder", 25, seed=8))
    by_sid = {}
    for r in done:
        by_sid.setdefault(r.session_id, []).append(r)
    checked = 0
    for reqs in by_sid.values():
        reqs.sort(key=lambda r: r.arrival)
        for a, b in zip(reqs, reqs[1:]):
            assert b.arrival >= a.t_finish - 1e-12
            checked += 1
    assert checked > 20


def test_all_sessions_terminate_and_requests_tagged():
    sessions = tsess.make_sessions("coder", 30, seed=5)
    done, _, _ = _run("lmetric", sessions)
    st = tsess.session_stats(sessions)
    assert st["completed"] + st["abandoned"] == 30
    assert len(done) == st["requests_issued"]
    assert all(r.family == "coder" and r.session_id >= 0 for r in done)
    assert sorted(r.rid for r in done) == list(range(len(done)))


def test_summarize_slo_goodput_and_families():
    def req(rid, fam, ttft, tpot, out=11):
        r = Request(rid=rid, arrival=0.0, blocks=(1,), prompt_len=64,
                    output_len=out, family=fam)
        r.t_first_token = ttft
        r.t_finish = ttft + tpot * (out - 1)
        return r

    reqs = [req(0, "chatbot", 0.5, 0.010), req(1, "chatbot", 3.0, 0.010),
            req(2, "coder", 0.5, 0.050), req(3, "coder", 0.5, 0.010)]
    s = tmetrics.summarize(reqs, slo_ttft=2.0, slo_tpot=0.020)
    assert s["n"] == 4
    assert s["ttft_slo_attainment"] == pytest.approx(0.75)
    assert s["tpot_slo_attainment"] == pytest.approx(0.75)
    assert s["slo_attainment"] == pytest.approx(0.5)
    assert s["goodput_rps"] == pytest.approx(2 / s["makespan"])
    fams = s["families"]
    assert set(fams) == {"chatbot", "coder"}
    assert fams["chatbot"]["n"] == 2
    assert fams["chatbot"]["slo_attainment"] == pytest.approx(0.5)
    assert "families" not in fams["chatbot"]
    s1 = tmetrics.summarize([req(0, "", 0.5, 0.0, out=1)])
    assert s1["tpot_slo_attainment"] == 1.0
    assert "families" not in s1


def test_session_affinity_pins_and_hint():
    sessions = tsess.make_sessions("coder", 20, seed=13)
    done, _, router = _run("session-affinity", sessions)
    by_sid = {}
    for r in done:
        by_sid.setdefault(r.session_id, []).append(r)
    multi = [v for v in by_sid.values() if len(v) >= 3]
    assert multi
    sticky = [v for v in multi if len({r.sched_to for r in v}) == 1]
    assert len(sticky) / len(multi) > 0.8
    assert router.session_pin(sticky[0][0].session_id) == \
        sticky[0][0].sched_to
    assert router.session_pin(10 ** 9) is None


@pytest.mark.parametrize("policy", [
    "vllm", "linear", "dynamo", "filter", "llm-d", "preble",
    "polyserve", "lmetric", "session-affinity"])
def test_every_policy_completes_closed_loop(policy):
    sessions = tsess.make_sessions("coder", 12, seed=21, start_rate=1.0)
    done, _, _ = _run(policy, sessions)
    st = tsess.session_stats(sessions)
    assert st["completed"] + st["abandoned"] == 12
    assert len(done) == st["requests_issued"] > 0
    s = tmetrics.summarize(done)
    assert np.isfinite(s["ttft_mean"]) and np.isfinite(s["goodput_rps"])
    ref, _, _ = _ref_run(policy, rsess.make_sessions("coder", 12, seed=21,
                                                     start_rate=1.0))
    assert _log(done) == _log(ref)


def test_pd_disagg_closed_loop_equals_reference():
    def go(port):
        sess = tsess if port else rsess
        sessions = sess.make_sessions("agent", 25, seed=17, start_rate=3.0)
        if port:
            sim = tloop.ClosedLoopPDSim(3, 5, SPEC, kv_capacity_tokens=KV,
                                        device="cpu")
        else:
            sim = rloop.ClosedLoopPDSim(3, 5, RSPEC, kv_capacity_tokens=KV)
            # the reference PD pool's waves call its JAX route_score
            # directly; route them one by one instead
            sim._on_arrivals = lambda reqs: [sim._on_arrival(r)
                                             for r in reqs]
        done = sim.run_sessions(sessions)
        return _log(done), tsess.session_stats(sessions)
    (la, sa), (lb, sb) = go(True), go(True)
    assert la and la == lb and sa == sb
    assert sa["completed"] + sa["abandoned"] == 25
    assert go(False) == (la, sa)


# ---------------------------------------------------------------------------
# overload control in the closed loop: patience retraction, feedback of
# dropped turns
# ---------------------------------------------------------------------------
CONTROLS = {
    # a threshold below the hazard at no breach (e^-2 for a patience
    # mean of 2): every session's late-predicted turns are retractable
    "patience": dict(patience_retraction=True, patience_threshold=0.1),
    "admission+retraction": dict(admission=True, retraction=True),
}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controlled_closed_loop_equals_reference(control):
    """An overloaded mixed closed loop: drops feed back to their
    sessions (``sessions.dropped_turns``), and finished logs, drops and
    session outcomes are the reference's."""
    mix = {"chatbot": 30, "agent": 30, "coder": 20}
    rates = {"chatbot": 9.0, "agent": 18.0, "coder": 6.0}
    kw = dict(overload=tcore.OverloadControl(**CONTROLS[control]))
    ts = tsess.make_mixed_sessions(mix, seed=11, start_rates=rates)
    obs = make_obs(metrics=True)
    router = tcore.Router(tcore.make_policy("lmetric"), 4,
                          kv_capacity_tokens=KV, obs=obs, device="cpu")
    sim = tloop.ClosedLoopSim(router, SPEC, tcore.LatencyModel(SPEC), **kw)
    done = sim.run_sessions(ts)
    rs = rsess.make_mixed_sessions(mix, seed=11, start_rates=rates)
    rdone, rsim_, _ = _ref_run(
        "lmetric", rs, n_inst=4,
        overload=rcore.OverloadControl(**CONTROLS[control]))
    assert _log(done) == _log(rdone)
    assert [(r.rid, r.drop_reason, r.t_drop) for r in sim.dropped] == \
        [(r.rid, r.drop_reason, r.t_drop) for r in rsim_.dropped]
    assert tsess.session_stats(ts) == rsess.session_stats(rs)
    assert sim.overload_stats() == rsim_.overload_stats()
    assert sim.dropped
    snap = sim.metrics_snapshot()
    assert snap["counters"]["sessions.dropped_turns"] == len(sim.dropped)
    s = tmetrics.summarize(done, per_family_slo=True,
                           registry_snapshot=snap)
    assert set(s["interference"]["queue_delay_ms"]) == \
        {"chatbot", "agent", "coder"}
    assert s["interference"]["displaced_tokens"]
