"""The port's heterogeneous fleet (``repro_torch.core.fleet``, the
factory's fleet columns and capability masks, the hetero LMetric score,
route-then-balance, ``make_mixed_fleet`` and ``hardware_class_summary``)
against the JAX package's, on the CPU.

Ports of the hetero cases of ``tests/test_hetero_score.py``:

* a constant norm keeps the homogeneous order, and the vectorised score
  with a non-constant norm equals the reference's frozen
  ``ScalarHeteroLMetricPolicy`` (seeded draws of traces and norms);
* a homogeneous fleet collapses to the legacy path, device plan kept;
* the capability mask never routes to an infeasible instance, and the
  routing equals the frozen hetero reference with its own filter, at
  several shard counts on the serial and thread backends (process
  marked ``process``);
* a request nothing can serve is shed at admission, never routed;
* the cross-class detector fires, and captures are classified by kind;
* the fleet columns and snapshot; route-then-balance routes feasibly
  and as the reference's does.

Ports of ``tests/test_obs.py``'s hetero cases: the provenance records'
fleet fields (and their equality with the reference's), and the
mixed-fleet closed loop deciding the same with obs off and fully on
(and as the reference's does).

Plus ``ClusterSim`` on ``make_mixed_fleet()``: finished tuples and drop
reasons equal the reference's.

Every spec is built at the reference's peak rates (the port's default to
the H100's), so that the latency model's floats are the reference's.
"""
import collections
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.cluster.closed_loop as rloop  # noqa: E402
import repro.cluster.metrics as rmetrics  # noqa: E402
import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.sessions as rsess  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.fleet import make_fleet as rmake_fleet  # noqa: E402
from repro.core.indicators import IndicatorFactory as RFactory  # noqa: E402
from repro.core.scalar_ref import make_scalar_policy  # noqa: E402
from repro.obs import make_obs as rmake_obs  # noqa: E402
import repro_torch.cluster.closed_loop as tloop  # noqa: E402
import repro_torch.cluster.metrics as tmetrics  # noqa: E402
import repro_torch.cluster.simulator as tsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.sessions as tsess  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fleet import homogeneous_fleet, make_fleet  # noqa: E402
from repro_torch.core.indicators import IndicatorFactory  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402
from repro_torch.obs.provenance import ProvenanceRecorder  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
N_INST = 16
BLOCK = 64
KV = 150_000
MIXED = (("qwen3_30b_moe", "fast", 8), ("qwen2_7b", "slow", 8))


# ---------------------------------------------------------------------------
# a seeded workload (a pure function of the seed) and the drive loops
# ---------------------------------------------------------------------------
def _mini_trace(seed, n=120, requirements=()):
    """``tests/test_hetero_score.py``'s small shared-prefix trace: five
    app prefixes give real KV$ hits; ``requirements`` are attached to a
    random half."""
    rng = np.random.RandomState(seed)
    apps = [tuple(int(x) for x in rng.randint(0, 50,
                                              size=rng.randint(2, 8)))
            for _ in range(5)]
    reqs, t = [], 0.0
    for rid in range(n):
        app = apps[rng.randint(len(apps))]
        tail = tuple(int(x) for x in
                     rng.randint(50, 1000, size=rng.randint(0, 6)))
        blocks = app + tail
        t += float(rng.exponential(0.05))
        want = ""
        if requirements and rng.rand() < 0.5:
            want = requirements[rng.randint(len(requirements))]
        reqs.append(Request(rid=rid, arrival=t, blocks=blocks,
                            prompt_len=len(blocks) * BLOCK,
                            output_len=int(rng.randint(2, 64)),
                            model_requirement=want))
    return reqs


def _drive_policy(policy, trace, factory):
    """Route straight through the policy, mutating indicator state with a
    drain schedule that is a pure function of the request index."""
    outstanding = collections.deque()
    decisions = []
    for i, req in enumerate(trace):
        iid = policy.route(req, factory, req.arrival)
        decisions.append(iid)
        inst = factory[iid]
        hit = inst.kv_hit(req, touch=True)
        inst.on_route(req, req.arrival, hit)
        inst.kv.insert(req.blocks)
        outstanding.append((iid, req, req.prompt_len - hit))
        inst.on_prefill_progress(256)
        if i % 3 == 0 and outstanding:
            did, dreq, dnew = outstanding.popleft()
            di = factory[did]
            di.on_prefill_progress(dnew)
            di.on_start_running(dreq)
            for _ in range(dreq.output_len % 7):
                di.on_decode_token()
            di.on_finish(dreq)
    return decisions


def _drive_router(router, reqs, batch=8, use_batch=True):
    """Route through the router in waves of ``batch`` with
    ``tests/test_obs.py``'s drain schedule."""
    decisions = []
    outstanding = collections.deque()
    reqs = copy.deepcopy(reqs)
    for i in range(0, len(reqs), batch):
        wave = reqs[i:i + batch]
        now = wave[0].arrival
        if use_batch:
            iids = router.route_batch(wave, now)
        else:
            iids = [router.route(r, now) for r in wave]
        decisions.extend(iids)
        for r, iid in zip(wave, iids):
            outstanding.append((iid, r, r.new_tokens))
            router.factory[iid].on_prefill_progress(256)
        for _ in range(len(wave)):
            if len(outstanding) > 2:
                did, dreq, dnew = outstanding.popleft()
                di = router.factory[did]
                di.on_prefill_progress(dnew)
                di.on_start_running(dreq)
                for _ in range(dreq.output_len % 7):
                    di.on_decode_token()
                di.on_finish(dreq)
    return decisions


def _port_router(policy, fleet=None, **kw):
    return tcore.Router(policy, N_INST if fleet is None else fleet.n,
                        kv_capacity_tokens=kw.pop("kv", KV), fleet=fleet,
                        device="cpu", **kw)


# ---------------------------------------------------------------------------
# (a) the normalised score
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,c", [(0, 1e-6), (1, 3.7e-4), (2, 1.0),
                                    (3, 42.0), (4, 1e6)])
def test_constant_norm_preserves_homogeneous_order(seed, c):
    """One class: the hetero score with any positive constant norm
    routes as the frozen homogeneous reference does (ties included)."""
    trace = _mini_trace(seed)
    want = _drive_policy(make_scalar_policy("lmetric"),
                         copy.deepcopy(trace), RFactory(N_INST, KV))
    f = IndicatorFactory(N_INST, kv_capacity_tokens=KV, device="cpu")
    f.prefill_norm = np.full(N_INST, c)
    got = _drive_policy(tcore.make_policy("lmetric"),
                        copy.deepcopy(trace), f)
    assert got == want, f"c={c} changed the homogeneous argmin"


@pytest.mark.parametrize("seed", [0, 7, 1234, 99991])
def test_vectorized_matches_scalar_hetero_reference(seed):
    """Non-constant norms: the port's vectorised ``LMetricPolicy`` routes
    as ``ScalarHeteroLMetricPolicy`` does, to the last float bit."""
    rng = np.random.RandomState(seed ^ 0xBEEF)
    norm = 10.0 ** rng.uniform(-5, -2, size=N_INST)
    norm[0], norm[1] = 1e-5, 1e-2
    trace = _mini_trace(seed)
    f = IndicatorFactory(N_INST, kv_capacity_tokens=KV, device="cpu")
    f.prefill_norm = norm.astype(np.float64)
    got = _drive_policy(tcore.make_policy("lmetric"),
                        copy.deepcopy(trace), f)
    want = _drive_policy(make_scalar_policy("hetero-lmetric", norm=norm),
                         copy.deepcopy(trace), RFactory(N_INST, KV))
    assert got == want


def test_homogeneous_fleet_collapses_to_legacy_path():
    """A single-class fleet is the fleet-less router: the norm collapses
    to None, the wave path keeps the device plan, and every path routes
    as the frozen scalar reference does."""
    fleet = homogeneous_fleet("qwen2_7b", "fast", N_INST, **REF_RATES)
    assert fleet.norm_or_none() is None
    trace = _mini_trace(77, n=200)
    want = _drive_router(rcore.Router(make_scalar_policy("lmetric"),
                                      N_INST, kv_capacity_tokens=KV),
                         trace, use_batch=False)
    for fl, kw, use_batch in ((None, {}, True), (fleet, {}, True),
                              (fleet, {}, False),
                              (fleet, {"n_shards": 4}, True),
                              (fleet, {"n_shards": 4,
                                       "walk_backend": "thread"}, True)):
        with _port_router(tcore.make_policy("lmetric"), fl, **kw) as r:
            assert r.factory.prefill_norm is None
            assert _drive_router(r, trace, use_batch=use_batch) == want
            assert r.pipeline.waves == (200 // 8 if use_batch else 0)


# ---------------------------------------------------------------------------
# (b) the capability mask
# ---------------------------------------------------------------------------
def _check_feasibility(n_shards, walk_backend, seed):
    fleet = make_fleet(MIXED, **REF_RATES)
    rfleet = rmake_fleet(MIXED)
    assert np.array_equal(fleet.prefill_norm, rfleet.prefill_norm)
    trace = _mini_trace(seed, n=96,
                        requirements=("qwen2_7b", "qwen3_30b_moe"))
    with _port_router(tcore.make_policy("lmetric"), fleet,
                      n_shards=n_shards, walk_backend=walk_backend) as r:
        got = _drive_router(r, trace)
        assert r.pipeline.waves == 0      # hetero norm: host-only
    for req, iid in zip(trace, got):
        if req.model_requirement:
            assert fleet.model_of(iid) == req.model_requirement
    ref = rcore.Router(make_scalar_policy("hetero-lmetric",
                                          norm=rfleet.prefill_norm,
                                          model_names=rfleet.model_names),
                       N_INST, kv_capacity_tokens=KV)
    assert got == _drive_router(ref, trace, use_batch=False)


@pytest.mark.parametrize("walk_backend,n_shards,seed",
                         [(None, 1, 3), (None, 3, 11), (None, 8, 5),
                          ("thread", 2, 17), ("thread", 8, 23)])
def test_capability_mask_never_routes_infeasible(walk_backend, n_shards,
                                                 seed):
    _check_feasibility(n_shards, walk_backend, seed)


@pytest.mark.process
def test_capability_mask_process_backend():
    _check_feasibility(4, "process", seed=11)


def test_infeasible_everywhere_is_shed_not_routed():
    """A requirement no instance serves: the router's masked path
    raises, the admission gate sheds it first (``capability_shed``),
    and the simulator sheds it even with every control off."""
    fleet = make_fleet(MIXED, **REF_RATES)
    with _port_router(tcore.make_policy("lmetric"), fleet) as router:
        ghost = Request(rid=0, arrival=0.0, blocks=(1, 2), prompt_len=128,
                        output_len=8, model_requirement="ghost_model")
        with pytest.raises(ValueError, match="shed it at admission"):
            router.route(ghost, 0.0)
        spec = tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES)
        sim = tsim.ClusterSim(router, spec, tcore.LatencyModel(spec))
        assert sim._admission is not None
        trace = _mini_trace(3, n=40)
        for r in trace[:10]:
            r.model_requirement = "ghost_model"
        done = sim.run(trace)
        shed = [r for r in sim.dropped if r.drop_reason == "shed"]
        assert len(shed) == 10
        assert sim._admission.capability_shed == 10
        assert len(done) == 30
        reg = MetricsRegistry()
        sim._admission.metrics_into(reg)
        assert reg.counters["admission.capability_shed"] == 10
        assert sim.overload_stats()["shed"] == 10


# ---------------------------------------------------------------------------
# (c) the cross-class detector
# ---------------------------------------------------------------------------
def test_cross_class_counterexample_fires_detector():
    fleet = make_fleet([("qwen3_30b_moe", "fast", 1),
                        ("qwen2_7b", "slow", 7)], **REF_RATES)
    obs = make_obs(metrics=True, provenance=True)
    with tcore.Router(tcore.make_policy("lmetric"), 8,
                      kv_capacity_tokens=1 << 20, fleet=fleet, obs=obs,
                      device="cpu") as router:
        f = router.factory
        f.prefill_norm = np.array([1e-6] + [1e-4] * 7)
        f.r_bs[0] = 9
        f.r_bs[1:] = 1
        req = Request(rid=0, arrival=0.0, blocks=(5, 6, 7),
                      prompt_len=3 * BLOCK, output_len=8)
        assert router.route(req, 0.0) == 0
        rec = obs.provenance.records[-1]
        assert rec["failure_condition"] is True
        assert rec["failure_kind"] == "cross_class"
        assert rec["chosen_hardware_class"] == 0
        c = obs.registry.counters
        assert c["provenance.failure_condition"] == 1
        assert c["provenance.failure_condition.cross_class"] == 1
        assert obs.provenance.cross_class_conditions == 1


def test_failure_detector_classifies_capture_kind():
    p = ProvenanceRecorder(alpha=2.0)
    bs = np.array([9, 1, 1, 1], dtype=np.int64)
    live = np.arange(4)
    same = np.zeros(4, dtype=np.int64)
    split = np.array([0, 0, 1, 1], dtype=np.int64)
    assert p._failure_condition(0, bs, None, live, cls=same) is True
    assert p.last_failure_kind == "affinity_capture"
    assert p._failure_condition(0, bs, None, live, cls=split) is True
    assert p.last_failure_kind == "cross_class"
    assert p._failure_condition(1, bs, None, live, cls=split) is False
    assert p.last_failure_kind is None
    assert p.failure_conditions == 2
    assert p.cross_class_conditions == 1


# ---------------------------------------------------------------------------
# fleet plumbing
# ---------------------------------------------------------------------------
def test_fleet_columns_and_snapshot():
    fleet = tsim.make_mixed_fleet(**REF_RATES)
    rfleet = rsim.make_mixed_fleet()
    assert fleet.n == 16
    assert fleet.model_vocab == rfleet.model_vocab == ("qwen3_30b_moe",
                                                       "qwen2_7b")
    assert fleet.class_vocab == rfleet.class_vocab == ("fast", "slow")
    assert np.array_equal(fleet.prefill_norm, rfleet.prefill_norm)
    assert fleet.prefill_norm[0] < fleet.prefill_norm[8]
    # the default (H100) rates keep the order of the two classes
    h100 = tsim.make_mixed_fleet()
    assert h100.prefill_norm[0] < h100.prefill_norm[8]
    f = IndicatorFactory(16, kv_capacity_tokens=1 << 20, fleet=fleet,
                         device="cpu")
    rf = RFactory(16, kv_capacity_tokens=1 << 20, fleet=rfleet)
    assert (f.model_id == fleet.model_codes).all()
    assert (f.hardware_class == fleet.class_codes).all()
    assert f.snapshot() == rf.snapshot()
    mid, cls, norm = f.device_hetero_view()
    assert mid.device == f.device and norm.dtype == torch.float64
    assert (mid.numpy() == fleet.model_codes).all()
    assert (cls.numpy() == fleet.class_codes).all()
    assert np.array_equal(norm.numpy(), fleet.prefill_norm)
    assert f.device_hetero_view() is f.device_hetero_view()
    assert f.feasible_mask("") is None
    assert f.feasible_mask("qwen2_7b") is f.feasible_mask("qwen2_7b")
    assert f.feasible_mask("qwen2_7b").tolist() == [False] * 8 + [True] * 8
    with pytest.raises(ValueError, match="fleet"):
        IndicatorFactory(8, kv_capacity_tokens=1 << 20, fleet=fleet,
                         device="cpu")
    assert "model_id" not in IndicatorFactory(4, device="cpu").snapshot()


def test_route_then_balance_routes_feasibly_as_the_reference():
    fleet = make_fleet(MIXED, **REF_RATES)
    trace = _mini_trace(9, n=96,
                        requirements=("qwen2_7b", "qwen3_30b_moe"))
    for name in ("route-then-balance", "rtb"):
        pol = tcore.make_policy(name)
        assert isinstance(pol, tcore.RouteThenBalancePolicy)
        assert not pol.batch_supported(IndicatorFactory(4, device="cpu"))
    with _port_router(tcore.make_policy("rtb"), fleet) as router:
        got = _drive_router(router, trace)
        sb = router.policy.scores_batch(trace[:4], router.factory, 0.0)
        rref = rcore.Router(rcore.make_policy("rtb"), N_INST,
                            kv_capacity_tokens=KV, fleet=rmake_fleet(MIXED))
        want = _drive_router(rref, trace, use_batch=False)
        assert np.array_equal(
            sb, rref.policy.scores_batch(trace[:4], rref.factory, 0.0))
    assert got == want
    for req, iid in zip(trace, got):
        if req.model_requirement:
            assert fleet.model_of(iid) == req.model_requirement


# ---------------------------------------------------------------------------
# provenance and obs on a mixed fleet (ports of tests/test_obs.py)
# ---------------------------------------------------------------------------
def _hotspot(pkg, n=200):
    kw = dict(qps=12.0, duration=80.0, seed=5, burst_start=20.0,
              burst_len=40.0)
    reqs = pkg.make_hotspot_trace(**kw)[:n]
    for i, r in enumerate(reqs):
        if i % 4 == 0:
            r.model_requirement = "qwen2_7b"
    return reqs


def test_provenance_round_trip_hetero_fields():
    """Every record on a mixed fleet carries the chosen instance's model
    and class codes, the request's requirement and per-candidate
    normalised indicators, survives a JSON round trip, and equals the
    reference's record."""
    fleet = tsim.make_mixed_fleet(**REF_RATES)
    obs = make_obs(metrics=True, provenance=True)
    sub = _hotspot(ttraces)
    with _port_router(tcore.make_policy("lmetric"), fleet,
                      obs=obs) as router:
        got = _drive_router(router, sub)
    recs = json.loads(json.dumps(obs.provenance.records))
    assert len(recs) == len(sub)
    by_rid = {r.rid: r for r in sub}
    for rec in recs:
        iid = rec["chosen"]
        assert rec["chosen_model_id"] == int(fleet.model_codes[iid])
        assert rec["chosen_hardware_class"] == int(fleet.class_codes[iid])
        want = by_rid[rec["rid"]].model_requirement
        assert rec["model_requirement"] == want
        if want:
            assert fleet.model_of(iid) == want
        assert rec["top_k"]
        for e in rec["top_k"]:
            assert e["model_id"] == int(fleet.model_codes[e["iid"]])
            assert e["hardware_class"] == int(fleet.class_codes[e["iid"]])
            assert e["norm"] == float(fleet.prefill_norm[e["iid"]])
    assert obs.registry.counters["provenance.records"] == len(sub)
    robs = rmake_obs(metrics=True, provenance=True)
    ref = rcore.Router(rcore.make_policy("lmetric"), 16,
                       kv_capacity_tokens=KV, fleet=rsim.make_mixed_fleet(),
                       obs=robs)
    assert _drive_router(ref, _hotspot(rtraces)) == got
    assert json.dumps(robs.provenance.records, sort_keys=True) == \
        json.dumps(obs.provenance.records, sort_keys=True)
    assert robs.registry.counters == obs.registry.counters


def _mixed_fates(port, obs=None):
    """The mixed-fleet closed loop of ``tests/test_obs.py`` on the port
    (``port=True``) or the reference: finished and dropped fates."""
    sess = tsess if port else rsess
    sessions = sess.make_mixed_fleet_sessions(
        {"chatbot": 20, "coder": 10, "agent": 10}, seed=9)
    if port:
        fleet = tsim.make_mixed_fleet(**REF_RATES)
        spec = tcore.spec_from_config(get_config("qwen3_30b_moe"),
                                      **REF_RATES)
        router = tcore.Router(tcore.make_policy("lmetric"), fleet.n,
                              kv_capacity_tokens=KV, fleet=fleet, obs=obs,
                              device="cpu")
        sim = tloop.ClosedLoopSim(router, spec, tcore.LatencyModel(spec))
    else:
        fleet = rsim.make_mixed_fleet()
        spec = rcore.spec_from_config(ref_config("qwen3_30b_moe"))
        router = rcore.Router(rcore.make_policy("lmetric"), fleet.n,
                              kv_capacity_tokens=KV, fleet=fleet, obs=obs)
        sim = rloop.ClosedLoopSim(router, spec, rcore.LatencyModel(spec))
    try:
        done = sim.run_sessions(sessions)
        return ([(r.rid, r.sched_to, r.hit_tokens, r.t_finish)
                 for r in done],
                sorted((r.rid, r.drop_reason) for r in sim.dropped))
    finally:
        router.close()


def test_obs_identity_on_mixed_fleet_scenario():
    """A fully enabled obs bundle changes no decision of the mixed-fleet
    closed loop, and both equal the reference's run."""
    base = _mixed_fates(True)
    assert base[0], "the scenario produced no completions"
    full = _mixed_fates(True, make_obs(metrics=True, trace=True,
                                       provenance=True, sample_every=2))
    assert full == base
    assert _mixed_fates(False) == base


# ---------------------------------------------------------------------------
# ClusterSim on the mixed fleet
# ---------------------------------------------------------------------------
def _mixed_trace(pkg):
    trace = pkg.make_trace("chatbot", qps=16.0, duration=40.0, seed=33)
    for i, r in enumerate(trace):
        r.arrival = round(r.arrival / 0.1) * 0.1
        if i % 4 == 0:
            r.model_requirement = "qwen2_7b"
        elif i % 17 == 0:
            r.model_requirement = "ghost_model"
    trace.sort(key=lambda r: r.arrival)
    return trace


@pytest.mark.parametrize("policy", ["lmetric", "rtb"])
def test_cluster_sim_mixed_fleet_equals_reference(policy):
    """``ClusterSim`` over ``make_mixed_fleet()`` (per-instance ground
    truth, the admission gate's capability shed): finished tuples, drop
    reasons and the per-class summary are the reference's."""
    tspec = tcore.spec_from_config(get_config("qwen3_30b_moe"),
                                   **REF_RATES)
    rspec = rcore.spec_from_config(ref_config("qwen3_30b_moe"))
    fleet = tsim.make_mixed_fleet(**REF_RATES)
    port = tsim.ClusterSim(
        tcore.Router(tcore.make_policy(policy), 16, kv_capacity_tokens=KV,
                     fleet=fleet, device="cpu"), tspec,
        tcore.LatencyModel(tspec))
    rfleet = rsim.make_mixed_fleet()
    ref = rsim.ClusterSim(
        rcore.Router(rcore.make_policy(policy), 16, kv_capacity_tokens=KV,
                     fleet=rfleet), rspec, rcore.LatencyModel(rspec))
    tt, rt = _mixed_trace(ttraces), _mixed_trace(rtraces)
    done, rdone = port.run(tt), ref.run(rt)
    fin = [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
           for r in done]
    assert fin == [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token,
                    r.t_finish) for r in rdone]
    drops = [(r.rid, r.drop_reason, r.t_drop) for r in port.dropped]
    assert drops == [(r.rid, r.drop_reason, r.t_drop) for r in ref.dropped]
    assert drops and all(r.model_requirement == "ghost_model"
                         for r in port.dropped)
    assert port.overload_stats() == ref.overload_stats()
    assert len(done) + len(drops) == len(tt)
    for r in done:
        if r.model_requirement:
            assert fleet.model_of(r.sched_to) == r.model_requirement
    assert tmetrics.hardware_class_summary(done, fleet) == \
        rmetrics.hardware_class_summary(rdone, rfleet)
    # one ground-truth model per distinct spec
    assert port.instances[0].model.spec is fleet.specs[0]
    assert port.instances[8].model.spec is fleet.specs[8]
    assert port.instances[1].model is port.instances[0].model
    assert port.instances[0].model is not port.instances[8].model
