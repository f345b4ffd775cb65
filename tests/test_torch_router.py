"""The port's routing slice (repro_torch) against the JAX package.

Over the hotspot trace (its first 2000 requests in waves of 64, its
first 800 in waves of 8) at 16 instances, ``route_batch`` of the port
(device="cpu": the plain wave loop stands in for the CUDA kernel) must
make exactly the decisions, with exactly the hit tokens, of the
reference ``Router.route`` (sequential, numpy only) and of the frozen
scalar reference.  The ported host fallbacks, the host half of the wave
path and the state carry-across are held against the reference the same
way.
"""
import collections
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Router as JRouter  # noqa: E402
from repro.core import make_policy as jmake  # noqa: E402
from repro.core.indicators import IndicatorFactory as JFactory  # noqa: E402
from repro.core.scalar_ref import make_scalar_policy  # noqa: E402
from repro.workloads.traces import make_hotspot_trace as jtrace  # noqa: E402
from repro_torch.core import Router, make_policy, router_from_numpy_state  # noqa: E402
from repro_torch.core import indicators as tind  # noqa: E402
from repro_torch.core.state import COLUMNS  # noqa: E402
from repro_torch.workloads.traces import make_hotspot_trace, make_trace  # noqa: E402

N_INST = 16
KV = 150_000
TRACE_KW = dict(qps=14.0, duration=160.0, seed=5, burst_start=40.0,
                burst_len=70.0)
POLICIES = [("vllm", {}), ("linear", {}), ("filter", {}), ("lmetric", {}),
            ("lmetric", dict(kv_indicator="one_minus_hit")),
            ("lmetric", dict(load_indicator="tokens"))]
POLICY_IDS = [f"{n}-{i}" for i, (n, _) in enumerate(POLICIES)]


def _fields(r):
    return (r.rid, r.arrival, r.blocks, r.prompt_len, r.output_len,
            r.class_id, r.session_id, r.family)


@pytest.fixture(scope="module")
def traces():
    """(reference trace, port trace), first 2000 requests of each."""
    j, p = jtrace(**TRACE_KW), make_hotspot_trace(**TRACE_KW)
    assert len(p) >= 2000
    return j[:2000], p[:2000]


def _drive(router, reqs, batch, use_batch, outstanding=None):
    """Route in waves of ``batch`` under the reference's deterministic
    partial-drain schedule (tests/test_batch_routing.py::_drive); the
    hooks only read ``prompt_len``/``output_len`` of a drained request,
    so one ``outstanding`` queue can be handed from one router to
    another."""
    decisions = []
    if outstanding is None:
        outstanding = collections.deque()
    reqs = [copy.copy(r) for r in reqs]   # routing writes request fields
    for i in range(0, len(reqs), batch):
        wave = reqs[i:i + batch]
        now = wave[0].arrival
        if use_batch:
            iids = router.route_batch(wave, now)
        else:
            iids = [router.route(r, now) for r in wave]
        decisions.extend((iid, r.hit_tokens) for iid, r in zip(iids, wave))
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


def _port(name, kw=None, **router_kw):
    router_kw.setdefault("kv_capacity_tokens", KV)
    return Router(make_policy(name, **(kw or {})), N_INST, device="cpu",
                  **router_kw)


def _ref(name, kw=None, maker=jmake, **router_kw):
    router_kw.setdefault("kv_capacity_tokens", KV)
    return JRouter(maker(name, **(kw or {})), N_INST, **router_kw)


def _state(router):
    f = router.factory
    return [getattr(f, c).tolist() for c in COLUMNS]


# ---------------------------------------------------------------------------
def test_trace_matches_reference():
    for kw in (TRACE_KW, dict(qps=30.0, duration=40.0, seed=1)):
        a, b = jtrace(**kw), make_hotspot_trace(**kw)
        assert [_fields(r) for r in a] == [_fields(r) for r in b]
    from repro.workloads.traces import make_trace as jmake_trace
    for fam in ("chatbot", "agent", "coder", "toolagent"):
        a = jmake_trace(fam, 6.0, 60.0, seed=3)
        b = make_trace(fam, 6.0, 60.0, seed=3)
        assert [_fields(r) for r in a] == [_fields(r) for r in b], fam
    with pytest.raises(NotImplementedError):
        make_trace("chatbot", 1.0, 10.0, closed_loop=True)


#: requests routed per wave size: the whole 2000 in waves of 64, and in
#: waves of 8 the first 800 (the hotspot burst starts at request 380)
REQUESTS = {8: 800, 64: 2000}


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("name,kw", POLICIES, ids=POLICY_IDS)
def test_route_batch_matches_reference_route_and_scalar(name, kw, batch,
                                                        traces):
    jt, pt = (t[:REQUESTS[batch]] for t in traces)
    port = _port(name, kw)
    got = _drive(port, pt, batch, True)
    ref = _ref(name, kw)
    want = _drive(ref, jt, batch, False)
    assert got == want, (
        f"{name}{kw} b={batch}: diverges from reference route() at "
        f"{next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)}")
    scalar = _drive(_ref(name, kw, maker=make_scalar_policy), jt, batch,
                    False)
    assert [d for d, _ in got] == [d for d, _ in scalar]
    assert port.pipeline.waves == -(-len(pt) // batch)
    assert _state(port) == _state(ref)
    assert port.policy._tie_n == ref.policy._tie_n


def test_single_request_waves_take_route(traces):
    jt, pt = traces
    port, ref = _port("lmetric"), _ref("lmetric")
    for a, b in zip(copy.deepcopy(pt[:200]), copy.deepcopy(jt[:200])):
        assert port.route_batch([a], a.arrival) == [ref.route(b, b.arrival)]
    assert port.routed == 200 and port.pipeline.waves == 0
    assert port.route_batch([], 0.0) == [] and port.pipeline.waves == 0


def test_exact_only_falls_back(traces):
    jt, pt = traces
    port = _port("lmetric", exact_only=True)
    assert port.policy.plan_batch(copy.deepcopy(pt[:32]), port.factory,
                                  0.0) is None
    got = _drive(port, pt[:600], 16, True)
    want = _drive(_ref("lmetric", exact_only=True), jt[:600], 16, False)
    assert got == want and port.pipeline.waves == 0


def test_no_insert_on_route_falls_back(traces):
    """Identical prompts in one wave: phantom intra-wave credit would
    pile them onto one instance, so the wave must take the host path."""
    jt, pt = traces
    waves = []
    for src in (pt, jt):
        reqs = copy.deepcopy(src[:12])
        for r in reqs[:6]:
            r.blocks, r.prompt_len = reqs[0].blocks, reqs[0].prompt_len
        waves.append(reqs)
    port = _port("lmetric", insert_on_route=False)
    ref = _ref("lmetric", insert_on_route=False)
    assert port.route_batch(waves[0], 0.0) == \
        [ref.route(r, 0.0) for r in waves[1]]
    assert port.pipeline.waves == 0


def test_mid_wave_eviction_falls_back(traces):
    jt, pt = traces
    port = _port("lmetric", kv_capacity_tokens=6_000)
    got = _drive(port, pt[:600], 32, True)
    want = _drive(_ref("lmetric", kv_capacity_tokens=6_000), jt[:600], 32,
                  False)
    assert port.factory.evictions > 0, "capacity too large for the guard"
    assert port.pipeline.waves > 0
    assert got == want


def test_failed_instance_mask_falls_back(traces):
    jt, pt = traces
    port, ref = _port("lmetric"), _ref("lmetric")
    for r in (port, ref):
        r.policy.on_instance_failed(3, N_INST)
    assert not port.policy.batch_supported(port.factory)
    got = _drive(port, pt[:300], 8, True)
    want = _drive(ref, jt[:300], 8, False)
    assert got == want and 3 not in [d for d, _ in got]
    assert port.pipeline.waves == 0
    port.policy.on_instance_recovered(3)
    assert port.policy.batch_supported(port.factory)


def test_state_carry_across(traces):
    """300 requests on the reference, its state carried over, then 300
    more on both routers: identical decisions and final state."""
    jt, pt = traces
    ref = _ref("lmetric")
    out_ref = collections.deque()
    _drive(ref, jt[:300], 8, False, outstanding=out_ref)
    assert ref.factory.evictions == 0
    f = ref.factory
    port = router_from_numpy_state(
        make_policy("lmetric"), N_INST,
        {c: getattr(f, c).copy() for c in COLUMNS},
        [list(inst.kv.chains()) for inst in f], ref.policy._tie_n,
        kv_capacity_tokens=KV, device="cpu")
    assert _state(port) == _state(ref)
    out_port = collections.deque(out_ref)
    want = _drive(ref, jt[300:600], 8, False, outstanding=out_ref)
    got = _drive(port, pt[300:600], 8, True, outstanding=out_port)
    assert got == want
    assert _state(port) == _state(ref)
    with pytest.raises(ValueError):
        router_from_numpy_state(make_policy("vllm"), N_INST, {},
                                [[]] * (N_INST - 1), 0, device="cpu")


def test_wave_inputs_match_reference(traces):
    jt, pt = traces
    jf = JFactory(N_INST, kv_capacity_tokens=KV)
    tf = tind.IndicatorFactory(N_INST, kv_capacity_tokens=KV, device="cpu")
    for i, (a, b) in enumerate(zip(jt[:300], pt[:300])):
        jf[i % N_INST].kv.insert(a.blocks)
        tf[i % N_INST].kv.insert(b.blocks)
    for got, want in zip(tf.wave_inputs(pt[100:180]),
                         jf.wave_inputs(jt[100:180])):
        np.testing.assert_array_equal(got, want)
    for a, b in zip(pt[180:200], jt[180:200]):
        np.testing.assert_array_equal(tf.hits_for(a), jf.hits_for(b))
    # the brute-force LCP block is the running-minimum matrix's reference
    rng = np.random.RandomState(2)
    chains = [tuple([7] + rng.randint(0, 3, rng.randint(1, 40)).tolist())
              for _ in range(120)]
    out = np.zeros((120, 120), dtype=np.int64)
    tind._lcp_block(chains, out, list(range(120)), max_elems=512)
    np.testing.assert_array_equal(out, tind._pairwise_lcp(chains))


def test_kv_unaware_wave_has_no_hit_inputs(traces):
    """vllm (jsq) builds no depth matrix and no LCP matrix for a wave."""
    _, pt = traces
    port = _port("vllm")
    depth, lcp, plen = port.policy.wave_inputs(pt[:8], port.factory)
    assert depth is None and lcp is None
    assert plen.tolist() == [r.prompt_len for r in pt[:8]]
    assert port.factory.walks == 0


def test_device_view_follows_dirty_flag():
    f = tind.IndicatorFactory(5, device="cpu")
    v0 = f.device_view()
    assert f.device_view() is v0
    assert all(t.dtype == torch.int64 and t.shape == (5,) for t in v0)
    f[2].on_route(type("R", (), {"prompt_len": 100})(), 0.0, 40)
    v1 = f.device_view()
    assert v1 is not v0
    assert v1[1].tolist() == [0, 0, 1, 0, 0]       # q_bs
    assert v1[2].tolist() == [0, 0, 60, 0, 0]      # queued prefill
    assert v0[1].tolist() == [0] * 5, "a mirror is a copy, not a view"


def test_instance_hooks_match_reference(traces):
    """Every InstanceState hook, including the retraction hook, writes
    the same indicator columns as the reference's."""
    jt, pt = traces
    jf = JFactory(4)
    tf = tind.IndicatorFactory(4, device="cpu")
    for j, (a, b) in enumerate(zip(jt[:40], pt[:40])):
        i = j % 4
        for f, r in ((jf, a), (tf, b)):
            inst = f[i]
            inst.on_route(r, r.arrival, 64 * (j % 3))
            inst.on_prefill_progress(100 + j)
            if j % 5 == 0:
                inst.on_retract(r, 30)
            elif j % 2:
                inst.on_start_running(r)
                inst.on_decode_token()
                inst.on_finish(r)
        assert [getattr(tf, c).tolist() for c in COLUMNS] == \
            [getattr(jf, c).tolist() for c in COLUMNS]
    assert tf[1].bs == jf[1].bs
    assert tf[1].p_token(pt[1], 64) == jf[1].p_token(jt[1], 64)


def test_scores_batch_matches_reference(traces):
    jt, pt = traces
    port, ref = _port("lmetric"), _ref("lmetric")
    _drive(port, pt[:300], 8, True)
    _drive(ref, jt[:300], 8, False)
    for name, kw in POLICIES:
        got = make_policy(name, **kw).scores_batch(pt[300:316],
                                                   port.factory, 0.0)
        want = jmake(name, **kw).scores_batch(jt[300:316], ref.factory, 0.0)
        np.testing.assert_array_equal(got, want)


def test_unported_options_raise():
    for name in ("dynamo", "preble", "llm-d", "polyserve", "rtb"):
        with pytest.raises(NotImplementedError):
            make_policy(name)
    with pytest.raises(NotImplementedError):
        make_policy("lmetric", load_indicator="cost")
    with pytest.raises(NotImplementedError):
        make_policy("lmetric", detector=object())
    with pytest.raises(KeyError):
        make_policy("nope")


def test_stage_stats_and_telemetry(traces):
    _, pt = traces
    port = _port("lmetric")
    _drive(port, pt[:256], 64, True)
    st = port.stage_stats()
    assert st["waves"] == 4
    assert st["walk_us"] > 0 and st["score_us"] > 0 and st["commit_us"] > 0
    assert len(port.decision_ns) == 256 and port.mean_decision_us() > 0
    assert port.mean_walk_us() > 0
