"""The port's hotspot detector (``repro_torch.core.hotspot``) and the
factory's routed-window rings against the JAX package, on the CPU.

* Ports of ``tests/test_hotspot.py`` onto the port's factory, policy and
  detector.
* A differential test: one seeded stream through the port's ``observe``,
  the reference's ``observe`` and the reference's frozen ``_observe_py``
  (the oracle the port does not carry), with more classes than
  ``top_k`` and window rolls; returned sets, ``history`` and ``events``
  must be equal.
* The rings: one seeded stream of ``log_routed`` / ``window_stats``
  (``trim`` True and False) / ``trim_routed`` / ``routed_window`` on both
  factories, across the 256-entry growth and the horizon trim.

Exact equality throughout: the same float64 arithmetic in the same order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
from repro.core.types import Request as RRequest  # noqa: E402
from repro.workloads.traces import make_hotspot_trace as rtrace  # noqa: E402
from repro_torch.core import (HotspotDetector, IndicatorFactory,  # noqa: E402
                              LMetricPolicy)
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.workloads.traces import make_hotspot_trace  # noqa: E402


def mkreq(rid, t, blocks, cid, cls=Request):
    return cls(rid=rid, arrival=t, blocks=tuple(blocks),
               prompt_len=len(blocks) * 64, output_len=16, class_id=cid)


def route_stream(policy, factory, reqs, drain=True):
    """Route a stream; ``drain`` emulates instances that keep up with the
    load (prefill completes at once) — the adversarial §5.2 regime where
    the BS indicator cannot counterbalance the KV$ indicator."""
    outs = []
    for r in reqs:
        iid = policy.route(r, factory, r.arrival)
        inst = factory[iid]
        hit = inst.kv_hit(r, touch=True)
        inst.on_route(r, r.arrival, hit)
        inst.kv.insert(r.blocks)
        if drain:
            inst.on_prefill_progress(r.prompt_len - hit)
            inst.on_start_running(r)
            inst.on_finish(r)
        outs.append(iid)
    return outs


# ---- ports of tests/test_hotspot.py ---------------------------------------
def test_no_alarm_on_benign_traffic():
    """Eq. 2 holds (diverse classes) -> the detector never activates."""
    det = HotspotDetector(window=60.0, min_requests=5)
    pol = LMetricPolicy(detector=det)
    f = IndicatorFactory(4, device="cpu")
    reqs = [mkreq(i, i * 0.1, (i % 8, 100 + i), cid=i % 8)
            for i in range(200)]
    route_stream(pol, f, reqs)
    assert not any(e["event"] == "activate" for e in det.events)
    assert not pol.batch_supported(f)


def test_hotspot_detected_and_mitigated():
    """One class = 80% of arrivals, its prefix cached on 1 of 4
    instances: Eq. 2 violated -> alarm -> phase-2 confirm -> M
    filtered."""
    det = HotspotDetector(window=600.0, min_requests=5)
    pol = LMetricPolicy(detector=det)
    f = IndicatorFactory(4, device="cpu")
    hot = (7, 7, 7, 7)
    f[0].kv.insert(hot)
    reqs = []
    for i in range(100):
        if i % 5 == 4:
            reqs.append(mkreq(i, i * 0.05, (50 + i,), cid=i))
        else:
            reqs.append(mkreq(i, i * 0.05, hot + (1000 + i,), cid=42))
    outs = route_stream(pol, f, reqs)
    assert any(e["event"] == "alarm" for e in det.events)
    assert any(e["event"] == "activate" for e in det.events)
    act_t = next(e["t"] for e in det.events if e["event"] == "activate")
    after = [iid for r, iid in zip(reqs, outs)
             if r.class_id == 42 and r.arrival > act_t]
    assert after and set(after) - {0}, "mitigation must use other instances"


def test_policy_stream_equals_reference_and_frozen_oracle():
    """The hotspot trace routed by LMetric with a detector: the port's
    decisions, events and history equal the reference's vectorized
    detector's and its frozen ``_observe_py``'s."""
    kw = dict(qps=14.0, duration=150.0, seed=5, burst_start=40.0,
              burst_len=70.0)

    class PyDet(rcore.HotspotDetector):
        def observe(self, *a, **k):
            return self._observe_py(*a, **k)

    def drive(pol, f, trace):
        return route_stream(pol, f, trace[:1500])

    port = HotspotDetector(min_requests=10)
    ref, py = rcore.HotspotDetector(min_requests=10), PyDet(min_requests=10)
    got = drive(LMetricPolicy(detector=port),
                IndicatorFactory(16, kv_capacity_tokens=150_000,
                                 device="cpu"), make_hotspot_trace(**kw))
    for det in (ref, py):
        want = drive(rcore.LMetricPolicy(detector=det),
                     rcore.IndicatorFactory(16, kv_capacity_tokens=150_000),
                     rtrace(**kw))
        assert got == want
        assert port.events == det.events
        assert port.history == det.history
    assert any(e["event"] == "alarm" for e in port.events), \
        "the trace must exercise the detector for this test to bite"


def test_eq2_boundary_math():
    """x/x̄ <= |M|/|M̄| <-> no alarm, via direct observe() calls."""
    det = HotspotDetector(window=600.0, min_requests=4, top_k=100)
    f = IndicatorFactory(4, device="cpu")
    hits = [10, 10, 10, 0]
    scores = [1.0] * 4
    for i in range(10):
        cid = 1 if i % 2 == 0 else (100 + i)
        r = mkreq(i, 0.1 * i, (1,), cid)
        det.observe(r, f, hits, scores, r.arrival)
    assert not any(e["event"] == "alarm" and e["class"] == 1
                   for e in det.events)


# ---- a seeded stream through three observes -------------------------------
def test_observe_differential_seeded_stream():
    """Direct ``observe`` calls on a seeded stream (20 classes, top_k 8,
    a 5-second window over 40 seconds): the port's returned sets,
    history and events equal the reference's vectorized and frozen
    detectors'."""
    rng = np.random.RandomState(21)
    n = 8
    tf = IndicatorFactory(n, device="cpu")
    rf = rcore.IndicatorFactory(n)

    class PyDet(rcore.HotspotDetector):
        def observe(self, *a, **k):
            return self._observe_py(*a, **k)

    kw = dict(window=5.0, top_k=8, min_requests=6)
    dets = [HotspotDetector(**kw), rcore.HotspotDetector(**kw), PyDet(**kw)]
    t, filtered = 0.0, 0
    for i in range(3000):
        t += rng.exponential(0.0133)
        # class 0 is hot (45% of arrivals) and cached on 1-2 instances;
        # the rest spread over 19 classes with random coverage
        cid = 0 if rng.rand() < 0.45 else int(rng.randint(1, 20))
        hits = np.zeros(n, dtype=np.int64)
        if cid == 0:
            m = rng.choice(n, size=rng.randint(1, 3), replace=False)
        else:
            m = rng.choice(n, size=rng.randint(0, n + 1), replace=False)
        hits[m] = rng.randint(1, 40, size=len(m)) * 64
        scores = rng.rand(n) * 100.0
        # the hot class usually scores best on its cached instances
        if cid == 0 and rng.rand() < 0.8:
            scores[m] -= 100.0
        out = []
        for det, f, cls in zip(dets, (tf, rf, rf),
                               (Request, RRequest, RRequest)):
            r = mkreq(i, t, (1,), cid, cls)
            out.append(det.observe(r, f, hits.tolist() if det is dets[2]
                                   else hits, scores, t))
        assert out[0] == out[1] == out[2]
        filtered += bool(out[0])
    port = dets[0]
    for det in dets[1:]:
        assert port.events == det.events
        assert port.history == det.history
    kinds = {e["event"] for e in port.events}
    assert {"alarm", "activate", "clear"} <= kinds and filtered
    assert len(port._row) > port.top_k


# ---- the routed-window rings ----------------------------------------------
def _ring_state(f):
    return (f._log_t.shape, f._log_start.tolist(), f._log_len.tolist(),
            [f.routed_window(i) for i in range(f.n)])


def test_routed_window_rings_equal_reference():
    """One seeded stream of ring operations on both factories: 300
    entries 15 s apart on one instance (its full row is trimmed to the
    one-hour horizon, and the rings do not grow), a burst of 600 on
    another (two doublings of the rings), then 4000 over the fleet with
    windowed stats, trimmed and not, and explicit leading-run trims."""
    rng = np.random.RandomState(5)
    n = 4
    tf = IndicatorFactory(n, device="cpu")
    rf = rcore.IndicatorFactory(n)

    def log(iid, t, p):
        tf.log_routed(iid, t, p)
        rf.log_routed(iid, t, p)

    t = 0.0
    for _ in range(300):
        t += 15.0
        log(2, t, int(rng.randint(0, 5000)))
    # the full row lost its entries older than the horizon instead of
    # doubling every row
    assert tf._log_t.shape[1] == 256 and tf._log_len[2] < 300
    assert tf.routed_window(2)[0][0] > 15.0
    assert _ring_state(tf) == _ring_state(rf)
    for _ in range(600):
        t += 0.1
        log(0, t, int(rng.randint(0, 5000)))
    assert tf._log_t.shape[1] == 1024
    assert _ring_state(tf) == _ring_state(rf)
    for step in range(4000):
        iid = int(rng.choice(n, p=[0.7, 0.1, 0.1, 0.1]))
        t += rng.exponential(2.0)
        # an arrival slightly out of order now and then: the leading-run
        # trim must stop at the first entry inside the window
        log(iid, t - (5.0 if rng.rand() < 0.05 else 0.0),
            int(rng.randint(0, 5000)))
        op = rng.rand()
        if op < 0.05:
            w = float(rng.choice([30.0, 180.0, 900.0]))
            trim = bool(rng.rand() < 0.5)
            before = _ring_state(tf)
            got = tf.window_stats(t, w, trim=trim)
            want = rf.window_stats(t, w, trim=trim)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
            if not trim:
                assert _ring_state(tf) == before
        elif op < 0.08:
            cut = t - float(rng.choice([10.0, 200.0, 2000.0]))
            i = int(rng.randint(n))
            tf.trim_routed(i, cut)
            rf.trim_routed(i, cut)
        if step % 97 == 0:
            assert _ring_state(tf) == _ring_state(rf)
    assert _ring_state(tf) == _ring_state(rf)


def test_instance_hooks_log_and_trim():
    """``on_route`` logs (now, prompt_len - hit); ``routed_log`` reads
    the ring and ``trim_log`` drops the leading run outside a window."""
    f = IndicatorFactory(2, device="cpu")
    for k, t in enumerate((1.0, 2.0, 50.0)):
        r = mkreq(k, t, (1, 2, 3), cid=0)
        f[1].on_route(r, t, hit=64 * k)
    assert f[1].routed_log == [(1.0, 192), (2.0, 128), (50.0, 64)]
    assert f[0].routed_log == []
    f[1].trim_log(60.0, 30.0)
    assert f[1].routed_log == [(50.0, 64)]
