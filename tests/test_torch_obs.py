"""The port's observability (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Ports of ``tests/test_obs.py``:

* registry semantics (ring histograms keep exact count/sum/max past
  capacity, sorted snapshots, deterministic merges, idempotent
  fixed-slot worker ingestion) and the trace round trip (span nesting,
  pid tracks, virtual timestamps, validation, the sampling knob);
* obs off and fully on give the decisions of the reference's frozen
  scalar policy, on the serial backend (1 and 4 shards) and the thread
  backend (4 shards); the process backend is marked ``process``;
* two identical runs give byte-identical trace JSON;
* ``metrics_snapshot`` mirrors the router's own accumulators;
* the multiplication-failure detector.

Beyond them, exact parity with the reference: the same drive of 200
hotspot requests over 16 instances through ``route_batch`` (the
reference's wave path under the jax 0.9 ``enable_x64`` shim) with
``make_obs(metrics=True, trace=True, provenance=True, sample_every=2)``
gives the reference's provenance records, its ``tracer.to_json()`` byte
for byte, its registry counters (all but the wall-clock ``*_ns`` ones)
and its histogram sample counts.

The reference's wall-time budget test (enabled obs within 5% of a
closed-loop run) is not ported here: a wall-time ratio on a shared CPU
under a parallel test run is noise.  ``chip_smoke.py`` phase 15 measures
and prints that ratio on the card's machine.
"""
import collections
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core import Router as JRouter  # noqa: E402
from repro.core import make_policy as jmake  # noqa: E402
from repro.core.scalar_ref import make_scalar_policy  # noqa: E402
from repro.obs import make_obs as jmake_obs  # noqa: E402
from repro.workloads.traces import make_hotspot_trace as jtrace  # noqa: E402
from repro_torch.core import Router, make_policy  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402
from repro_torch.obs.provenance import ProvenanceRecorder  # noqa: E402
from repro_torch.obs.registry import (N_WORKER_SLOTS, WORKER_SLOTS,  # noqa: E402
                                      Histogram, MetricsRegistry,
                                      merge_snapshots)
from repro_torch.obs.trace import (ROUTER_PID, SpanTracer, load_trace,  # noqa: E402
                                   shard_pid, validate_events)
from repro_torch.workloads.traces import make_hotspot_trace  # noqa: E402

N_INST = 16
KV = 150_000
TRACE_KW = dict(qps=12.0, duration=80.0, seed=5, burst_start=20.0,
                burst_len=40.0)


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


# ---------------------------------------------------------------------------
# 1. registry
# ---------------------------------------------------------------------------
def test_histogram_ring_wraps_with_exact_totals():
    h = Histogram(capacity=8)
    xs = [float(i) for i in range(20)]
    for x in xs:
        h.record(x)
    assert h.count == 20
    assert h.total == sum(xs)
    assert h.max == 19.0
    assert list(h.samples()) == xs[-8:]
    st = h.stats()
    assert st["count"] == 20 and st["p50"] == pytest.approx(15.5)


def test_snapshot_sorted_and_merge_deterministic():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.inc("z.count", 2)
    a.inc("a.count", 1)
    a.gauge("depth", 3.0)
    a.observe("lat", 1.0)
    a.observe("lat", 3.0)
    b.inc("z.count", 5)
    b.gauge("depth", 2.0)
    b.observe("lat", 7.0)
    sa, sb = a.snapshot(), b.snapshot()
    assert list(sa["counters"]) == sorted(sa["counters"])
    json.dumps(sa)
    m = merge_snapshots([sa, sb])
    assert m["counters"]["z.count"] == 7
    assert m["counters"]["a.count"] == 1
    assert m["gauges"]["depth"] == 3.0
    assert m["hists"]["lat"]["count"] == 3
    assert m["hists"]["lat"]["sum"] == pytest.approx(11.0)
    assert m["hists"]["lat"]["max"] == 7.0
    assert m == merge_snapshots([sa, sb])
    # the same records give the reference's snapshots and merge
    from repro.obs.registry import MetricsRegistry as JRegistry
    from repro.obs.registry import merge_snapshots as jmerge
    ja, jb = JRegistry(), JRegistry()
    for reg, ops in ((ja, a), (jb, b)):
        for k, v in ops.counters.items():
            reg.inc(k, v)
        for k, v in ops.gauges.items():
            reg.gauge(k, v)
        for k, h in ops.hists.items():
            for x in h.samples():
                reg.observe(k, float(x))
    assert ja.snapshot() == sa and jb.snapshot() == sb
    assert jmerge([ja.snapshot(), jb.snapshot()]) == m


def test_worker_block_ingest_idempotent():
    reg = MetricsRegistry()
    block = np.arange(2 * N_WORKER_SLOTS,
                      dtype=np.int64).reshape(2, N_WORKER_SLOTS)
    reg.ingest_worker_block(block)
    reg.ingest_worker_block(block)
    snap = reg.snapshot()["counters"]
    for j, slot in enumerate(WORKER_SLOTS):
        assert snap[f"shard.0.{slot}"] == block[0, j]
        assert snap[f"shard.1.{slot}"] == block[1, j]
        assert snap[f"shard.{slot}"] == int(block[:, j].sum())
    from repro.obs.registry import WORKER_SLOTS as JSLOTS
    assert WORKER_SLOTS == JSLOTS


# ---------------------------------------------------------------------------
# 2. trace round trip
# ---------------------------------------------------------------------------
def _emit_demo(tracer):
    tracer.set_time(1.0)
    tracer.wave_tick()
    with tracer.span("wave", args={"k": 3}):
        with tracer.span("walk"):
            tracer.shard_mark(0, "walk", args={"walks": 1})
            tracer.shard_mark(1, "walk", args={"walks": 1})
        with tracer.span("score"):
            tracer.instant("spec.submit", args={"k": 2})
        with tracer.span("commit"):
            pass
    tracer.set_time(2.0)
    tracer.instant("churn.fail", args={"iid": 3})


def test_trace_round_trip_schema(tmp_path):
    tr = SpanTracer(sample_every=1)
    _emit_demo(tr)
    path = str(tmp_path / "trace.json")
    tr.export(path)
    events = load_trace(path)
    names = [(e["ph"], e["name"]) for e in events
             if e["pid"] == ROUTER_PID and e["ph"] in ("B", "E")]
    assert names == [("B", "wave"), ("B", "walk"), ("E", "walk"),
                     ("B", "score"), ("E", "score"), ("B", "commit"),
                     ("E", "commit"), ("E", "wave")]
    meta = {e["pid"]: e["args"]["name"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert meta[ROUTER_PID] == "router"
    assert meta[shard_pid(0)] == "prefix-shard-0"
    assert meta[shard_pid(1)] == "prefix-shard-1"
    marks = [e for e in events if e["ph"] == "i"
             and e["pid"] == shard_pid(0)]
    assert len(marks) == 1 and marks[0]["name"] == "walk"
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts) and ts[0] >= 1_000_000
    # the reference's tracer emits the same document
    from repro.obs.trace import SpanTracer as JTracer
    jt = JTracer(sample_every=1)
    _emit_demo(jt)
    assert json.dumps(jt.to_json(), sort_keys=True) == \
        json.dumps(tr.to_json(), sort_keys=True)


def test_trace_validation_rejects_bad_nesting():
    base = {"ts": 1, "pid": 0, "tid": 0}
    meta = {"name": "process_name", "ph": "M", "ts": 0, "pid": 0,
            "tid": 0, "args": {"name": "router"}}
    with pytest.raises(ValueError, match="bad nesting"):
        validate_events([meta,
                         dict(base, name="a", ph="B"),
                         dict(base, name="b", ph="E", ts=2)])
    with pytest.raises(ValueError, match="unclosed"):
        validate_events([meta, dict(base, name="a", ph="B")])
    with pytest.raises(ValueError, match="no process_name"):
        validate_events([dict(base, name="a", ph="i", pid=9)])


def test_sampling_knob_bounds_span_volume():
    tr = SpanTracer(sample_every=4)
    for _ in range(8):
        tr.wave_tick()
        with tr.span("wave"):
            pass
        tr.instant("drop")
    waves = [e for e in tr.events if e["name"] == "wave"]
    drops = [e for e in tr.events if e["name"] == "drop"]
    assert len(waves) == 2 * 2
    assert len(drops) == 8


# ---------------------------------------------------------------------------
# 3. decisions with obs off and on
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traces():
    """(reference trace, port trace): the first 800 requests."""
    j, p = jtrace(**TRACE_KW), make_hotspot_trace(**TRACE_KW)
    assert len(p) >= 800
    return j[:800], p[:800]


def _drive(router, reqs, batch=8, use_batch=True):
    """Route in waves of ``batch`` under ``tests/test_obs.py``'s
    deterministic drain schedule."""
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


def _port(obs=None, **kw):
    return Router(make_policy("lmetric"), N_INST, kv_capacity_tokens=KV,
                  obs=obs, device="cpu", **kw)


def _decisions(trace, obs=None, walk_backend=None, n_shards=1):
    with _port(obs, walk_backend=walk_backend, n_shards=n_shards) as r:
        return _drive(r, trace)


@pytest.fixture(scope="module")
def scalar_ref(traces):
    """The reference's frozen scalar lmetric, routing request by
    request: the decisions every obs setting must reproduce."""
    router = JRouter(make_scalar_policy("lmetric"), N_INST,
                     kv_capacity_tokens=KV)
    return _drive(router, traces[0], use_batch=False)


@pytest.mark.parametrize("backend,shards", [(None, 1), (None, 4),
                                            ("thread", 4)])
def test_obs_identity_vs_scalar_ref(traces, scalar_ref, backend, shards):
    """Obs off and fully on: the frozen scalar reference's decisions."""
    pt = traces[1]
    assert _decisions(pt, walk_backend=backend,
                      n_shards=shards) == scalar_ref
    obs = make_obs(metrics=True, trace=True, provenance=True,
                   sample_every=2)
    assert _decisions(pt, obs=obs, walk_backend=backend,
                      n_shards=shards) == scalar_ref
    assert obs.registry.counters["provenance.records"] == len(scalar_ref)
    validate_events(obs.tracer.to_json()["traceEvents"])


@pytest.mark.process
def test_obs_identity_process_backend(traces, scalar_ref):
    obs = make_obs(metrics=True, trace=True, provenance=True)
    assert _decisions(traces[1], obs=obs, walk_backend="process",
                      n_shards=4) == scalar_ref
    assert "provenance.records" in obs.registry.snapshot()["counters"]


def test_trace_byte_identical_across_runs(traces):
    sub = traces[1][:200]
    docs = []
    for _ in range(2):
        obs = make_obs(trace=True, sample_every=2)
        _decisions(sub, obs=obs, n_shards=2)
        docs.append(json.dumps(obs.tracer.to_json(), sort_keys=True))
    assert docs[0] == docs[1]


def test_metrics_snapshot_mirrors_legacy_telemetry(traces):
    with _port(n_shards=2) as router:
        _drive(router, traces[1][:200])
        snap = router.metrics_snapshot()["counters"]
        assert snap == router.metrics_snapshot()["counters"]
        f = router.factory
        assert snap["index.walks"] == f.walks
        assert snap["index.walk_ns"] == f.walk_ns
        assert snap["pipeline.waves"] == router.pipeline.waves
        assert snap["router.routed"] == router.routed
        assert snap["shard.walks"] == sum(
            snap[f"shard.{s}.walks"] for s in range(2))


def test_provenance_failure_detector():
    reg = MetricsRegistry()
    p = ProvenanceRecorder(registry=reg, alpha=2.0)
    bs = np.array([1, 1, 1, 9], dtype=np.int64)
    live = np.arange(4)
    assert p._failure_condition(3, bs, None, live) is True
    assert p._failure_condition(0, bs, None, live) is False
    assert p._failure_condition(0, bs[:1], None, live[:1]) is False
    assert p.failure_conditions == 1


# ---------------------------------------------------------------------------
# 4. exact parity of the records with the reference
# ---------------------------------------------------------------------------
def _timeless(counters):
    """The counters that do not hold wall-clock nanoseconds."""
    return {k: v for k, v in counters.items() if not k.endswith("_ns")}


@pytest.mark.parametrize("shards", [1, 2])
def test_records_equal_reference(traces, x64, shards):
    """200 hotspot requests, waves of 8, the wave path of both packages
    with every obs component on: provenance records, trace JSON and
    registry counters are the reference's exactly."""
    jt, pt = (t[:200] for t in traces)
    kw = {} if shards == 1 else {"n_shards": shards}
    jobs = jmake_obs(metrics=True, trace=True, provenance=True,
                     sample_every=2)
    ref = JRouter(jmake("lmetric"), N_INST, kv_capacity_tokens=KV,
                  obs=jobs, **kw)
    try:
        want = _drive(ref, jt)
        jsnap = ref.metrics_snapshot()
    finally:
        ref.close()
    obs = make_obs(metrics=True, trace=True, provenance=True,
                   sample_every=2)
    with _port(obs, **kw) as port:
        assert _drive(port, pt) == want
        snap = port.metrics_snapshot()
        assert port.pipeline.waves == ref.pipeline.waves == 200 // 8
    assert json.dumps(obs.provenance.records, sort_keys=True) == \
        json.dumps(jobs.provenance.records, sort_keys=True)
    assert len(obs.provenance.records) == 200
    assert obs.provenance.summary() == jobs.provenance.summary()
    assert json.dumps(obs.tracer.to_json(), sort_keys=True) == \
        json.dumps(jobs.tracer.to_json(), sort_keys=True)
    assert _timeless(snap["counters"]) == _timeless(jsnap["counters"])
    assert set(snap["counters"]) == set(jsnap["counters"])
    assert {k: h["count"] for k, h in snap["hists"].items()} == \
        {k: h["count"] for k, h in jsnap["hists"].items()}
    assert snap["hists"]["pipeline.wave_size"] == \
        jsnap["hists"]["pipeline.wave_size"]


def test_provenance_beside_speculative_walks():
    """On the thread backend the simulator's pipeline walks the next
    wave while this one commits; provenance walks the index once per
    decision inside the commit.  The speculation is still consumed (the
    insert capture holds), and the run equals the serial run without
    obs."""
    import repro_torch.cluster.simulator as tsim
    from repro_torch.configs import get_config
    from repro_torch.core import LatencyModel, spec_from_config
    spec = spec_from_config(get_config("qwen2_7b"))
    trace = make_hotspot_trace(**TRACE_KW)[:400]
    for r in trace:
        r.arrival = round(r.arrival / 0.5) * 0.5
    trace.sort(key=lambda r: r.arrival)

    def run(obs, **kw):
        with _port(obs, **kw) as router:
            sim = tsim.ClusterSim(router, spec, LatencyModel(spec))
            done = sim.run(copy.deepcopy(trace))
            return [(r.rid, r.sched_to, r.hit_tokens, r.t_finish)
                    for r in done], router.pipeline.stage_stats()

    want, _ = run(None)
    obs = make_obs(metrics=True, trace=True, provenance=True,
                   sample_every=1)
    got, st = run(obs, n_shards=4, walk_backend="thread")
    assert got == want
    assert st["prefetch_hits"] > 0
    assert len(obs.provenance.records) == len(trace)
    names = {e["name"] for e in obs.tracer.to_json()["traceEvents"]}
    assert {"spec.submit", "spec.consume", "wave", "walk", "score",
            "commit"} <= names
