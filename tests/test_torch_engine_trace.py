"""What the serving engine records about itself, on the CPU.

* Per-request stamps (``Request.t_admit``, ``token_times``,
  ``restore_s``, ``snapshot_s``, ``frag_bytes``) under a fake clock in
  ``EngineCluster.run``: admission precedes the first token, every served
  token is timed, and first token less admission is the walls of the
  engine's steps from the admitting step to the first-token step (the
  request's prefill chunks, and the decode steps it sat out stalled).
* The engines' accumulators equal the sums of those stamps, and
  ``EngineCluster.metrics_snapshot`` / ``ingest_engine`` mirror them
  idempotently.
* The profiler ranges: under ``torch.profiler`` (CPU activity) each
  ``engine.*``, ``cluster.*`` and ``model.moe`` range appears once per
  step (or call) of its kind, nested as ``serving/engine.py`` says, and
  is recorded as a CPU operation (not a user annotation, which a device
  trace would give a device-side copy); with the profiler off no range
  is entered.

Port only (no JAX): the smoke configs' own random weights, float32.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.profiling as profiling  # noqa: E402
import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import LMetricPolicy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs.registry import (ENGINE_COUNTERS,  # noqa: E402
                                      MetricsRegistry, ingest_engine)
from repro_torch.serving.engine import EngineCluster  # noqa: E402

KW = dict(block_size=16, max_batch=2, max_len=128, chunk_tokens=16)
TICK = 1 / 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread runs them fastest and
    leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["qwen3_4b-smoke",
                                        "qwen3_30b_moe-smoke"])
def model(request):
    cfg = dataclasses.replace(get_config(request.param), dtype="float32")
    m = Model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _arrivals():
    """Two shared 32-token prefixes; prompts of 36-56 tokens, so each
    takes several chunks and some stall on an engine's last slot."""
    rng = np.random.RandomState(11)
    prefixes = [rng.randint(4, 500, 32) for _ in range(2)]
    out, t = [], 0.0
    for i in range(12):
        tail = rng.randint(4, 500, int(rng.randint(4, 25)))
        out.append((round(t, 3), np.concatenate([prefixes[i % 2], tail]),
                    int(rng.randint(2, 8))))
        t += float(rng.choice([0.0, 0.004, 0.02]))
    return out


class _Clock:
    """Every call advances 1/128 s (exact in binary)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += TICK
        return self.t


def _logged(cluster):
    """Wrap each engine's ``step`` on the instance; returns the log of
    (iid, events) in step order."""
    log = []
    for eng in cluster.engines:
        def wrapped(eng=eng, step=eng.step):
            ev = step()
            log.append((eng.iid, ev))
            return ev
        eng.step = wrapped
    return log


def test_stamps_and_counters_under_fake_clock(model, monkeypatch):
    m, params = model
    monkeypatch.setattr(engine_mod, "time", _Clock())
    cluster = EngineCluster(2, m, params, LMetricPolicy(), device="cpu",
                            **KW)
    log = _logged(cluster)
    arrivals = _arrivals()
    done = cluster.run(arrivals)
    assert len(done) == len(arrivals)
    # each step keeps its two clock reads
    assert all(ev["wall"] == TICK for _, ev in log)
    admit, first = {}, {}
    for k, (iid, ev) in enumerate(log):
        for seq in ev["admitted"]:
            admit[seq.req.rid] = k
        for seq in ev["first"]:
            first[seq.req.rid] = k
    stalled = 0
    for r in done:
        assert 0.0 <= r.t_admit <= r.t_first_token == r.token_times[0]
        assert len(r.token_times) == r.output_len
        assert r.token_times == sorted(r.token_times)
        assert r.token_times[-1] == r.t_finish
        between = [ev for iid, ev in log[admit[r.rid]:first[r.rid] + 1]
                   if iid == r.sched_to]
        t = r.t_admit                 # the engine clock's own sums
        for ev in between:
            t += ev["wall"]
        assert t == r.t_first_token, r.rid
        if all(ev["kind"] == "prefill" for ev in between):
            chunk = KW["chunk_tokens"]
            assert len(between) == -(-(r.prompt_len - r.hit_tokens)
                                     // chunk), r.rid
        else:
            stalled += 1
    engines = cluster.engines
    tot = {name: sum(getattr(e, name) for e in engines)
           for name in ENGINE_COUNTERS}
    # the arrivals exercise hits, stalls and every kind of step
    assert stalled and tot["holds"] and tot["restores"]
    assert tot["restores"] == sum(r.hit_tokens > 0 for r in done)
    assert tot["snapshots"] == len(done)
    assert tot["restore_ns"] * 1e-9 == pytest.approx(
        sum(r.restore_s for r in done), rel=1e-9)
    assert tot["snapshot_ns"] * 1e-9 == pytest.approx(
        sum(r.snapshot_s for r in done), rel=1e-9)
    assert all(r.snapshot_s > 0 for r in done)
    assert tot["copied_bytes"] == sum(r.frag_bytes for r in done) > 0
    assert tot["prefill_tokens"] == sum(r.prompt_len - r.hit_tokens
                                        for r in done)
    assert tot["prefill_steps"] == sum(ev["kind"] == "prefill"
                                       for _, ev in log)
    assert tot["decode_steps"] == sum(ev["kind"] == "decode"
                                      for _, ev in log)
    assert tot["decode_rows"] + len(done) == \
        sum(len(r.token_times) for r in done)
    snap = cluster.metrics_snapshot()
    assert snap == cluster.metrics_snapshot()          # idempotent
    counters = snap["counters"]
    assert counters["router.routed"] == len(arrivals)
    for name in ENGINE_COUNTERS:
        assert counters[f"engine.{name}"] == tot[name]
        assert sum(counters[f"engine.{e.iid}.{name}"]
                   for e in engines) == tot[name]
    reg = MetricsRegistry()
    ingest_engine(reg, engines)
    once = reg.snapshot()
    ingest_engine(reg, engines)
    assert reg.snapshot() == once


def _ranges(prof):
    """name -> [(start, end, is_user_annotation)] of the program's
    ranges."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.split(".")[0] in ("engine", "cluster", "model"):
            s = e.start_ns()
            out[name].append((s, s + e.duration_ns(),
                              e.is_user_annotation()))
    return out


def _inside(children, parents):
    """Every child range lies inside some parent range."""
    return all(any(a <= c0 and c1 <= b for a, b, _ in parents)
               for c0, c1, _ in children)


def test_ranges_once_per_step_and_nested(model, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    m, params = model
    # the fake clock makes the run the first test's (stalls and hits
    # included); the profiler keeps its own clock
    monkeypatch.setattr(engine_mod, "time", _Clock())
    cluster = EngineCluster(2, m, params, LMetricPolicy(), device="cpu",
                            **KW)
    log = _logged(cluster)
    arrivals = _arrivals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cluster.run(arrivals)
    r = _ranges(prof)
    kinds = collections.Counter(ev["kind"] for _, ev in log)
    engines = cluster.engines
    tot = {name: sum(getattr(e, name) for e in engines)
           for name in ENGINE_COUNTERS}
    n_warm = len(engines)          # ``run`` warms each engine up first
    want = {
        "engine.step": len(log),
        "engine.admit": sum(len(ev["admitted"]) for _, ev in log),
        "engine.restore": tot["restores"],
        "engine.prefill": kinds["prefill"],
        "engine.snapshot": tot["snapshots"],
        "engine.decode": kinds["decode"],
        "engine.hold": 2 * tot["holds"],     # the save and the put-back
        "engine.sample": kinds["decode"],
        "engine.decode.commit": kinds["decode"],
        "engine.decode.inputs": kinds["decode"] + n_warm,
        "engine.decode.forward": kinds["decode"] + n_warm,
        "cluster.route": len(arrivals),
        "cluster.hooks": len(log),
    }
    if m.cfg.n_experts:
        # one per layer of every model call: steps, and each warm-up's
        # chunk and decode
        want["model.moe"] = m.cfg.n_layers * (
            kinds["prefill"] + kinds["decode"] + 2 * n_warm)
    assert {k: len(r[k]) for k in want} == want
    assert set(r) == set(want)
    assert tot["holds"] and tot["restores"]
    # CPU operations, not user annotations: no device-side copy
    assert not any(u for v in r.values() for *_, u in v)
    step = r["engine.step"]
    for name in ("engine.admit", "engine.prefill", "engine.snapshot",
                 "engine.decode"):
        assert _inside(r[name], step), name
    assert _inside(r["engine.restore"], r["engine.admit"])
    for name in ("engine.hold", "engine.sample", "engine.decode.commit"):
        assert _inside(r[name], r["engine.decode"]), name
    decode_calls = r["engine.decode"] + [
        x for x in r["engine.decode.forward"]
        if not _inside([x], r["engine.decode"])]
    assert len(decode_calls) == kinds["decode"] + n_warm
    for name in ("engine.decode.inputs", "engine.decode.forward"):
        inside = [x for x in r[name] if _inside([x], r["engine.decode"])]
        assert len(inside) == kinds["decode"], name
    assert not any(_inside([x], step) for x in r["cluster.route"])
    assert not any(_inside([x], step) for x in r["cluster.hooks"])
    if m.cfg.n_experts:
        # in the steps' model calls, or in the warm-ups' chunks
        calls = r["engine.prefill"] + r["engine.decode.forward"]
        stepped = [x for x in r["model.moe"] if _inside([x], calls)]
        assert len(stepped) == m.cfg.n_layers * (
            kinds["prefill"] + kinds["decode"] + n_warm)


class _Counting:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1

    def __exit__(self, *exc):
        return False


def test_no_range_entered_with_profiler_off(model, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    m, params = model
    monkeypatch.setattr(profiling, "Range", _Counting)
    _Counting.entered = 0
    cluster = EngineCluster(2, m, params, LMetricPolicy(), device="cpu",
                            **KW)
    cluster.run(_arrivals()[:4])
    assert _Counting.entered == 0
    # the stand-in is reached once a profiler is on
    with profile(activities=[ProfilerActivity.CPU]):
        cluster.run(_arrivals()[:4])
    assert _Counting.entered > 0
