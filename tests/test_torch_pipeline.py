"""The port's routing pipeline with cross-wave walk speculation
(``repro_torch.core.pipeline``), after the reference's
``tests/test_pipeline.py``, on the CPU (the plain version of
``route_score``).

Routing through the three-stage pipeline — with speculation forced,
automatic on the asynchronous thread and process backends, or off —
gives bit-identical assignments, hit tokens and finish times; the
insert capture, the cross-wave LCP patch, the identity check of the
prediction and the eviction guard leave no trace in the output.  The
simulator wires its heap peek as the hint, and a speculating port run
equals the reference's simulator routing request by request.  (The
reference's closed-loop case waits for ``ClosedLoopSim``, ROADMAP Queue
A item 7.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.simulator as rsim  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
from repro_torch.cluster.simulator import ClusterSim  # noqa: E402
from repro_torch.core import IndicatorFactory, Router, make_policy  # noqa: E402
from repro_torch.core.latency_model import EngineSpec  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402


def _spec(ref=False):
    kw = dict(name="test", active_params=7e9, n_layers=28,
              kv_bytes_per_token=1 << 14)
    if ref:
        return rlm.EngineSpec(**kw)
    return EngineSpec(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW, **kw)


def _wave_trace(n_waves=30, k=4, seed=0, gap=0.05, cls=Request):
    """Pre-stamped trace of same-timestamp waves with shared prefixes
    (``tests/test_pipeline.py::_wave_trace``)."""
    rng = np.random.default_rng(seed)
    pool = [tuple(int(x) for x in rng.integers(0, 7,
                                               size=rng.integers(2, 9)))
            for _ in range(12)]
    reqs, rid = [], 0
    for w in range(n_waves):
        t = gap * (w + 1)
        for _ in range(k):
            base = list(pool[int(rng.integers(0, len(pool)))])
            ext = [int(x) for x in rng.integers(0, 7,
                                                size=rng.integers(0, 4))]
            blocks = tuple(base + ext)
            reqs.append(cls(rid=rid, arrival=t, prompt_len=64 * len(blocks),
                            output_len=int(rng.integers(2, 20)),
                            blocks=blocks))
            rid += 1
    return reqs


def _fingerprint(log):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
            for r in sorted(log, key=lambda r: r.rid)]


def _run_open_loop(overlap, backend, n_shards=2, kv_cap=1 << 20, seed=0):
    with Router(make_policy("lmetric"), 16, kv_capacity_tokens=kv_cap,
                n_shards=n_shards, walk_backend=backend,
                pipeline_overlap=overlap, shard_timeout_s=60.0,
                device="cpu") as router:
        sim = ClusterSim(router, _spec())
        fp = _fingerprint(sim.run(_wave_trace(seed=seed)))
        return fp, router.walk_telemetry()["pipeline"]


@pytest.fixture(scope="module")
def reference_run():
    """The reference simulator on the same trace, routing request by
    request (numpy only)."""
    class Sequential(rsim.ClusterSim):
        def _on_arrivals(self, reqs):
            for r in reqs:
                self._on_arrival(r)

    router = rcore.Router(rcore.make_policy("lmetric"), 16,
                          kv_capacity_tokens=1 << 20)
    sim = Sequential(router, _spec(ref=True))
    return _fingerprint(sim.run(_wave_trace(cls=rcore.Request)))


# ---------------------------------------------------------------------------
# bit-identity of the overlapped pipeline
# ---------------------------------------------------------------------------
@pytest.mark.process
@pytest.mark.parametrize("backend,overlap", [
    ("serial", True),          # speculation forced on the sync backend
    ("thread", None),          # auto: async_walks -> overlap on
    ("process", None),
])
def test_overlap_bit_identical_open_loop(backend, overlap, reference_run):
    base, base_tel = _run_open_loop(False, "serial")
    assert base_tel["prefetches"] == 0      # overlap off: no speculation
    assert base == reference_run
    got, tel = _run_open_loop(overlap, backend)
    assert got == base
    assert tel["waves"] == base_tel["waves"] == 30
    assert tel["prefetches"] > 0 and 0 < tel["prefetch_hits"] \
        <= tel["prefetches"]
    assert 0.0 <= tel["overlap_fraction"] <= 1.0


def test_flat_router_does_not_speculate_by_default():
    """Automatic overlap needs an asynchronous walk backend: the flat
    index and the serial backend never speculate unless forced."""
    for kw in ({}, dict(n_shards=2, walk_backend="serial")):
        fp, tel = _run_open_loop(None, kw.get("walk_backend"),
                                 n_shards=kw.get("n_shards", 1))
        assert tel["prefetches"] == 0 and tel["waves"] == 30


def test_eviction_invalidates_capture():
    with IndicatorFactory(2, kv_capacity_tokens=4 * 64,
                          device="cpu") as factory:
        factory.begin_insert_capture()
        factory[0].kv.insert((1, 2, 3))
        inserts, valid = factory.end_insert_capture()
        assert valid and [iid for iid, _ in inserts] == [0]
        factory.begin_insert_capture()
        factory[0].kv.insert((7, 8, 9))       # over capacity -> evicts
        assert factory.evictions > 0
        _, valid = factory.end_insert_capture()
        assert not valid
        assert factory.end_insert_capture() == ([], False)


def test_eviction_heavy_run_stays_bit_identical():
    """Constant eviction pressure with speculation forced: voided
    captures fall back to fresh walks, and the run equals the run
    without speculation."""
    def run(overlap):
        with Router(make_policy("lmetric"), 4, kv_capacity_tokens=16 * 64,
                    n_shards=2, walk_backend="serial",
                    pipeline_overlap=overlap, device="cpu") as router:
            sim = ClusterSim(router, _spec())
            fp = _fingerprint(sim.run(_wave_trace(seed=1)))
            return fp, router.factory.evictions

    base, ev0 = run(False)
    got, ev1 = run(True)
    assert ev0 > 0 and ev1 == ev0
    assert got == base


# ---------------------------------------------------------------------------
# speculation mechanics at the router level
# ---------------------------------------------------------------------------
def _mk_wave(rid0, blocks_list, t=0.0):
    return [Request(rid=rid0 + j, arrival=t, prompt_len=64 * len(b),
                    output_len=4, blocks=b)
            for j, b in enumerate(blocks_list)]


def _route_two_waves(hint_mode, kv=1 << 20):
    """Route two fixed waves; ``hint_mode`` is None (no speculation),
    "right" (the hint is wave 2) or "wrong" (another wave).  With a
    small ``kv`` every instance starts full, so wave 1's commits evict."""
    router = Router(make_policy("lmetric"), 8, kv_capacity_tokens=kv,
                    pipeline_overlap=hint_mode is not None, device="cpu")
    if kv < 1 << 20:
        for inst in router.factory:
            inst.kv.insert((50 + inst.iid,) * (kv // 64))
    wave1 = _mk_wave(0, [(1, 2, 3), (1, 2), (4, 5)])
    wave2 = _mk_wave(3, [(1, 2, 3, 4), (4, 5, 6)])
    if hint_mode == "right":
        router.pipeline.next_wave_hint = lambda: wave2
    elif hint_mode == "wrong":
        router.pipeline.next_wave_hint = lambda: _mk_wave(100,
                                                          [(9, 9), (8, 8)])
    sel1 = router.route_batch(wave1, 0.0)
    router.pipeline.next_wave_hint = lambda: None
    sel2 = router.route_batch(wave2, 1.0)
    out = (sel1, sel2, [r.hit_tokens for r in wave1 + wave2])
    pipe = router.pipeline
    counters = (pipe.prefetches, pipe.prefetch_hits, pipe._spec,
                router.factory.walks)
    router.close()
    return out, counters


def test_prefetch_consumed_on_correct_prediction():
    base, (p, h, spec, walks0) = _route_two_waves(None)
    assert (p, h, spec) == (0, 0, None)
    got, (p, h, spec, walks) = _route_two_waves("right")
    assert (p, h, spec) == (1, 1, None)
    # the speculative walk ran before wave 1's inserts; the capture and
    # the LCP patch make the consumed walk a fresh one's equal
    assert got == base
    assert walks == walks0                  # counted once, when consumed


def test_eviction_during_capture_voids_the_speculation():
    """Wave 1's commits evict while wave 2's speculative walk is out:
    the capture is invalid, the walk is discarded and wave 2 walks
    fresh — the same result as without speculation."""
    base, _ = _route_two_waves(None, kv=4 * 64)
    got, (p, h, spec, _) = _route_two_waves("right", kv=4 * 64)
    assert (p, h, spec) == (1, 0, None)
    assert got == base


def test_misprediction_discarded():
    base, _ = _route_two_waves(None)
    got, (p, h, spec, _) = _route_two_waves("wrong")
    assert (p, h, spec) == (1, 0, None)
    assert got == base


def test_scalar_path_drops_prefetch():
    """A wave that degenerates to the scalar path mutates the index
    without a capture: the pending speculation is dropped first."""
    router = Router(make_policy("lmetric"), 8, kv_capacity_tokens=1 << 20,
                    pipeline_overlap=True, device="cpu")
    router.pipeline.next_wave_hint = lambda: _mk_wave(10, [(5, 5), (6, 6)])
    router.route_batch(_mk_wave(0, [(1, 2, 3), (1, 2)]), 0.0)
    assert router.pipeline._spec is not None
    router.route_batch(_mk_wave(2, [(7, 7)]), 0.5)   # k = 1 -> scalar
    assert router.pipeline._spec is None
    assert router.factory._capture is None           # capture closed
    assert router.pipeline.prefetch_hits == 0
    router.close()


def test_sim_hint_names_the_next_arrival_wave():
    """``ClusterSim`` hands the pipeline ``_next_arrival_wave``: the run
    the event loop coalesces next, also when a step end sits at the heap
    top (where the reference's heap-top peek returns None), with both
    heaps left as they were."""
    router = Router(make_policy("lmetric"), 4, kv_capacity_tokens=1 << 20,
                    device="cpu")
    sim = ClusterSim(router, _spec())
    assert router.pipeline.next_wave_hint == sim._next_arrival_wave
    assert sim._next_arrival_wave() is None
    for r in _wave_trace(n_waves=3, k=3, seed=2):
        sim._push(r.arrival, "arrival", r)
    before = (list(sim._events), list(sim._arrivals))
    assert [r.rid for r in router.pipeline.next_wave_hint()] == [0, 1, 2]
    assert sorted(sim._events) == sorted(before[0])
    assert sorted(sim._arrivals) == sorted(before[1])
    sim._push(0.0, "step_end", None)
    assert sim._peek_next_wave() is None
    assert [r.rid for r in sim._next_arrival_wave()] == [0, 1, 2]


def test_sim_hint_stays_in_step_with_the_run():
    """The hint names the wave the loop routes next at every wave, step
    ends in between or not: of the 30 waves, the 29 that follow another
    are all walked early and every speculation is consumed."""
    with Router(make_policy("lmetric"), 4, kv_capacity_tokens=1 << 20,
                n_shards=2, walk_backend="thread", device="cpu") as router:
        sim = ClusterSim(router, _spec())
        sim.run(_wave_trace(seed=3))
        assert sim._next_arrival_wave() is None and not sim._arrivals
        st = router.stage_stats()
    assert st["waves"] == 30
    assert st["prefetches"] == st["prefetch_hits"] == 29


def test_walk_telemetry_has_pipeline_block():
    router = Router(make_policy("lmetric"), 8, kv_capacity_tokens=1 << 20,
                    pipeline_overlap=False, device="cpu")
    router.route_batch(_mk_wave(0, [(1, 2), (3, 4), (1, 2, 3)]), 0.0)
    tel = router.walk_telemetry()["pipeline"]
    assert tel["waves"] == 1
    for key in ("walk_us", "score_us", "submit_us", "commit_us"):
        assert tel[key] >= 0.0
    assert tel["submit_us"] <= tel["score_us"]
    assert tel["prefetches"] == 0 and tel["prefetch_hits"] == 0
    assert tel["overlap_fraction"] == 0.0
    assert set(router.walk_telemetry()) == {"mean_walk_us", "max_shard_us",
                                            "shards", "pipeline"}
    router.close()


def test_router_passes_shard_options_through_state_carry_across():
    """``router_from_numpy_state`` hands ``n_shards`` and
    ``walk_backend`` to the router it builds."""
    from repro_torch.core import router_from_numpy_state
    cols = {c: np.arange(6, dtype=np.int64) for c in
            ("r_bs", "q_bs", "queued_prefill_tokens", "total_tokens")}
    chains = [[(1, 2, i)] for i in range(6)]
    with router_from_numpy_state(make_policy("lmetric"), 6, cols, chains,
                                 tie=3, n_shards=3, walk_backend="thread",
                                 device="cpu") as r:
        agg = r.factory._agg
        assert agg.n_shards == 3 and agg.backend.name == "thread"
        assert agg.match_depths((1, 2, 4)).tolist() == [2, 2, 2, 2, 3, 2]
        assert r.factory.r_bs.tolist() == list(range(6))
        assert r.policy._tie_n == 3
