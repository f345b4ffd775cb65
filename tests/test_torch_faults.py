"""The port's self-healing shard layer under deterministic fault
injection (``repro_torch.core.faults``), after the fault tests of the
reference's ``tests/test_chaos.py`` that need no churn, fleet or
observability bundle (Contract 6 of ``docs/ARCHITECTURE.md``).

* A seeded plan fires at the same per-shard ordinals as the
  reference's; crashes, stalls and a corruption on every backend at
  1, 2, 4 and 8 shards leave every answer equal to the fault-free flat
  index (the port's and the reference's), tear no backend down, and the
  digest sweep repairs the corruption.
* A worker killed during a speculative walk, with commits landing in
  the capture, is restarted and its walk re-sent; the patched depths
  equal a fresh walk, and the walk is counted once.
* A scoped rebuild leaves healthy shards' objects untouched; the
  timeout precedence; a stall past the deadline heals; a worker that
  fails mid-query is survived by a degraded rebuild.

Leak checks look only at the segments of the backends under test.
"""
import multiprocessing as mp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core import indicators as jind  # noqa: E402
from repro_torch.core import IndicatorFactory  # noqa: E402
from repro_torch.core import shard_backends as tsb  # noqa: E402
from repro_torch.core.faults import (FaultEvent, FaultInjector,  # noqa: E402
                                     FaultPlan, ShardError)
from repro_torch.core.prefix_index import (  # noqa: E402
    AggregatedPrefixIndex, _pairwise_lcp, digest_from_chains)
from repro_torch.core.types import Request  # noqa: E402

BACKENDS = ("serial", "thread", "process")
SHARD_COUNTS = (1, 2, 4, 8)


def _live_workers():
    return [p for p in mp.active_children()
            if p.name.startswith("prefix-shard")]


def _prefix(factory):
    """The process backend's segment prefix (None for other backends)."""
    return getattr(getattr(factory._agg, "backend", None), "shm_prefix",
                   None)


def _no_leaks(prefixes):
    for p in prefixes:
        if p is not None:
            assert not tsb.own_segments(p), p
    assert not _live_workers()


def _rand_chain(rng, vocab=6, max_len=10):
    length = int(rng.integers(1, max_len))
    return tuple(int(x) for x in rng.integers(0, vocab, size=length))


def _seed_kv(factory, n_chains=60, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n_chains):
        iid = int(rng.integers(0, factory.n))
        factory.instances[iid].kv.insert(_rand_chain(rng))


def _probe_chains(rng, k):
    return [_rand_chain(rng, vocab=8) for _ in range(k)]


def _probe(chain, block_size, rid=0, cls=Request):
    return cls(rid=rid, arrival=0.0, prompt_len=len(chain) * block_size,
               output_len=8, blocks=tuple(chain))


def _fresh(factory):
    """A flat index rebuilt from the factory's radix trees (KV truth)."""
    fresh = AggregatedPrefixIndex(factory.n)
    for inst in factory.instances:
        for chain in inst.kv.chains():
            fresh.add(inst.iid, chain)
    return fresh


# ---------------------------------------------------------------------------
def test_fault_plans_fire_as_the_reference():
    """``FaultPlan.seeded`` draws the reference's events, and both
    injectors fire them at the same walk and mutation ordinals."""
    kw = dict(crashes=3, stalls=2, corruptions=2, drops=2, stall_s=0.01)
    port = FaultPlan.seeded(11, n_shards=4, n_walks=20, **kw)
    ref = jfaults.FaultPlan.seeded(11, n_shards=4, n_walks=20, **kw)
    assert [tuple(vars(e).values()) for e in port.events] == \
        [tuple(vars(e).values()) for e in ref.events]
    pi, ri = FaultInjector(port), jfaults.FaultInjector(ref)
    for t in range(25):
        for s in range(4):
            assert [e.kind for e in pi.on_walk(s)] == \
                [e.kind for e in ri.on_walk(s)]
            assert [e.kind for e in pi.on_mutation(s)] == \
                [e.kind for e in ri.on_mutation(s)]
    assert pi.stats() == ri.stats() and pi.pending == 0
    with pytest.raises(ValueError):
        FaultEvent("meltdown", 0, 0)
    assert ShardError(3, "x").shard == 3


@pytest.mark.process
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_fault_matrix_fate_parity(n_shards):
    """Crashes, stalls and a corruption at every backend x shard count:
    no whole-backend teardown, every walk within 2x the walk deadline,
    the sweep repairs the corruption, and the answers equal the
    fault-free flat index's — the port's and the reference's."""
    n = 16
    rng = np.random.default_rng(500 + n_shards)
    singles = _probe_chains(rng, 12)
    waves = [_probe_chains(rng, 4) for _ in range(3)]
    ref = jind.IndicatorFactory(n, kv_capacity_tokens=1 << 20)
    _seed_kv(ref)
    with IndicatorFactory(n, kv_capacity_tokens=1 << 20,
                          device="cpu") as flat:
        _seed_kv(flat)
        want_single, want_wave = [], []
        for c in singles:
            a = np.asarray(ref.hits_for(_probe(c, 64))).copy()
            assert np.array_equal(flat.hits_for(_probe(c, 64)), a)
            want_single.append(a)
        for w in waves:
            a = ref.wave_inputs([_probe(c, 64, i) for i, c in
                                 enumerate(w)])[0].copy()
            assert np.array_equal(flat.wave_inputs(
                [_probe(c, 64, i) for i, c in enumerate(w)])[0], a)
            want_wave.append(a)
    sh = n_shards
    plan = FaultPlan(events=(
        FaultEvent("crash", shard=1 % sh, at=2),
        FaultEvent("crash", shard=3 % sh, at=5),
        FaultEvent("stall", shard=2 % sh, at=4, seconds=0.02),
        FaultEvent("stall", shard=0, at=7, seconds=0.02),
        # past the probes (retried walks advance the ordinals too);
        # tripped by the drain loop below, then repaired by the sweep
        FaultEvent("corrupt", shard=sh - 1,
                   at=len(singles) + len(waves) + 10, seed=321),
    ))
    prefixes = set()
    for backend in BACKENDS:
        with IndicatorFactory(n, kv_capacity_tokens=1 << 20,
                              n_shards=n_shards, walk_backend=backend,
                              shard_timeout_s=10.0, device="cpu") as factory:
            prefixes.add(_prefix(factory))
            inj = FaultInjector(plan)
            factory.attach_faults(inj)
            _seed_kv(factory)
            agg0 = factory._agg
            be = agg0.backend
            deadline = be.walk_deadline
            for c, want in zip(singles, want_single):
                t0 = os.times().elapsed
                hits = factory.hits_for(_probe(c, 64))
                assert os.times().elapsed - t0 < 2 * deadline
                assert np.array_equal(hits, want), (backend, n_shards)
            for w, want in zip(waves, want_wave):
                depth, _, _ = factory.wave_inputs(
                    [_probe(c, 64, i) for i, c in enumerate(w)])
                assert np.array_equal(depth, want), (backend, n_shards)
            for _ in range(40):
                if not inj.pending:
                    break
                factory.hits_for(_probe(singles[0], 64))
            assert not inj.pending
            assert factory.anti_entropy_step(n_shards) in (0, 1)
            assert all(factory.verify_shard(s) for s in range(n_shards))
            assert np.array_equal(factory.hits_for(_probe(singles[0], 64)),
                                  want_single[0])
            assert factory._agg is agg0
            assert not getattr(be, "_closed", False)
            assert len(inj.fired) == len(plan)
            if backend == "process":
                assert factory.degraded_rebuilds == 0
                assert be.heals >= 2
    _no_leaks(prefixes)


@pytest.mark.process
@pytest.mark.parametrize("backend", BACKENDS)
def test_corruption_caught_by_digest_sweep(backend):
    """A silently flipped membership bit is invisible to a walk's error
    paths; the sweep catches it, repairs exactly that shard, and leaves
    every shard's digests equal to KV truth."""
    n, n_shards, target = 16, 4, 2
    repaired = []
    plan = FaultPlan(events=(
        FaultEvent("corrupt", shard=target, at=0, seed=77),))
    with IndicatorFactory(n, kv_capacity_tokens=1 << 20,
                          n_shards=n_shards, walk_backend=backend,
                          shard_timeout_s=10.0, device="cpu") as factory:
        prefix = _prefix(factory)
        factory.on_shard_repair = lambda s, k: repaired.append((s, k))
        factory.attach_faults(FaultInjector(plan))
        _seed_kv(factory, n_chains=80, seed=13)
        factory.hits_for(_probe((1, 2, 3), 64))   # trips the corruption
        assert not factory.verify_shard(target)
        assert factory.verify_mismatches == 1
        assert factory.anti_entropy_step(n_shards) == 1
        assert factory.shard_repairs == 1 and repaired == [(target, 1)]
        for s in range(n_shards):
            assert factory.verify_shard(s)
            inc, scan = factory._agg.shard_digest(s)
            truth = digest_from_chains(factory._shard_chains(s))
            assert tuple(inc) == truth and tuple(scan) == truth
    _no_leaks([prefix])


@pytest.mark.process
def test_worker_restart_mid_speculative_prefetch():
    """A worker killed while a speculative wave walk is out, with
    commits landing in the capture: the supervised backend restarts it
    and re-sends the walk, the capture stays valid, the patched depths
    equal a fresh walk over the final KV state, no factory rebuild — and
    the walk counts once in the factory's telemetry."""
    n, n_shards = 16, 4
    rng = np.random.default_rng(31)
    with IndicatorFactory(n, kv_capacity_tokens=1 << 20,
                          n_shards=n_shards, walk_backend="process",
                          shard_timeout_s=10.0, device="cpu") as factory:
        prefix = _prefix(factory)
        _seed_kv(factory, n_chains=50, seed=31)
        be = factory._agg.backend
        reqs = [_probe(c, 64, i) for i, c in enumerate(_probe_chains(rng, 5))]
        walks0 = factory.walks
        factory.begin_insert_capture()
        h = factory.wave_submit(reqs)
        be._procs[1].kill()                # dies mid-speculative-walk
        be._procs[1].join()
        lo1, _ = factory._agg.bounds[1]
        new_chains = [(lo1, _rand_chain(rng)), (0, _rand_chain(rng))]
        for iid, chain in new_chains:
            factory.instances[iid].kv.insert(chain)
        inserted, valid = factory.end_insert_capture()
        assert valid and len(inserted) == 2
        depth, _, _ = factory.wave_collect(h)
        chains_q = list(h.chains)
        u = len(chains_q)
        cross = _pairwise_lcp(chains_q + [c for _, c in inserted])
        for j, (iid, _) in enumerate(inserted):
            np.maximum(depth[:, iid], cross[:u, u + j][h.uid],
                       out=depth[:, iid])
        assert be.heals >= 1 and be._restarts[1] >= 1
        assert factory.degraded_rebuilds == 0 and not be._closed
        assert factory.walks - walks0 == len(h.chains)
        want = _fresh(factory).match_depths_many([r.blocks for r in reqs])
        assert np.array_equal(depth, want)
    _no_leaks([prefix])


def test_scoped_rebuild_leaves_healthy_shards_untouched():
    n, n_shards = 16, 4
    with IndicatorFactory(n, kv_capacity_tokens=1 << 20, n_shards=n_shards,
                          walk_backend="serial", device="cpu") as factory:
        _seed_kv(factory, n_chains=80, seed=23)
        rebuilds = []
        factory.on_degraded_rebuild = rebuilds.append
        agg0 = factory._agg
        be = agg0.backend
        healthy = {s: be.shards[s] for s in (0, 2, 3)}
        masks = {s: sh._masks for s, sh in healthy.items()}
        broken = be.shards[1]
        ev0 = factory.evictions
        factory._rebuild_index(shard=1)
        assert factory.degraded_rebuilds == 1 and rebuilds == [1]
        assert factory.shard_repairs == 1
        assert factory.evictions == ev0 + 1   # in-flight plans voided
        assert factory._agg is agg0
        assert be.shards[1] is not broken
        for s, sh in healthy.items():
            assert be.shards[s] is sh
            assert be.shards[s]._masks is masks[s]
        assert factory.verify_shard(1)
        probes = _probe_chains(np.random.default_rng(23), 6)
        assert np.array_equal(_fresh(factory).match_depths_many(probes),
                              agg0.match_depths_many(probes))


def test_walk_error_without_a_shard_rebuilds_the_whole_index():
    """An error that names no shard on a flat index: the walk retries on
    a full rebuild from the radix trees."""
    with IndicatorFactory(8, kv_capacity_tokens=1 << 20,
                          device="cpu") as factory:
        _seed_kv(factory, n_chains=30, seed=3)
        calls = []

        class Broken:
            def match_depths(self, *a, **k):
                calls.append(1)
                raise RuntimeError("walk failed")

        old = factory._agg = Broken()
        c = next(iter(factory[0].kv.chains()), [1])
        hits = factory.hits_for(_probe(c, 64))
        assert calls and factory._agg is not old
        assert factory.degraded_rebuilds == 1
        want = np.minimum(_fresh(factory).match_depths(c) * 64, len(c) * 64)
        assert np.array_equal(hits, want)


def test_resolve_timeout_precedence(monkeypatch):
    monkeypatch.setenv("REPRO_SHARD_TIMEOUT_S", "7.25")
    assert tsb.resolve_timeout(3.5) == 3.5
    assert tsb.resolve_timeout() == 7.25
    monkeypatch.setenv("REPRO_SHARD_TIMEOUT_S", "not-a-number")
    assert tsb.resolve_timeout() == tsb.PYTEST_TIMEOUT_S
    monkeypatch.delenv("REPRO_SHARD_TIMEOUT_S")
    assert tsb.resolve_timeout() == tsb.PYTEST_TIMEOUT_S
    monkeypatch.delenv("PYTEST_CURRENT_TEST", raising=False)
    assert tsb.resolve_timeout() == tsb.DEFAULT_TIMEOUT_S
    be = tsb.make_backend("serial", 200_000, 2, timeout_s=2.0)
    assert be.walk_deadline == pytest.approx(2.0 * 100_000 / 65536)


@pytest.mark.process
def test_stall_beyond_deadline_heals():
    """A worker stalled past the walk deadline is treated as stuck: the
    timeout counter bumps, the event names the shard, the supervised
    heal restarts it, and the answer is still exact."""
    n, n_shards = 8, 2
    events = []
    plan = FaultPlan(events=(
        FaultEvent("stall", shard=1, at=0, seconds=2.0),))
    with IndicatorFactory(n, kv_capacity_tokens=1 << 20,
                          n_shards=n_shards, walk_backend="process",
                          shard_timeout_s=0.3, device="cpu") as factory:
        prefix = _prefix(factory)
        factory.attach_faults(FaultInjector(plan))
        factory.attach_backend_events(
            lambda kind, shard, info: events.append((kind, shard, info)))
        _seed_kv(factory, n_chains=40, seed=5)
        be = factory._agg.backend
        assert be.walk_deadline == pytest.approx(0.3)
        c = _rand_chain(np.random.default_rng(5))
        hits = factory.hits_for(_probe(c, 64))
        assert be.timeouts >= 1 and be.heals >= 1
        assert factory.degraded_rebuilds == 0 and not be._closed
        timeouts = [e for e in events if e[0] == "worker_timeout"]
        assert timeouts and timeouts[0][1] == 1
        assert timeouts[0][2]["elapsed_s"] >= 0.3
        assert any(e[0] == "worker_restart" and e[1] == 1 for e in events)
        want = np.minimum(_fresh(factory).match_depths(c) * 64, len(c) * 64)
        assert np.array_equal(hits, want)
    _no_leaks([prefix])


@pytest.mark.process
def test_degraded_rebuild_on_worker_death():
    """A worker that fails mid-query (an error answer: fail-stop) must
    not raise out of the factory: the index is rebuilt from the radix
    trees, the answer is exact, and nothing leaks."""
    rng = np.random.default_rng(9)
    prefixes = set()
    with IndicatorFactory(32, kv_capacity_tokens=1 << 20, n_shards=4,
                          walk_backend="process", shard_timeout_s=60.0,
                          device="cpu") as factory:
        prefixes.add(_prefix(factory))
        chains = []
        for _ in range(60):
            iid = int(rng.integers(0, 32))
            chain = _rand_chain(rng)
            factory.instances[iid].kv.insert(chain)
            chains.append((iid, chain))
        ref = jind.AggregatedPrefixIndex(32)
        for iid, chain in chains:
            ref.add(iid, chain)
        factory._agg.backend.inject_failure(2)
        c = chains[17][1]
        hits = factory.hits_for(_probe(c, 64))        # rebuild + retry
        prefixes.add(_prefix(factory))
        assert factory.degraded_rebuilds == 1
        assert np.array_equal(hits, np.minimum(ref.match_depths(c) * 64,
                                               len(c) * 64))
        # the wave path survives a death between submit and collect
        factory._agg.backend.inject_failure(0)
        reqs = [_probe(ch, 64, i) for i, (_, ch) in enumerate(chains[:5])]
        depth, _, _ = factory.wave_collect(factory.wave_submit(reqs))
        prefixes.add(_prefix(factory))
        assert factory.degraded_rebuilds == 2
        assert np.array_equal(depth, ref.match_depths_many(
            [r.blocks for r in reqs]))
    assert len(prefixes) == 3                    # two rebuilt backends
    _no_leaks(prefixes)
