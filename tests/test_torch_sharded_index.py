"""The port's sharded prefix index (``repro_torch.core.sharded_index``)
and the factory's per-shard device mirror, against the JAX package's.

* ``shard_bounds`` / ``shard_owner`` and the anti-entropy digests (the
  splitmix64 chain hashes, the incremental and rescanned triples, the
  fault hook's flipped bit) equal the reference's for the same chains.
* Under *valid* mutation streams — every mutation driven through the
  port's ``RadixKVIndex`` trees, so removals hit leaves only — the
  port's sharded index at 1, 2, 4 and 8 shards equals the port's flat
  index, the reference's flat index and the reference's sharded index,
  bit for bit (seeded, and drawn by hypothesis).
* A misuse stream (a removal of a chain the same instance still
  extends) is where the reference's flat and sharded indexes part; the
  port's give exactly the reference's answers, flat for flat and
  sharded for sharded.
* The device mirror re-uploads only its dirty ranges; ``exact_only``
  ignores index sharding; ``route_batch`` on a sharded router (CPU, the
  plain version of ``route_score``) equals the flat router's, sequential
  ``route()`` and the reference's sequential ``route()``.
"""
import collections
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Router as JRouter  # noqa: E402
from repro.core import make_policy as jmake  # noqa: E402
from repro.core import indicators as jind  # noqa: E402
from repro.core.sharded_index import ShardedPrefixIndex as JSharded  # noqa: E402
from repro.workloads.traces import make_hotspot_trace as jtrace  # noqa: E402
from repro_torch.core import Router, make_policy  # noqa: E402
from repro_torch.core import indicators as tind  # noqa: E402
from repro_torch.core import prefix_index as tpi  # noqa: E402
from repro_torch.core.radix import RadixKVIndex  # noqa: E402
from repro_torch.core.sharded_index import ShardedPrefixIndex  # noqa: E402
from repro_torch.workloads.traces import make_hotspot_trace  # noqa: E402

B = 4  # block size of the driver trees
SHARD_COUNTS = (1, 2, 4, 8)


class _Quad:
    """Port flat + port sharded + reference flat + reference sharded,
    driven by one set of port radix trees (so only callback-reachable,
    i.e. valid, mutation orders reach the indexes)."""

    def __init__(self, n, n_shards, capacity_tokens=10 ** 9, backend=None):
        self.n = n
        self.flat = tpi.AggregatedPrefixIndex(n, capacity=2)
        self.sharded = ShardedPrefixIndex(n, n_shards, capacity=2,
                                          backend=backend)
        self.ref = jind.AggregatedPrefixIndex(n, capacity=2)
        self.ref_sharded = JSharded(n, n_shards, capacity=2)
        self.all = (self.flat, self.sharded, self.ref, self.ref_sharded)
        self.kvs = []
        for i in range(n):
            kv = RadixKVIndex(block_size=B, capacity_tokens=capacity_tokens)
            kv.on_insert = (lambda blocks, _i=i: [
                idx.add(_i, blocks) for idx in self.all])
            kv.on_evict = (lambda path, _i=i: [
                idx.remove_leaf(_i, path) for idx in self.all])
            kv.on_clear = (lambda _i=i: [
                idx.remove_instance(_i) for idx in self.all])
            self.kvs.append(kv)

    def check(self, probes):
        want = self.ref.match_depths_many(probes)
        for idx in (self.flat, self.sharded, self.ref_sharded):
            got = idx.match_depths_many(probes)
            assert np.array_equal(got, want), (type(idx), got, want)
        for c in probes:
            a = self.sharded.match_depths(c)
            assert np.array_equal(a, self.ref.match_depths(c)), c
            assert np.array_equal(a, self.flat.match_depths(c)), c

    def close(self):
        self.sharded.close()


def _chain_pool(rng, n_chains=48, alphabet=6, max_len=12):
    return [tuple(int(x) for x in rng.randint(0, alphabet,
                                              rng.randint(1, max_len)))
            for _ in range(n_chains)]


# ---------------------------------------------------------------------------
def test_shard_bounds_and_owner_equal_reference():
    for n, S in [(1, 1), (7, 3), (16, 4), (63, 8), (64, 8), (65, 8),
                 (130, 7), (4096, 8), (16384, 8)]:
        bounds = tpi.shard_bounds(n, S)
        assert bounds == jind.shard_bounds(n, S)
        assert np.array_equal(tpi.shard_owner(n, S), jind.shard_owner(n, S))
        sizes = [hi - lo for lo, hi in bounds]
        assert max(sizes) - min(sizes) <= 1
        idx = ShardedPrefixIndex(n, S)
        for s, (lo, hi) in enumerate(bounds):
            for i in (lo, hi - 1):
                assert idx._local(i) == (s, i - lo)
    assert tind.shard_bounds is tpi.shard_bounds      # re-exported


def test_digests_equal_reference():
    """Chain hashes, ``digest_from_chains``, the incremental and
    rescanned digests (enabled before and after the mutations) and the
    fault hook's flipped bit equal the reference's."""
    rng = np.random.RandomState(5)
    for x in (0, 1, 2 ** 63, 2 ** 64 - 1, 123456789):
        assert tpi._mix64(x) == jind._mix64(x)
        assert tpi._chain_step(x, 77) == jind._chain_step(x, 77)
    assert [tpi._ihash(i) for i in range(50)] == \
        [jind._ihash(i) for i in range(50)]
    n = 70
    pool = _chain_pool(rng)
    pairs = [(int(rng.randint(n)), pool[rng.randint(len(pool))])
             for _ in range(120)]
    assert tpi.digest_from_chains(pairs) == jind.digest_from_chains(pairs)
    for early in (True, False):
        port = tpi.AggregatedPrefixIndex(n, capacity=2)
        ref = jind.AggregatedPrefixIndex(n, capacity=2)
        if early:                           # upkeep from the first add
            assert port.digest == ref.digest == (0, 0, 0)
        for iid, c in pairs:
            port.add(iid, c)
            ref.add(iid, c)
        for iid, c in pairs[::7]:           # leaf removals and clears
            port.remove_leaf(iid, c)
            ref.remove_leaf(iid, c)
        port.remove_instance(3)
        ref.remove_instance(3)
        assert port.digest == ref.digest
        assert port.rescan_digest() == ref.rescan_digest() == port.digest
        assert port.n_nodes == ref.n_nodes
        assert port.corrupt_bit(99) == ref.corrupt_bit(99) is not None
        assert port.rescan_digest() == ref.rescan_digest() != port.digest
        port.reset()
        ref.reset()
        assert port.digest == ref.digest == (0, 0, 0)
        assert port.corrupt_bit(1) is None


@pytest.mark.parametrize("n,n_shards",
                         [(5, 2), (16, 4), (63, 8), (64, 8), (65, 4),
                          (130, 8), (256, 8)])
def test_random_valid_streams_match_flat_and_reference(n, n_shards):
    """Inserts, LRU evictions and clears through the port's radix trees
    (tight capacity: evictions fire) keep the port's sharded index equal
    to its flat index and to both reference indexes."""
    rng = np.random.RandomState(n * 31 + n_shards)
    quad = _Quad(n, n_shards, capacity_tokens=15 * B)
    pool = _chain_pool(rng)
    for step in range(250):
        op, i = rng.rand(), rng.randint(n)
        if op < 0.65:
            quad.kvs[i].insert(pool[rng.randint(len(pool))])
        elif op < 0.85:
            quad.kvs[i].evict_tokens(int(rng.randint(1, 8)) * B)
        elif op < 0.95:
            quad.kvs[i].clear()
        if step % 29 == 0:
            probes = [pool[rng.randint(len(pool))]
                      for _ in range(rng.randint(1, 9))]
            probes += [(), (99_999, 1)]     # empty row, miss at the root
            quad.check(probes)
    quad.check(pool)
    assert quad.sharded.n_nodes == quad.ref_sharded.n_nodes == sum(
        sh.n_nodes for sh in quad.sharded.shards)
    for s in range(n_shards):
        assert quad.sharded.shard_digest(s) == \
            quad.ref_sharded.shard_digest(s)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_thread_fanout_equals_serial_and_reference(n_shards):
    """``parallel=True`` (the thread backend) gives the serial matrix,
    run after run: each shard writes only its own column slice."""
    rng = np.random.RandomState(3)
    serial = _Quad(64, n_shards)
    par = _Quad(64, n_shards, backend="thread")
    pool = _chain_pool(rng)
    try:
        for _ in range(300):
            i, c = rng.randint(64), pool[rng.randint(len(pool))]
            serial.kvs[i].insert(c)
            par.kvs[i].insert(c)
        want = serial.ref.match_depths_many(pool)
        for _ in range(3):
            assert np.array_equal(par.sharded.match_depths_many(pool), want)
        par.check(pool[:8])
    finally:
        par.close()


def test_property_valid_streams_match_flat_and_reference():
    pytest.importorskip(
        "hypothesis",
        reason="optional dev dep (requirements-dev.txt); property tests only")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    chain = st.lists(st.integers(0, 4), min_size=1, max_size=8).map(tuple)
    ops = st.lists(
        st.one_of(
            st.tuples(st.just("insert"), st.integers(0, 5), chain),
            st.tuples(st.just("evict"), st.integers(0, 5),
                      st.integers(1, 6)),
            st.tuples(st.just("clear"), st.integers(0, 5), st.just(0)),
        ),
        min_size=1, max_size=60)

    @settings(max_examples=40, deadline=None, database=None)
    @given(ops, st.lists(chain, min_size=1, max_size=6),
           st.sampled_from([1, 2, 3, 6]))
    def run(op_seq, probes, n_shards):
        quad = _Quad(6, n_shards, capacity_tokens=12 * B)
        for kind, iid, arg in op_seq:
            if kind == "insert":
                quad.kvs[iid].insert(arg)
            elif kind == "evict":
                quad.kvs[iid].evict_tokens(arg * B)
            else:
                quad.kvs[iid].clear()
        quad.check(list(probes) + [()])

    run()


def test_misuse_stream_reference_flat_and_sharded_disagree():
    """Removing a chain the same instance still extends breaks the
    subset invariant (``RadixKVIndex`` never does it).  On the minimal
    such stream the reference's flat and sharded indexes give different
    depths — the failure the reference's generator-driven backend test
    draws — and the port reproduces each of them exactly."""
    ops = [("add", 0, (0, 1)), ("add", 0, (0, 1, 2)), ("add", 31, (0, 1)),
           ("remove_leaf", 0, (0, 1))]
    idxs = {"ref flat": jind.AggregatedPrefixIndex(32),
            "ref sharded": JSharded(32, 2, backend="serial"),
            "port flat": tpi.AggregatedPrefixIndex(32),
            "port sharded": ShardedPrefixIndex(32, 2, backend="serial")}
    for op, iid, chain in ops:
        for ix in idxs.values():
            getattr(ix, op)(iid, chain)
    got = {name: ix.match_depths((0, 1, 2))[[0, 31]].tolist()
           for name, ix in idxs.items()}
    assert got == {"ref flat": [3, 0], "ref sharded": [1, 2],
                   "port flat": [3, 0], "port sharded": [1, 2]}
    many = {name: ix.match_depths_many([(0, 1, 2)])[0][[0, 31]].tolist()
            for name, ix in idxs.items()}
    assert many == got


# ---------------------------------------------------------------------------
# the per-shard device mirror
# ---------------------------------------------------------------------------
def test_device_mirror_reuploads_only_dirty_ranges():
    """A hook dirties only its instance's mirror range; a numpy write to
    a clean range without ``mark_dirty`` stays invisible (it was not
    re-uploaded); a bare ``mark_dirty()`` refreshes every range.  On the
    CPU each refresh is a new tensor (a mirror is a copy, not a view)."""
    f = tind.IndicatorFactory(16, n_shards=4, device="cpu")
    v0 = f.device_view()
    assert f.mirror_uploads.tolist() == [1, 1, 1, 1]
    assert f.device_view() is v0                      # clean: cached
    f[0].r_bs = 3                       # mirror range 0 only
    f[13].on_decode_token()             # mirror range 3 only
    f.r_bs[5] = 9                       # range 1, no mark_dirty: stale
    v1 = f.device_view()
    assert f.mirror_uploads.tolist() == [2, 1, 1, 2]
    assert v1[0].tolist() == [3] + [0] * 15
    assert v1[3].tolist() == [0] * 13 + [1, 0, 0]
    assert v0[0].tolist() == [0] * 16, "a mirror is a copy, not a view"
    f.mark_dirty()
    v2 = f.device_view()
    assert f.mirror_uploads.tolist() == [3, 2, 2, 3]
    for got, want in zip(v2, (f.r_bs, f.q_bs, f.queued_prefill_tokens,
                              f.total_tokens)):
        assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    f.q_bs[4:12] = 2                    # straddles ranges 1 and 2
    f.mark_dirty(4)
    f.mark_dirty(11)
    assert f._dirty_runs() == [[4, 12]]               # coalesced
    assert f.device_view()[1].tolist() == f.q_bs.tolist()


def test_device_mirror_matches_reference_partition():
    jf = jind.IndicatorFactory(50, n_shards=8)
    tf = tind.IndicatorFactory(50, n_shards=8, device="cpu")
    assert tf._mirror_bounds == jf._mirror_bounds
    assert np.array_equal(tf._mirror_owner, jf._mirror_owner)


def test_exact_only_factory_ignores_index_sharding():
    f = tind.IndicatorFactory(8, exact_only=True, n_shards=4, device="cpu")
    assert f._agg is None and f._index_shards() == 0
    f[2].kv.insert((1, 2, 3))
    hits = f.hits_for(type("R", (), {"blocks": (1, 2, 3),
                                     "prompt_len": 3 * 64})())
    assert hits[2] > 0 and hits.shape == (8,)
    assert len(f.shard_walk_stats()) == 1          # pseudo-shard
    assert f.verify_shard(0) and f.anti_entropy_step(4) == 0
    assert len(f.device_view()[0]) == 8            # mirror still applies


def test_shard_walk_telemetry():
    router = Router(make_policy("lmetric"), 16, n_shards=4, device="cpu")
    reqs = make_hotspot_trace(qps=10.0, duration=30.0, seed=1)[:100]
    for r in copy.deepcopy(reqs):
        router.route(r, r.arrival)
    t = router.walk_telemetry()
    assert [(s["lo"], s["hi"]) for s in t["shards"]] == \
        tpi.shard_bounds(16, 4)
    assert {s["walks"] for s in t["shards"]} == {router.factory.walks} \
        and router.factory.walks > 0
    assert t["max_shard_us"] == max(s["mean_walk_us"]
                                    for s in t["shards"]) > 0
    flat = Router(make_policy("lmetric"), 16, device="cpu")
    for r in copy.deepcopy(reqs[:20]):
        flat.route(r, r.arrival)
    ft = flat.walk_telemetry()
    assert [(s["lo"], s["hi"]) for s in ft["shards"]] == [(0, 16)]
    assert ft["max_shard_us"] == ft["mean_walk_us"]


# ---------------------------------------------------------------------------
# route_batch bit-identity with a sharded factory
# ---------------------------------------------------------------------------
def _drive(router, reqs, batch, use_batch):
    """The reference's wave/drain schedule
    (``tests/test_sharded_index.py::_drive``); returns (decision, hit
    tokens) per request."""
    out = []
    outstanding = collections.deque()
    reqs = copy.deepcopy(reqs)
    for i in range(0, len(reqs), batch):
        wave = reqs[i:i + batch]
        now = wave[0].arrival
        if use_batch:
            iids = router.route_batch(wave, now)
        else:
            iids = [router.route(r, now) for r in wave]
        out.extend((iid, r.hit_tokens) for iid, r in zip(iids, wave))
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
    return out


TRACE_KW = dict(qps=14.0, duration=160.0, seed=5, burst_start=40.0,
                burst_len=70.0)


@pytest.fixture(scope="module")
def traces():
    return jtrace(**TRACE_KW)[:600], make_hotspot_trace(**TRACE_KW)[:600]


def test_route_batch_sharded_equals_flat_and_sequential(traces):
    """Over the first 600 hotspot requests in waves of 8 at 16
    instances: route_batch at 1, 2, 4 and 8 shards (serial) and at 8
    shards on the thread backend == the port's flat route_batch == its
    sequential ``route()`` == the reference's sequential ``route()``."""
    jt, pt = traces

    def port(**kw):
        return Router(make_policy("lmetric"), 16, kv_capacity_tokens=150_000,
                      device="cpu", **kw)

    ref = _drive(JRouter(jmake("lmetric"), 16, kv_capacity_tokens=150_000),
                 jt, 8, False)
    assert _drive(port(), pt, 8, False) == ref
    assert _drive(port(), pt, 8, True) == ref
    for S in SHARD_COUNTS:
        with port(n_shards=S) as r:
            assert _drive(r, pt, 8, True) == ref, f"shards={S}"
            assert r.pipeline.waves == 600 // 8
    with port(n_shards=8, parallel_walks=True) as r:
        assert _drive(r, pt, 8, True) == ref


def test_paths_of_later_slices_raise():
    """The factory's fleet and instance-failure entry points, once left
    to later slices, now run: a fleet's columns and capability mask
    (ROADMAP Queue A item 6), and ``on_instance_failed`` (item 7), which
    removes the instance's column from the sharded index through the
    shard backend and dirties only its mirror range."""
    from repro_torch.core.fleet import make_fleet
    fleet = make_fleet([("qwen3_30b_moe", "fast", 2),
                        ("qwen2_7b", "slow", 2)])
    with tind.IndicatorFactory(4, fleet=fleet, n_shards=2,
                               device="cpu") as f:
        assert f.model_id.tolist() == [0, 0, 1, 1]
        assert f.prefill_norm is not None
        assert f.feasible_mask("qwen2_7b").tolist() == [False, False,
                                                         True, True]
        for iid in range(4):
            f[iid].kv.insert((1, 2, 3))
        f.device_view()
        f.on_instance_failed(1)
        assert f._dirty.tolist() == [True, False]
        assert f._agg.match_depths((1, 2, 3)).tolist() == [3, 0, 3, 3]
        assert f.evictions == 1
