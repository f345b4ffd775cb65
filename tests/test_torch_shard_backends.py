"""The port's shard backends (``repro_torch.core.shard_backends``): the
serial, thread and process execution of the sharded prefix index are
bit-identical to the port's flat index and to the reference's, at 1, 2,
4 and 8 shards, under valid mutation/walk interleavings; the process
backend leaves none of its own shared-memory segments and no worker
behind, on the mid-query failure path too; and a worker runs without
``torch``.

Leak checks look only at the segments of the backend under test (every
segment a process backend makes is named with its ``shm_prefix``), so
process-backend tests running in other pytest workers at the same time
cannot make them fail.  Process backends get an explicit ``timeout_s``
(``TIMEOUT_S``, or 120 s at 16384 instances) instead of the low pytest
default, which a loaded test run must not meet.
"""
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import indicators as jind  # noqa: E402
from repro_torch.core import IndicatorFactory  # noqa: E402
from repro_torch.core import prefix_index as tpi  # noqa: E402
from repro_torch.core import shard_backends as tsb  # noqa: E402
from repro_torch.core.sharded_index import ShardedPrefixIndex  # noqa: E402

BACKENDS = ("serial", "thread", "process")
SHARD_COUNTS = (1, 2, 4, 8)
#: walk and spawn deadline of the tests that do not test deadlines: a
#: loaded test run must not meet the low pytest default
TIMEOUT_S = 60.0
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _own_segments(idx):
    """Live segments of ``idx``'s process backend (its name prefix)."""
    return tsb.own_segments(idx.backend.shm_prefix)


def _live_workers():
    return [p for p in mp.active_children()
            if p.name.startswith("prefix-shard")]


def _rand_chain(rng, vocab=6, max_len=10):
    length = int(rng.integers(1, max_len))
    return tuple(int(x) for x in rng.integers(0, vocab, size=length))


def _removable(held):
    """Indices into ``held`` of chains whose removal is a real leaf
    eviction: no other chain the same instance holds extends them."""
    return [j for j, (i, c) in enumerate(held)
            if not any(i2 == i and len(c2) > len(c) and c2[:len(c)] == c
                       for i2, c2 in held)]


def _apply_ops(rng, refs, idxs, n, steps):
    """One random valid mutation/walk interleaving through the flat
    indexes ``refs`` (the port's and the reference's) and every sharded
    index, asserting equality on walks."""
    held = []
    everyone = list(refs) + list(idxs.values())
    want_of = refs[0]
    for step in range(steps):
        op = rng.random()
        removable = _removable(held)
        if op < 0.55 or not removable:
            iid = int(rng.integers(0, n))
            chain = _rand_chain(rng)
            for ix in everyone:
                ix.add(iid, chain)
            if (iid, chain) not in held:
                held.append((iid, chain))
        elif op < 0.70:
            iid, chain = held.pop(removable[int(rng.integers(
                0, len(removable)))])
            for ix in everyone:
                ix.remove_leaf(iid, chain)
        elif op < 0.78:
            iid = int(rng.integers(0, n))
            for ix in everyone:
                ix.remove_instance(iid)
            held = [(i, c) for i, c in held if i != iid]
        else:
            queries = [_rand_chain(rng)
                       for _ in range(int(rng.integers(1, 5)))]
            want = want_of.match_depths_many(queries)
            for ix in everyone[1:]:
                assert np.array_equal(want, ix.match_depths_many(queries)), \
                    (ix, step)
    queries = [_rand_chain(rng) for _ in range(4)]
    single = _rand_chain(rng)
    want_many = want_of.match_depths_many(queries)
    want_one = want_of.match_depths(single)
    for name, ix in idxs.items():
        assert np.array_equal(want_many, ix.match_depths_many(queries)), name
        assert np.array_equal(want_one, ix.match_depths(single)), name
        # a lineage held by instances of several shards is stored once
        # per shard tree, so the sharded total can only be >= the flat
        assert ix.n_nodes >= want_of.n_nodes, name


# ---------------------------------------------------------------------------
@pytest.mark.process
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_backend_equivalence_random_interleaving(n_shards):
    """serial == thread == process == the port's flat index == the
    reference's flat index, bit for bit, under a seeded valid
    interleaving; the three backends' digests agree shard by shard."""
    n = 32
    rng = np.random.default_rng(100 + n_shards)
    refs = (jind.AggregatedPrefixIndex(n), tpi.AggregatedPrefixIndex(n))
    idxs = {b: ShardedPrefixIndex(n, n_shards, backend=b,
                                 timeout_s=TIMEOUT_S)
            for b in BACKENDS}
    try:
        _apply_ops(rng, refs, idxs, n, steps=150)
        for s in range(n_shards):
            digests = {b: ix.shard_digest(s) for b, ix in idxs.items()}
            assert len(set(digests.values())) == 1, digests
    finally:
        for ix in idxs.values():
            ix.close()


@pytest.mark.process
def test_backend_equivalence_hypothesis():
    """The same, on interleavings drawn by hypothesis (valid removals
    only: a drawn removal of a chain the instance still extends is
    skipped), over long-lived indexes reset between examples."""
    pytest.importorskip("hypothesis")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    n = 32
    live = {}

    @st.composite
    def interleavings(draw):
        ops, held = [], []
        for _ in range(draw(st.integers(10, 60))):
            kind = draw(st.sampled_from(
                ["add", "add", "add", "remove", "drop", "walk"]))
            removable = _removable(held)
            if kind == "add":
                iid = draw(st.integers(0, n - 1))
                chain = tuple(draw(st.lists(st.integers(0, 5),
                                            min_size=1, max_size=8)))
                if (iid, chain) not in held:
                    held.append((iid, chain))
                ops.append(("add", iid, chain))
            elif kind == "remove" and removable:
                j = removable[draw(st.integers(0, len(removable) - 1))]
                iid, chain = held.pop(j)
                ops.append(("remove_leaf", iid, chain))
            elif kind == "drop":
                iid = draw(st.integers(0, n - 1))
                held = [(i, c) for i, c in held if i != iid]
                ops.append(("remove_instance", iid))
            else:
                qs = draw(st.lists(
                    st.lists(st.integers(0, 5), min_size=1, max_size=8),
                    min_size=1, max_size=4))
                ops.append(("walk", [tuple(q) for q in qs]))
        return ops

    @settings(max_examples=15, deadline=None, database=None)
    @given(ops=interleavings(), n_shards=st.sampled_from(SHARD_COUNTS))
    def run(ops, n_shards):
        if n_shards not in live:
            live[n_shards] = {
                b: ShardedPrefixIndex(n, n_shards, backend=b,
                                      timeout_s=TIMEOUT_S)
                for b in BACKENDS}
        idxs = live[n_shards]
        for ix in idxs.values():           # reset from the last example
            for iid in range(n):
                ix.remove_instance(iid)
        refs = (jind.AggregatedPrefixIndex(n), tpi.AggregatedPrefixIndex(n))
        for op in ops:
            if op[0] == "walk":
                want = refs[0].match_depths_many(op[1])
                for ix in (refs[1], *idxs.values()):
                    assert np.array_equal(want, ix.match_depths_many(op[1]))
            else:
                for ix in (*refs, *idxs.values()):
                    getattr(ix, op[0])(*op[1:])
        final = [(0, 1, 2), (3,)]
        want = refs[0].match_depths_many(final)
        for ix in idxs.values():
            assert np.array_equal(want, ix.match_depths_many(final))

    try:
        run()
    finally:
        for idxs in live.values():
            for ix in idxs.values():
                ix.close()
    assert not _live_workers()


# ---------------------------------------------------------------------------
# lifecycle: none of the backend's own segments, no worker left behind
# ---------------------------------------------------------------------------
@pytest.mark.process
def test_process_smoke_256_instances_2_shards():
    n = 256
    rng = np.random.default_rng(7)
    ref = jind.AggregatedPrefixIndex(n)
    idx = ShardedPrefixIndex(n, 2, backend="process", timeout_s=TIMEOUT_S)
    try:
        for _ in range(80):
            iid = int(rng.integers(0, n))
            chain = _rand_chain(rng)
            ref.add(iid, chain)
            idx.add(iid, chain)
        queries = [_rand_chain(rng) for _ in range(6)]
        assert np.array_equal(ref.match_depths_many(queries),
                              idx.match_depths_many(queries))
        stats = idx.shard_stats()
        assert len(stats) == 2
        assert sum(s["walks"] for s in stats) == 12   # 6 chains x 2 shards
        assert idx.worker_metrics().shape == (2, tsb.N_WORKER_SLOTS)
        assert idx.backend.spawn_s > 0
    finally:
        idx.close()
    assert not _own_segments(idx)
    assert not _live_workers()


@pytest.mark.process
def test_no_leaked_segments_or_workers_after_close():
    idx = ShardedPrefixIndex(64, 4, backend="process", timeout_s=TIMEOUT_S)
    idx.add(3, (1, 2, 3))
    idx.add(40, (1, 2))
    assert idx.match_depths((1, 2, 3))[3] == 3
    # while alive: 4 mask segments, the metrics block and the scratch
    assert len(_own_segments(idx)) == 6
    assert len(_live_workers()) == 4
    idx.close()
    idx.close()                       # idempotent
    assert not _own_segments(idx)
    assert not _live_workers()


@pytest.mark.process
def test_grown_masks_of_a_killed_worker_are_unlinked():
    """A worker killed after its mask segment grew never runs its
    ``finally``; the parent's backstop unlinks the grown segment too."""
    idx = ShardedPrefixIndex(8, 2, capacity=2, backend="process",
                             timeout_s=TIMEOUT_S)
    for b in range(40):                    # grows each shard's masks
        idx.add(b % 8, tuple(range(b, b + 6)))
    assert idx.match_depths(tuple(range(3, 9)))[3] == 6
    masks = [s for s in _own_segments(idx) if "_m0_" in s]
    assert masks and not masks[0].endswith("_0"), masks   # grown
    idx.backend._procs[0].kill()
    idx.backend._procs[0].join(timeout=10)
    idx.close()
    assert not _own_segments(idx)
    assert not _live_workers()


@pytest.mark.process
def test_factory_context_manager_closes_backend():
    with IndicatorFactory(64, kv_capacity_tokens=1 << 20, n_shards=2,
                          walk_backend="process", shard_timeout_s=TIMEOUT_S,
                          device="cpu") as factory:
        factory[5].kv.insert((1, 2, 3))   # on_insert hook -> routed add
        assert factory._agg.match_depths((1, 2, 3))[5] == 3
        assert len(_live_workers()) == 2
        agg = factory._agg
    assert not _own_segments(agg)
    assert not _live_workers()


@pytest.mark.process
def test_midquery_failure_unlinks_segments():
    """A worker that answers with an error mid-query tears the backend
    down: the query raises, and every segment of the backend (masks,
    metrics block, walk scratch) is unlinked with no worker left."""
    idx = ShardedPrefixIndex(32, 2, backend="process", timeout_s=TIMEOUT_S)
    idx.add(1, (1, 2, 3))
    idx.add(20, (1, 2, 3, 4))
    idx.backend.inject_failure(0)
    with pytest.raises(RuntimeError, match=r"prefix-shard \d+ worker"):
        idx.match_depths_many([(1, 2, 3), (1, 2)])
    assert idx.backend._closed
    idx.close()                       # idempotent after teardown
    assert not _own_segments(idx)
    assert not _live_workers()


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown shard backend"):
        ShardedPrefixIndex(16, 2, backend="gpu")
    with pytest.raises(ValueError, match="n_shards"):
        ShardedPrefixIndex(4, 5)


# ---------------------------------------------------------------------------
# the workers import no torch
# ---------------------------------------------------------------------------
def test_shard_modules_import_without_torch():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core.shard_backends
        import repro_torch.core.sharded_index
        import repro_torch.core.faults
        import repro_torch.core.prefix_index
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("torch", "jax", "repro")]
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.process
def test_spawned_worker_runs_without_torch():
    """The parent has torch loaded; a spawned shard worker maps no
    torch library (Linux ``/proc/<pid>/maps``)."""
    if not os.path.exists("/proc/self/maps"):
        pytest.skip("needs /proc/<pid>/maps (Linux)")
    assert "torch" in sys.modules
    idx = ShardedPrefixIndex(16, 2, backend="process", timeout_s=TIMEOUT_S)
    try:
        idx.add(1, (1, 2))
        assert idx.match_depths((1, 2))[1] == 2     # the worker serves
        for p in idx.backend._procs:
            with open(f"/proc/{p.pid}/maps") as fh:
                maps = fh.read()
            assert "numpy" in maps                  # the check can see
            assert "libtorch" not in maps and "libc10" not in maps
    finally:
        idx.close()


# ---------------------------------------------------------------------------
# full-scale sweep (slow tier)
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.process
@pytest.mark.parametrize("n_shards", (4, 8))
def test_backend_equivalence_16384_instances(n_shards):
    """16384 instances, all three backends against the reference's and
    the port's flat indexes, with an explicit timeout: spawn and walks
    under a loaded test run must not meet the low pytest default."""
    n = 16384
    rng = np.random.default_rng(42)
    refs = (jind.AggregatedPrefixIndex(n), tpi.AggregatedPrefixIndex(n))
    idxs = {b: ShardedPrefixIndex(n, n_shards, backend=b, timeout_s=120.0)
            for b in BACKENDS}
    try:
        for _ in range(400):
            iid = int(rng.integers(0, n))
            chain = _rand_chain(rng, vocab=9, max_len=14)
            for ix in (*refs, *idxs.values()):
                ix.add(iid, chain)
        queries = [_rand_chain(rng, vocab=9, max_len=14)
                   for _ in range(16)]
        want = refs[0].match_depths_many(queries)
        assert np.array_equal(want, refs[1].match_depths_many(queries))
        for name, ix in idxs.items():
            assert np.array_equal(want, ix.match_depths_many(queries)), name
    finally:
        for ix in idxs.values():
            ix.close()
    assert not _live_workers()
