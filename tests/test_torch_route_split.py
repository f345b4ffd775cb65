"""The cluster kernel's exchange and launch plan for ``route_score``, on the
CPU.

``csrc/route_score.cu`` routes a wave over more than 32 instances with a
cluster of CTAs, each owning a contiguous range of instances, and
combines per-CTA results in CTA order every step: the extremes that
linear and filter need, the least score, the count of ties, and the
rank-r tie's owner (ptoken: the least (score, index) pair).
``route_wave_split_ref`` spells that exchange in plain PyTorch; here it
is held against the plain ``route_wave_ref`` and the JAX reference for
every kind and ablation, for part counts that do and do not divide n, on
states whose forced ties straddle the part boundaries.  Assignments and
hit tokens are integers, so every comparison is exact.  The launch plan
(``launch_plan``, a pure function) is held to the regime edges.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.kernels import route_score as jrs  # noqa: E402
from repro_torch.kernels import route_score as trs  # noqa: E402

BS = 64
CONFIGS = [("jsq", ()), ("linear", (0.7,)), ("filter", (8,)),
           ("filter", (100,)), ("lmetric", ("ptoken", "bs")),
           ("lmetric", ("ptoken", "tokens")),
           ("lmetric", ("one_minus_hit", "bs")),
           ("lmetric", ("one_minus_hit", "tokens")), ("ptoken", ())]
CONFIG_IDS = [f"{k}-{'-'.join(map(str, p))}" for k, p in CONFIGS]


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def straddling(seed, k, n, parts):
    """Seeded wave state whose best instances sit on both sides of every
    boundary of ``parts`` contiguous parts: all instances share one load,
    and the instances next to each boundary (and a strided few) share the
    deepest KV$ hit, so most steps choose among exact ties that cross
    parts.  lcp credits later requests at the instances chosen before."""
    rng = np.random.RandomState(seed)
    i64 = np.int64
    size = -(-n // parts)
    edge = sorted({i for c in range(1, parts) for i in
                   (c * size - 2, c * size - 1, c * size, c * size + 1)
                   if 0 <= i < n})
    cols = [np.full(n, 3, i64), np.full(n, 1, i64), np.full(n, 700, i64),
            np.full(n, 5000, i64)]
    depth = np.zeros((k, n), i64)
    depth[:, ::5] = 1
    depth[:, edge] = 2
    m = rng.randint(0, 4, (k, k))
    lcp = np.minimum(m, m.T).astype(i64)
    plen = (rng.randint(2, 9, k) * BS - rng.randint(0, BS, k)).astype(i64)
    return (*cols, depth, lcp, plen), int(rng.randint(0, 1000))


def random_state(seed, k, n):
    """Seeded random indicator columns, depths and lcp."""
    rng = np.random.RandomState(seed)
    i64 = np.int64
    cols = [rng.randint(0, 6, n).astype(i64), rng.randint(0, 6, n).astype(i64),
            rng.randint(0, 4000, n).astype(i64),
            rng.randint(0, 9000, n).astype(i64)]
    depth = rng.randint(0, 8, (k, n)).astype(i64)
    m = rng.randint(0, 6, (k, k))
    lcp = np.minimum(m, m.T).astype(i64)
    plen = (rng.randint(1, 10, k) * BS - rng.randint(0, BS, k)).astype(i64)
    return (*cols, depth, lcp, plen), int(rng.randint(0, 1000))


#: (state, k, n, parts): part counts that divide n and that do not, a
#: part per instance, more parts than the plan would take, and a last
#: part that is empty (n = 9 over 4 parts of 3)
CASES = {"ties-13x37-p3": ("ties", 13, 37, 3),
         "ties-20x64-p8": ("ties", 20, 64, 8),
         "ties-9x10-p10": ("ties", 9, 10, 10),
         "ties-9x9-p4": ("ties", 9, 9, 4),
         "random-11x41-p5": ("random", 11, 41, 5),
         "random-16x48-p2": ("random", 16, 48, 2)}


def _state(name):
    what, k, n, parts = CASES[name]
    seed = k * 1000 + n * 10 + parts
    if what == "ties":
        return straddling(seed, k, n, parts), parts
    return random_state(seed, k, n), parts


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind,params", CONFIGS, ids=CONFIG_IDS)
def test_split_matches_plain(kind, params, case):
    (args, tie0), parts = _state(case)
    want = trs.route_wave_ref(kind, params, BS, *args, tie0)
    got = trs.route_wave_split_ref(kind, params, BS, *args, tie0, parts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


@pytest.mark.parametrize("kind,params", CONFIGS, ids=CONFIG_IDS)
def test_split_matches_jax_reference(kind, params, x64):
    (args, tie0), parts = _state("ties-13x37-p3")
    want = jrs.route_wave_ref(kind, params, BS, *args, tie0)
    got = trs.route_wave_split_ref(kind, params, BS, *args, tie0, parts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_straddling_ties_cross_parts():
    """The tie states do what they are for: some step of lmetric picks an
    instance on each side of a part boundary, and some step's tie set
    spans more than one part."""
    (args, tie0), parts = _state("ties-20x64-p8")
    sel, _ = trs.route_wave_split_ref("lmetric", ("ptoken", "bs"), BS,
                                      *args, tie0, parts)
    size = -(-64 // parts)
    assert len({int(s) // size for s in sel}) > 1
    assert any(int(s) % size == 0 for s in sel)
    assert any(int(s) % size == size - 1 for s in sel)


def test_split_rejects_no_parts():
    (args, tie0), _ = _state("random-11x41-p5")
    with pytest.raises(ValueError):
        trs.route_wave_split_ref("jsq", (), BS, *args, tie0, 0)


#: n -> (cluster, threads, instances per thread)
PLANS = {1: (1, 32, 1), 8: (1, 32, 1), 16: (1, 32, 1), 32: (1, 32, 1),
         33: (1, 64, 1), 1024: (1, 512, 2), 1025: (2, 512, 2),
         8192: (8, 512, 2), 16384: (8, 512, 4), 16461: (8, 256, 9),
         65536: (8, 256, 32)}


@pytest.mark.parametrize("n", list(PLANS))
def test_launch_plan_edges(n):
    c, threads, ipt = trs.launch_plan(64, n)
    assert (c, threads, ipt) == PLANS[n]
    assert 1 <= c <= trs.CLUSTER_MAX
    assert threads % 32 == 0 and 32 <= threads <= trs.MAX_THREADS
    part = -(-n // c)
    assert threads * ipt >= part > (threads * (ipt - 1) if ipt > 1 else 0)
    # the warp path exactly up to 32 instances, a cluster above
    assert (n <= trs.WARP_MAX) == (threads == 32 and c == 1 and n <= 32)
    # the plan does not depend on the wave's length
    assert trs.launch_plan(1, n) == trs.launch_plan(28, n) == (c, threads,
                                                               ipt)


def test_launch_plan_covers_every_instance():
    """Every n up to a few CTAs' worth: the parts cover [0, n) exactly,
    every part but possibly the last is full, and no CTA is empty."""
    for n in list(range(1, 2200)) + [4095, 4096, 4097, 8191, 8193, 32769]:
        c, threads, ipt = trs.launch_plan(7, n)
        part = -(-n // c)
        assert c * part >= n and (c - 1) * part < n
        assert threads * ipt >= part
        assert ipt <= 4 or threads == 256      # the register budget


def test_launch_plan_rejects_negative_shapes():
    with pytest.raises(ValueError):
        trs.launch_plan(-1, 16)
    with pytest.raises(ValueError):
        trs.launch_plan(4, -16)
