"""The ``route_score`` launch path on the card (``-m cuda``; skipped
without one).  This file imports no JAX, so it runs on a machine with a
card and no JAX; the kernel itself is held against its plain version at
every regime edge in ``tests/test_torch_route_score.py`` and in phase 2
of ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import route_score as trs  # noqa: E402

BS = 64
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return "cuda"


def wave(k, n, seed):
    """Seeded (rbs, qbs, qpt, tt, depth, lcp, plen), tie0 at (k, n)."""
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


def test_outstanding_handle_survives_the_next_wave(card):
    """The launch path reuses its pinned staging and outputs per stream:
    a handle still outstanding when the next wave is submitted keeps its
    own results, and collected results are not overwritten later."""
    waves = [wave(9, 16, 1), wave(28, 16, 2), wave(33, 1025, 3)]
    handles, wants = [], []
    for args, tie0 in waves:
        cols = [torch.from_numpy(a).to(card) for a in args[:4]]
        handles.append(trs.route_wave_submit("lmetric", ("ptoken", "bs"),
                                             BS, *cols, *args[4:], tie0))
        wants.append(trs.route_wave_ref("lmetric", ("ptoken", "bs"), BS,
                                        *args, tie0))
    got = [trs.route_wave_collect(h) for h in handles]
    args0 = waves[0][0]
    trs.route_wave_collect(trs.route_wave_submit(
        "jsq", (), BS, *[torch.from_numpy(a).to(card) for a in args0[:4]],
        None, None, args0[6], 0))
    for (sel, hit), (ws, wh) in zip(got, wants):
        np.testing.assert_array_equal(sel, ws)
        np.testing.assert_array_equal(hit, wh)


@pytest.mark.parametrize("shape", [(9, 16), (64, 16461)],
                         ids=["warp", "cluster"])
def test_each_wave_is_one_counted_launch(card, shape):
    args, tie0 = wave(*shape, 4)
    cols = [torch.from_numpy(a).to(card) for a in args[:4]]
    before = trs.LAUNCHES
    got = trs.route_wave("ptoken", (), BS, *cols, *args[4:], tie0)
    assert trs.LAUNCHES == before + 1
    want = trs.route_wave_ref("ptoken", (), BS, *args, tie0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_launch_failure_raises(card, monkeypatch):
    """A plan the kernel refuses never falls back: the wrapper raises,
    and counts no launch."""
    args, tie0 = wave(9, 100, 5)
    cols = [torch.from_numpy(a).to(card) for a in args[:4]]
    monkeypatch.setattr(trs, "launch_plan", lambda k, n: (9, 128, 1))
    before = trs.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        trs.route_wave("lmetric", ("ptoken", "bs"), BS, *cols, *args[4:],
                       tie0)
    assert trs.LAUNCHES == before
