"""The port's ``route_score`` (repro_torch) against the JAX reference.

The plain PyTorch wave loop must equal the reference ``route_wave_ref``
(pure jnp) exactly — assignments and hit tokens are integers, so the
tolerance is exact — for all five kinds and every ablation, on seeded
random and forced-tie states at non-power-of-two wave sizes; for the
``lmetric`` and ``ptoken`` kinds it must also equal the Pallas kernel in
interpret mode.  The CUDA kernel is held against the plain version on
the card (``-m cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.kernels import route_score as jrs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import route_score as trs  # noqa: E402

BS = 64
CONFIGS = [("jsq", ()), ("linear", (0.7,)), ("filter", (8,)),
           ("filter", (100,)), ("lmetric", ("ptoken", "bs")),
           ("lmetric", ("ptoken", "tokens")),
           ("lmetric", ("one_minus_hit", "bs")),
           ("lmetric", ("one_minus_hit", "tokens")), ("ptoken", ())]
CONFIG_IDS = [f"{k}-{'-'.join(map(str, p))}" for k, p in CONFIGS]
PALLAS = [c for c in CONFIGS if c[0] in ("lmetric", "ptoken")]


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def wave(seed, k, n, ties=False):
    """(rbs, qbs, qpt, tt, depth, lcp, plen), tie0 — seeded numpy state.
    ``ties`` gives every instance the same load and a strided subset the
    same KV$ depth, so most steps pick among many exact ties."""
    rng = np.random.RandomState(seed)
    i64 = np.int64
    plen = (rng.randint(1, 10, k) * BS - rng.randint(0, BS, k)).astype(i64)
    if ties:
        cols = [np.full(n, 2, i64), np.full(n, 1, i64),
                np.full(n, 700, i64), np.full(n, 5000, i64)]
        depth = np.zeros((k, n), i64)
        depth[:, ::3] = 2
    else:
        cols = [rng.randint(0, 6, n).astype(i64),
                rng.randint(0, 6, n).astype(i64),
                rng.randint(0, 4000, n).astype(i64),
                rng.randint(0, 9000, n).astype(i64)]
        depth = rng.randint(0, 8, (k, n)).astype(i64)
    m = rng.randint(0, 6, (k, k))
    lcp = np.minimum(m, m.T).astype(i64)
    return (*cols, depth, lcp, plen), int(rng.randint(0, 1000))


STATES = {"random-24x32": (3, 24, 32, False),
          "random-7x13": (4, 7, 13, False),
          "ties-24x32": (5, 24, 32, True)}


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind,params", CONFIGS, ids=CONFIG_IDS)
def test_plain_matches_jax_reference(kind, params, state, x64):
    args, tie0 = wave(*STATES[state])
    want = jrs.route_wave_ref(kind, params, BS, *args, tie0)
    got = trs.route_wave_ref(kind, params, BS, *args, tie0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


@pytest.mark.parametrize("kind,params", PALLAS,
                         ids=[f"{k}-{'-'.join(p)}" for k, p in PALLAS])
def test_plain_matches_pallas_interpret(kind, params, x64):
    assert jrs.INTERPRET
    args, tie0 = wave(*STATES["random-24x32"])
    want = jrs.route_wave(kind, params, BS, *args, tie0, use_pallas=True)
    got = trs.route_wave_ref(kind, params, BS, *args, tie0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_forced_ties_rotate_over_all_ties():
    """Equal scores everywhere: request j takes the (tie0 + j)-th tie in
    index order among the instances still tied after feedback."""
    n, k = 5, 4
    z = np.zeros(n, np.int64)
    sel, hit = trs.route_wave_ref(
        "jsq", (), BS, z, z, z, z, np.zeros((k, n), np.int64),
        np.zeros((k, k), np.int64), np.full(k, BS, np.int64), 7)
    # ties: all 5 -> 7 % 5 = 2; then 4 left {0,1,3,4} -> 8 % 4 = 0 -> 0;
    # then {1,3,4} -> 9 % 3 = 0 -> 1; then {3,4} -> 10 % 2 = 0 -> 3
    assert sel.tolist() == [2, 0, 1, 3]
    assert hit.tolist() == [0, 0, 0, 0]


def test_submit_collect_on_cpu_runs_plain_version():
    args, tie0 = wave(*STATES["random-24x32"])
    cols = [torch.from_numpy(a) for a in args[:4]]
    before = trs.LAUNCHES
    for kind, params in CONFIGS:
        h = trs.route_wave_submit(kind, params, BS, *cols, *args[4:], tie0)
        got = trs.route_wave_collect(h)
        want = trs.route_wave_ref(kind, params, BS, *args, tie0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(
            trs.route_wave(kind, params, BS, *cols, *args[4:], tie0)[0],
            want[0])
    assert trs.LAUNCHES == before, "CPU tensors must not count launches"


def test_wrapper_rejects_bad_inputs():
    args, tie0 = wave(*STATES["random-7x13"])
    rbs, qbs, qpt, tt, depth, lcp, plen = args
    with pytest.raises(ValueError):
        trs.route_wave_submit("lmetric", ("ptoken", "cost"), BS, *args, tie0)
    with pytest.raises(ValueError):
        trs.route_wave_submit("best", (), BS, *args, tie0)
    with pytest.raises(ValueError):
        trs.route_wave_submit("jsq", (), BS, rbs.astype(np.int32), qbs,
                              qpt, tt, depth, lcp, plen, tie0)
    with pytest.raises(ValueError):
        trs.route_wave_submit("jsq", (), BS, rbs, qbs, qpt, tt,
                              depth[:, :-1], lcp, plen, tie0)
    with pytest.raises(ValueError):
        trs.route_wave_submit("jsq", (), BS, rbs, qbs, qpt, tt, depth,
                              lcp[:-1], plen, tie0)
    with pytest.raises(ValueError):
        trs.route_wave_submit("jsq", (), BS, rbs, qbs,       # strided
                              torch.from_numpy(np.repeat(qpt, 2))[::2],
                              tt, depth, lcp, plen, tie0)
    # the kernel entry point takes CUDA tensors only: no silent CPU run
    cols = [torch.from_numpy(c) for c in (rbs, qbs, qpt, tt)]
    with pytest.raises(ValueError):
        trs.route_wave_device("jsq", (), BS, cols, None,
                              torch.from_numpy(trs._pack_aux(lcp, plen, 0)))


def test_jsq_takes_no_hit_inputs():
    """jsq scores no hits: without depth and lcp it routes exactly as
    with them; every other kind refuses to run without them."""
    args, tie0 = wave(*STATES["ties-24x32"])
    cols, plen = args[:4], args[6]
    want = trs.route_wave_ref("jsq", (), BS, *args, tie0)
    for fn in (trs.route_wave_ref, trs.route_wave):
        got = fn("jsq", (), BS, *cols, None, None, plen, tie0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for kind, params in CONFIGS[1:]:
        with pytest.raises(ValueError, match="depth and lcp"):
            trs.route_wave(kind, params, BS, *cols, None, args[5], plen,
                           tie0)


def test_chip_smoke_bound_counts_what_each_kind_reads():
    """The byte bound counts the columns each kind scores with, the
    strict lower triangle of lcp, plen and one tie counter."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    k, n = 3, 5
    hits = 8 * (k * n + k * (k - 1) // 2 + k)
    assert smoke.wave_bound("jsq", (), k, n) == (8 * (2 * n + 2 * k + 1),
                                                 4 * k * n)
    assert smoke.wave_bound("ptoken", (), k, n) == (
        8 * (n + 2 * k) + hits, 2 * k * n)
    assert smoke.wave_bound("lmetric", ("ptoken", "bs"), k, n) == (
        8 * (3 * n + 2 * k + 1) + hits, 5 * k * n)
    assert smoke.wave_bound("lmetric", ("one_minus_hit", "tokens"), k,
                            n) == (8 * (n + 2 * k + 1) + hits, 7 * k * n)
    # the main path's timed wave: lmetric at k=64 over 16384 instances
    assert smoke.wave_bound("lmetric", ("ptoken", "bs"), 64, 16384)[0] \
        == 8_799_496


def test_empty_wave():
    z = torch.zeros(6, dtype=torch.int64)
    e2 = np.zeros((0, 0), np.int64)
    sel, hit = trs.route_wave("lmetric", ("ptoken", "bs"), BS, z, z, z, z,
                              np.zeros((0, 6), np.int64), e2,
                              np.zeros(0, np.int64), 0)
    assert sel.shape == (0,) and hit.shape == (0,)


def test_build_command_and_missing_nvcc(monkeypatch, tmp_path):
    src = _build.CSRC / "route_score.cu"
    assert src.exists()
    cmd = _build.nvcc_command(src, tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd and "-shared" in cmd
    p = _build.library_path("route_score")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("route_score-")
    # the kernel source names the TPU kernel it replaces
    assert "route_score.py::_route_kernel" in src.read_text()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("route_score")
    assert not (tmp_path / "build").exists()


#: (k, n) on the card: the simulator's waves (n = 16, the PD pool's 8)
#: and every edge of the launch plan — the warp path's 32 (and a wave of
#: 200, beyond its shared-memory staging), the cluster path at one CTA
#: (33, 1024), two CTAs (1025), a full cluster with a partial last CTA
#: (16461), and 65536 instances, beyond what the cluster keeps in
#: registers
CARD_SHAPES = [(7, 13), (9, 16), (28, 16), (16, 8), (24, 32), (200, 32),
               (9, 33), (12, 1024), (33, 1025), (64, 16461), (20, 65536)]


def card_wave(k, n, ties):
    """``wave`` at (k, n); the tie state also makes the instances next to
    every CTA boundary of the launch plan tie for the deepest hit."""
    args, tie0 = wave(k * 7919 + n + ties, k, n, ties)
    if ties:
        c, _, _ = trs.launch_plan(k, n)
        part = -(-n // c)
        edges = [i for b in range(1, c) for i in (b * part - 1, b * part)]
        args[4][:, edges] = 2
    return args, tie0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=[f"{k}x{n}" for k, n in CARD_SHAPES])
@pytest.mark.parametrize("kind,params", CONFIGS, ids=CONFIG_IDS)
def test_kernel_matches_plain_on_card(kind, params, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for ties in (False, True):
        args, tie0 = card_wave(*shape, ties)
        cols = [torch.from_numpy(a).cuda() for a in args[:4]]
        before = trs.LAUNCHES
        got = trs.route_wave(kind, params, BS, *cols, *args[4:], tie0)
        assert trs.LAUNCHES == before + 1
        want = trs.route_wave_ref(kind, params, BS, *cols, *args[4:],
                                  tie0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
