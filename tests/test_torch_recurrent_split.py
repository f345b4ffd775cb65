"""The recurrent kernels' arithmetic, on the CPU.

``csrc/rglru_scan.cu`` scans a sequence in segments: each segment from
0, the carries chained in segment order, each segment rescanned from its
true carry-in (in windows of ``P * seg`` positions when the sequence is
longer).  ``rglru_scan_segmented_plain`` spells that order in plain
PyTorch; here it is held against the port's sequential
``rglru_scan_plain`` and the JAX package's Pallas kernel (interpret
mode) at atol 2e-5 (``chip_smoke.REC_TOL``), for 1 to 32 segments, at
ragged S and D and at the serving shape (1, 512, 4096).  With a in [0.99,
1) |h| grows to ~44 and both f32 orders drift from a float64 scan by up
to ~3e-5 (6e-7 of the largest |h|), above the 2e-5 atol; there both are
held to the float64 scan at 2e-6 of its largest |h| (one float32 ulp of
|h| is 6e-8 of it: the drift is rounding accumulated over 512 steps, not
a fault of either order).

``csrc/mlstm_cell.cu``'s bf16 kernel runs every product on the tensor
cores with bf16 operands: q k^T takes them as they are, and each product
with an f32 operand (the decayed scores S, C0, k * w_src) splits it into
bf16 hi + lo.  ``mlstm_chunk_split_plain`` emulates those roundings; here
it is held against ``mlstm_chunk_plain`` and the JAX package's Pallas
kernel (interpret mode) at ``chip_smoke.REC_TOL``: h (bf16) within 2e-2 +
1e-2 |h|, the f32 state within 1e-4 + 1e-4 |x|, at xLSTM-350M's widths
(1, 256, 4, 512), on a chain of 4 chunks, with padded rows and from a
fresh state.  One bf16 rounding of k * w_src, with no lo part, misses the
state's tolerance by far: the case that shows why the kernel splits it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_cell import mlstm_chunk as j_mlstm  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as j_rglru  # noqa: E402
from repro_torch.kernels import mlstm_cell as mc  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402

RG_ATOL = 2e-5
#: near-1 decay: each f32 order against the float64 scan, relative to its
#: largest |h|
RG_NEAR1_RTOL = 2e-6
#: (atol, rtol) of h by dtype and of the f32 state, as chip_smoke.REC_TOL
H_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
STATE_TOL = (1e-4, 1e-4)
#: the serving card's SM count, for the launch plan
N_SM = 132

# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

RG_SHAPES = [(1, 512, 4096), (2, 17, 31), (1, 333, 130), (2, 8, 4000),
             (1, 1, 64)]


@functools.lru_cache(maxsize=None)
def _rg_case(B, S, D, lo=0.0, hi=0.95):
    """Seeded inputs, the Pallas kernel's output and a float64 scan."""
    rng = np.random.RandomState(B * 1000 + S + D)
    a = (lo + rng.rand(B, S, D) * (hi - lo)).astype(np.float32)
    x = rng.randn(B, S, D).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32)
    ph, pl = j_rglru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                     interpret=True)
    h64, c = np.empty((B, S, D)), h0.astype(np.float64)
    for t in range(S):
        c = a[:, t].astype(np.float64) * c + x[:, t]
        h64[:, t] = c
    return (a, x, h0), (np.asarray(ph), np.asarray(pl)), h64


@pytest.mark.parametrize("P", [1, 2, 7, 16, 32])
@pytest.mark.parametrize("B,S,D", RG_SHAPES)
def test_rglru_segmented_plain_matches_plain_and_pallas(B, S, D, P):
    arrays, (ph, pl), _ = _rg_case(B, S, D)
    a, x, h0 = (torch.from_numpy(t) for t in arrays)
    h, hl = rs.rglru_scan_segmented_plain(a, x, h0, P)
    assert h.shape == (B, S, D) and hl.shape == (B, D)
    assert torch.equal(hl, h[:, -1])
    want, want_l = rs.rglru_scan_plain(a, x, h0)
    for w, wl in ((want.numpy(), want_l.numpy()), (ph, pl)):
        np.testing.assert_allclose(h.numpy(), w, rtol=0, atol=RG_ATOL)
        np.testing.assert_allclose(hl.numpy(), wl, rtol=0, atol=RG_ATOL)


@pytest.mark.parametrize("S", [1, 31, 33, 511, 513, 1100])
def test_rglru_segmented_plain_in_the_kernels_windows(S):
    """The kernel's own plan at the serving width: P = 32 segments of at
    most 16 positions, so S = 513 and 1100 run as 2 and 3 windows, each
    carried in from the last one's rescanned h."""
    D = 256
    plan = rs.segment_plan(1, S, 4096, N_SM)
    assert plan["windows"] == -(-S // (plan["P"] * plan["seg"]))
    arrays, (ph, pl), _ = _rg_case(1, S, D)
    a, x, h0 = (torch.from_numpy(t) for t in arrays)
    h, hl = rs.rglru_scan_segmented_plain(a, x, h0, plan["P"], plan["seg"])
    np.testing.assert_allclose(h.numpy(), ph, rtol=0, atol=RG_ATOL)
    np.testing.assert_allclose(hl.numpy(), pl, rtol=0, atol=RG_ATOL)
    assert torch.equal(hl, h[:, -1])


@pytest.mark.parametrize("P", [1, 32])
def test_rglru_near_one_decay_against_float64(P):
    """a in [0.99, 1): |h| reaches ~44.  The segmented and the sequential
    f32 scans each stay within RG_NEAR1_RTOL of the float64 scan's
    largest |h|, and within the same of each other."""
    arrays, _, h64 = _rg_case(1, 512, 4096, 0.99, 1.0)
    a, x, h0 = (torch.from_numpy(t) for t in arrays)
    h, _ = rs.rglru_scan_segmented_plain(a, x, h0, P)
    seq, _ = rs.rglru_scan_plain(a, x, h0)
    scale = np.abs(h64).max()
    assert scale > 20
    for got in (h.numpy(), seq.numpy()):
        assert np.abs(got - h64).max() <= RG_NEAR1_RTOL * scale
    assert np.abs(h.numpy() - seq.numpy()).max() <= RG_NEAR1_RTOL * scale


def test_segment_plan_at_the_serving_shapes():
    """RecurrentGemma-9B's chunk (1, 512, 4096) on 132 SMs: 128 blocks of
    32 channels, 32 segments of 16 positions, one window, 16-byte loads;
    the engine's warm-up chunk of 8 and a prompt's ragged tail keep the
    tile; a narrow or unaligned tensor falls back to scalar channels."""
    assert rs.segment_plan(1, 512, 4096, N_SM) == dict(
        vec=4, groups=8, P=32, seg=16, CT=32, windows=1, grid=(128, 1))
    assert rs.segment_plan(1, 8, 4096, N_SM)["seg"] == 1
    assert rs.segment_plan(1, 333, 4096, N_SM)["seg"] == 11
    assert rs.segment_plan(8, 512, 4096, N_SM)["CT"] == 64
    assert rs.segment_plan(1, 512, 4096, N_SM, aligned=False)["vec"] == 1
    assert rs.segment_plan(2, 17, 31, N_SM)["vec"] == 1
    for B, S, D in [(1, 1, 1), (3, 1000, 4000), (1, 512, 4096), (2, 17, 31),
                    (1, 4096, 2560), (16, 1, 4096)]:
        for aligned in (True, False):
            p = rs.segment_plan(B, S, D, N_SM, aligned)
            assert p["groups"] * p["P"] == rs.THREADS
            assert 1 <= p["seg"] <= rs.SEGMAX
            assert p["P"] * p["seg"] * p["windows"] >= S
            assert p["CT"] * p["grid"][0] >= D and p["grid"][1] == B


# ---------------------------------------------------------------------------
# mlstm_chunk
# ---------------------------------------------------------------------------

B, L, H, HD = 1, 256, 4, 512


def _mlstm_arrays(rng, L, m0):
    """q, k, v (float32 values, rounded to bf16 by each side), the gates
    and a state; m0 = -1e30 is a fresh state (C0 = n0 = 0)."""
    q, k, v = (rng.randn(B, L, H, HD).astype(np.float32) * 0.3
               for _ in range(3))
    il = rng.randn(B, L, H).astype(np.float32) * 0.5
    fl = -np.abs(rng.randn(B, L, H).astype(np.float32) * 0.3)
    C0 = rng.randn(B, H, HD, HD).astype(np.float32) * 0.1
    n0 = np.abs(rng.randn(B, H, HD).astype(np.float32) * 0.1)
    m0 = np.full((B, H), m0, np.float32)
    if m0.min() < -1e29:
        C0[:] = 0
        n0[:] = 0
    return [q, k, v, il, fl, C0, n0, m0]


def _torch(arrays):
    t = [torch.from_numpy(a) for a in arrays]
    return [x.bfloat16() for x in t[:3]] + t[3:]


def _jax(arrays):
    j = [jnp.asarray(a) for a in arrays]
    return [x.astype(jnp.bfloat16) for x in j[:3]] + j[3:]


def _excess(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (np.abs(got - want) - rtol * np.abs(want)).max()


def _assert_close(got, want):
    """got/want: (h, (C, n, m)), torch or JAX."""
    atol, rtol = H_TOL[torch.bfloat16]
    h = lambda x: (x.float().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x.astype(jnp.float32)))
    assert _excess(h(got[0]), h(want[0]), rtol) <= atol
    for g, w in zip(got[1], want[1]):
        assert _excess(np.asarray(g), np.asarray(w),
                       STATE_TOL[1]) <= STATE_TOL[0]


@functools.lru_cache(maxsize=None)
def _mlstm_case(kind):
    rng = np.random.RandomState({"state": 1, "fresh": 2, "padded": 3}[kind])
    arrays = _mlstm_arrays(rng, L, -1e30 if kind == "fresh" else 0.1)
    if kind == "padded":
        # a last chunk padded as the model pads it: zero q/k/v, ilog
        # -1e30, flog 0 from row 200
        for a in arrays[:3]:
            a[:, 200:] = 0
        arrays[3][:, 200:] = -1e30
        arrays[4][:, 200:] = 0
    return arrays, j_mlstm(*_jax(arrays), interpret=True)


@pytest.mark.parametrize("kind", ["state", "fresh", "padded"])
def test_mlstm_split_plain_matches_plain_and_pallas(kind):
    arrays, pallas = _mlstm_case(kind)
    args = _torch(arrays)
    got = mc.mlstm_chunk_split_plain(*args)
    assert got[0].dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in got[1])
    assert torch.isfinite(got[0].float()).all()
    _assert_close(got, mc.mlstm_chunk_plain(*args))
    _assert_close(got, pallas)


def test_mlstm_split_plain_chain_matches_plain_and_pallas():
    """Four chunks of 256 from a fresh state, each side carrying its own
    state: every chunk's h and the final state."""
    rng = np.random.RandomState(7)
    arrays = _mlstm_arrays(rng, 4 * L, -1e30)
    st_t = st_p = [torch.from_numpy(a) for a in arrays[5:]]
    st_j = [jnp.asarray(a) for a in arrays[5:]]
    for c in range(4):
        sl = slice(c * L, (c + 1) * L)
        chunk = [np.ascontiguousarray(a[:, sl]) for a in arrays[:5]]
        got = mc.mlstm_chunk_split_plain(*_torch(chunk), *st_t)
        want = mc.mlstm_chunk_plain(*_torch(chunk), *st_p)
        jw = j_mlstm(*_jax(chunk), *st_j, interpret=True)
        _assert_close(got, want)
        _assert_close(got, jw)
        st_t, st_p, st_j = got[1], want[1], jw[1]


def test_mlstm_one_rounding_of_k_w_breaks_the_state():
    """Rounding k * w_src to bf16 once, with no lo part, moves C by ~2e-3
    past the state's 1e-4 + 1e-4 |C|: the split is needed.  h does not
    depend on it."""
    arrays, _ = _mlstm_case("state")
    args = _torch(arrays)
    want = mc.mlstm_chunk_plain(*args)
    split = mc.mlstm_chunk_split_plain(*args)
    once = mc.mlstm_chunk_split_plain(*args, split_kw=False)
    c_split = _excess(split[1][0], want[1][0], STATE_TOL[1])
    c_once = _excess(once[1][0], want[1][0], STATE_TOL[1])
    assert c_split <= STATE_TOL[0] < 10 * STATE_TOL[0] < c_once
    assert torch.equal(once[0], split[0])
