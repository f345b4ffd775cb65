"""The port's recurrent path against the JAX package's, on the CPU.

* The plain versions of the two recurrent kernels
  (``kernels.rglru_scan.rglru_scan_plain``,
  ``kernels.mlstm_cell.mlstm_chunk_plain``) against the reference's
  oracles (``repro.kernels.ref``) and its Pallas kernels in interpret
  mode, at ``tests/test_kernels.py``'s shapes (atol 1e-5 and 3e-5, as
  there), a chain of chunks, L = 37 and both starting stabilisers
  (m0 = -1e30 for a fresh state, m0 = 0 for a slot the engine zeroed).
* RG-LRU, mLSTM and sLSTM blocks (prefill fresh and from a state, and
  decode) against ``repro.models.recurrent`` in float32 (atol 5e-5 on
  outputs of magnitude up to ~6: sums in another order, f32
  transcendental functions of two libraries).
* ``swa`` attention: the port's cached chunks and decode over the ring
  against the reference's full forward and ring decode, with
  ``cache_len`` below, at and above the window and a chunk that wraps.
  The reference's cached ``swa`` prefill is held to where it agrees with
  its own full forward (``cache_len`` 0 or >= W); below that it attends
  to ring slots never written (ROADMAP Queue C.10), which one test shows.
* The ``exact_only`` router: decisions and hit tokens against the
  reference's ``Router(exact_only=True)`` on prompts that share whole
  stored prompts, as the recurrent engines' do.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import Router as JRouter  # noqa: E402
from repro.core import make_policy as jmake  # noqa: E402
from repro.core.radix import tokens_to_blocks as j_blocks  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.mlstm_cell import mlstm_chunk as pallas_mlstm  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request, Router, make_policy  # noqa: E402
from repro_torch.core.radix import tokens_to_blocks  # noqa: E402
from repro_torch.kernels.mlstm_cell import (mlstm_chunk,  # noqa: E402
                                            mlstm_chunk_plain)
from repro_torch.kernels.rglru_scan import (rglru_scan,  # noqa: E402
                                            rglru_scan_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import _tensor, _tree  # noqa: E402

BLOCK_ATOL = 5e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,D,bs,bd", [(2, 40, 96, 16, 32),
                                         (1, 7, 130, 8, 128),
                                         (3, 64, 64, 64, 64),
                                         (2, 257, 128, 128, 128)])
def test_rglru_scan_plain_matches_ref_and_pallas(B, S, D, bs, bd):
    rng = np.random.RandomState(B * 1000 + S + D)
    a = (rng.rand(B, S, D) * 0.95).astype(np.float32)
    x = rng.randn(B, S, D).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32)
    h, hl = rglru_scan(_t(a), _t(x), _t(h0))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, D)
    hr, hlr = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                 jnp.asarray(h0))
    hp, hlp = pallas_rglru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                           block_s=bs, block_d=bd, interpret=True)
    for want, want_last in ((hr, hlr), (hp, hlp)):
        np.testing.assert_allclose(_np(h), _np(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(hl), _np(want_last), atol=1e-5,
                                   rtol=0)
    # h_last is h at the true last position
    assert torch.equal(hl, h[:, -1])


def test_rglru_scan_plain_is_the_wrapper_on_cpu():
    rng = np.random.RandomState(3)
    a, x = _t(rng.rand(1, 9, 5)), _t(rng.randn(1, 9, 5))
    h0 = _t(rng.randn(1, 5))
    got, want = rglru_scan(a, x, h0), rglru_scan_plain(a, x, h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        rglru_scan(a, x, h0[:, :4])


def _mlstm_inputs(rng, B, L, H, hd, m0=None):
    q, k, v = (rng.randn(B, L, H, hd).astype(np.float32) * 0.3
               for _ in range(3))
    il = rng.randn(B, L, H).astype(np.float32) * 0.5
    fl = (-np.abs(rng.randn(B, L, H)) * 0.3).astype(np.float32)
    C0 = rng.randn(B, H, hd, hd).astype(np.float32) * 0.1
    n0 = np.abs(rng.randn(B, H, hd).astype(np.float32) * 0.1)
    if m0 is None:
        m0 = rng.randn(B, H).astype(np.float32) * 0.1
    else:
        m0 = np.full((B, H), m0, np.float32)
    return q, k, v, il, fl, C0, n0, m0


def _check_mlstm(inputs, atol=3e-5):
    got_h, got_st = mlstm_chunk(*map(_t, inputs))
    jin = [jnp.asarray(a) for a in inputs]
    want = [ref.mlstm_chunk_ref(*jin), pallas_mlstm(*jin, interpret=True)]
    for wh, wst in want:
        np.testing.assert_allclose(_np(got_h), _np(wh), atol=atol, rtol=0)
        for g, w in zip(got_st, wst):
            np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=0)
    return got_h, got_st


@pytest.mark.parametrize("B,L,H,hd,m0", [(2, 16, 3, 32, None),
                                         (1, 32, 4, 64, None),
                                         (2, 8, 1, 128, None),
                                         (1, 37, 2, 32, None),
                                         (1, 37, 2, 32, 0.0),
                                         (2, 24, 2, 16, -1e30)],
                         ids=["sweep0", "sweep1", "sweep2", "L37",
                              "L37-m0=0", "fresh-m0=-1e30"])
def test_mlstm_chunk_plain_matches_ref_and_pallas(B, L, H, hd, m0):
    rng = np.random.RandomState(B * 100 + L + H + hd)
    inputs = _mlstm_inputs(rng, B, L, H, hd, m0)
    if m0 is not None and m0 < -1e29:
        inputs = inputs[:5] + (np.zeros_like(inputs[5]),
                               np.zeros_like(inputs[6]), inputs[7])
    h, (C, n, m) = _check_mlstm(inputs)
    assert h.dtype == torch.float32 and C.dtype == torch.float32
    assert np.isfinite(_np(h)).all() and np.isfinite(_np(C)).all()


def test_mlstm_chunk_plain_keeps_bf16_outputs_f32_state():
    rng = np.random.RandomState(4)
    q, k, v, il, fl, C0, n0, m0 = map(_t, _mlstm_inputs(rng, 1, 12, 2, 16))
    h, (C, n, m) = mlstm_chunk(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               il, fl, C0, n0, m0)
    assert h.dtype == torch.bfloat16
    assert (C.dtype, n.dtype, m.dtype) == (torch.float32,) * 3
    hr, (Cr, _, _) = mlstm_chunk_plain(q.bfloat16().float(),
                                       k.bfloat16().float(),
                                       v.bfloat16().float(), il, fl, C0, n0,
                                       m0)
    np.testing.assert_allclose(_np(h), _np(hr.bfloat16()), atol=0, rtol=0)
    np.testing.assert_allclose(_np(C), _np(Cr), atol=1e-6, rtol=0)


def test_mlstm_chunk_chain_matches_pallas_chain():
    """Chaining the cell over four chunks, from a fresh state, equals the
    Pallas chain (``tests/test_kernels.py``'s chain test)."""
    rng = np.random.RandomState(42)
    B, S, H, hd, L = 1, 32, 2, 16, 8
    q, k, v, il, fl, *_ = _mlstm_inputs(rng, B, S, H, hd)
    C = np.zeros((B, H, hd, hd), np.float32)
    n = np.zeros((B, H, hd), np.float32)
    m = np.full((B, H), -1e30, np.float32)
    tst = tuple(map(_t, (C, n, m)))
    jst = tuple(map(jnp.asarray, (C, n, m)))
    th, jh = [], []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        h, tst = mlstm_chunk(*(_t(a[:, sl]) for a in (q, k, v, il, fl)),
                             *tst)
        hk, jst = pallas_mlstm(*(jnp.asarray(a[:, sl])
                                 for a in (q, k, v, il, fl)), *jst,
                               interpret=True)
        th.append(_np(h))
        jh.append(np.asarray(hk))
    np.testing.assert_allclose(np.concatenate(th, 1), np.concatenate(jh, 1),
                               atol=5e-5, rtol=0)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# recurrent blocks
# ---------------------------------------------------------------------------

def _cfgs(name):
    jc = dataclasses.replace(j_get_config(name), dtype="float32")
    tc = dataclasses.replace(get_config(name), dtype="float32")
    return jc, tc


def _block(kind, name):
    jc, tc = _cfgs(name)
    jp = getattr(jrec, f"init_{kind}")(jax.random.key(3), jc)
    tp = _tree(jax.tree.map(np.asarray, jp), _tensor)
    return jc, tc, jp, tp


def _state_close(got, want, atol=BLOCK_ATOL):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=atol,
                                   rtol=0, err_msg=key)


BLOCKS = [("rglru", "recurrentgemma_9b-smoke", 40),
          ("mlstm", "xlstm_350m-smoke", 300),      # two chunks, padded
          ("slstm", "xlstm_350m-smoke", 24)]


@pytest.mark.parametrize("kind,name,S", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_prefill_and_decode_match_jax(kind, name, S):
    """Prefill from nothing, prefill continuing that state, and two decode
    steps, each against the reference block."""
    jc, tc, jp, tp = _block(kind, name)
    rng = np.random.RandomState(len(kind) + S)
    x = rng.randn(2, S + 9 + 2, jc.d_model).astype(np.float32)
    jpre = getattr(jrec, f"{kind}_prefill")
    tpre = getattr(trec, f"{kind}_prefill")
    jy, jst = jpre(jp, jnp.asarray(x[:, :S]), jc)
    ty, tst = tpre(tp, _t(x[:, :S]), tc)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=BLOCK_ATOL, rtol=0)
    _state_close(tst, jst)
    # continue from the state (the engine's next chunk)
    jy, jst = jpre(jp, jnp.asarray(x[:, S:S + 9]), jc, jst)
    ty, tst = tpre(tp, _t(x[:, S:S + 9]), tc, tst)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=BLOCK_ATOL, rtol=0)
    _state_close(tst, jst)
    for t in range(S + 9, S + 11):
        jy, jst = getattr(jrec, f"{kind}_decode")(
            jp, jnp.asarray(x[:, t:t + 1]), jst, jc)
        ty, tst = getattr(trec, f"{kind}_decode")(tp, _t(x[:, t:t + 1]),
                                                  tst, tc)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=BLOCK_ATOL, rtol=0)
        _state_close(tst, jst)


@pytest.mark.parametrize("kind,name", [("rglru", "recurrentgemma_9b-smoke"),
                                       ("mlstm", "xlstm_350m-smoke")])
def test_block_prefill_from_zeroed_slot_matches_jax(kind, name):
    """A slot the engine zeroed on admission (m = 0, not -1e30) gives the
    reference's result, through ``plain=True`` and the wrapper alike."""
    jc, tc, jp, tp = _block(kind, name)
    x = np.random.RandomState(8).randn(1, 21, jc.d_model).astype(np.float32)
    zero = {k: np.zeros_like(np.asarray(v)) for k, v in
            getattr(jrec, f"{kind}_init_state")(1, jc).items()}
    jy, jst = getattr(jrec, f"{kind}_prefill")(
        jp, jnp.asarray(x), jc, {k: jnp.asarray(v) for k, v in zero.items()})
    for plain in (False, True):
        ty, tst = getattr(trec, f"{kind}_prefill")(
            tp, _t(x), tc, {k: _t(v) for k, v in zero.items()}, plain=plain)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=BLOCK_ATOL, rtol=0)
        _state_close(tst, jst)


def test_init_states_match_reference():
    for kind, name in (("rglru", "recurrentgemma_9b"),
                       ("mlstm", "xlstm_350m"), ("slstm", "xlstm_350m")):
        jc, tc = _cfgs(name)
        want = getattr(jrec, f"{kind}_init_state")(2, jc)
        got = getattr(trec, f"{kind}_init_state")(2, tc, "cpu")
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, (kind, key)
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_causal_conv_state_round_trip_in_bf16():
    """The conv state is stored f32 and consumed in the activation dtype,
    as in the reference."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 5, 8).astype(np.float32)
    w = rng.randn(4, 8).astype(np.float32)
    st = rng.randn(1, 3, 8).astype(np.float32)
    jy, jst = jrec._causal_conv(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(st))
    ty, tst = trec._causal_conv(_t(x).bfloat16(), _t(w).bfloat16(), _t(st))
    assert ty.dtype == torch.bfloat16 and tst.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), atol=0.02, rtol=0.01)
    np.testing.assert_array_equal(_np(tst), _np(jst))


# ---------------------------------------------------------------------------
# swa attention over the ring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swa():
    jc, tc = _cfgs("recurrentgemma_9b-smoke")
    jp = jattn.init_attention(jax.random.key(5), jc, "swa")
    tp = _tree(jax.tree.map(np.asarray, jp), _tensor)
    x = np.random.RandomState(12).randn(1, 200, jc.d_model).astype(
        np.float32)
    return jc, tc, jp, tp, x


def _port_chunks(tc, tp, x, bounds, W):
    """The port's cached prefill of ``x`` in chunks at ``bounds``; returns
    the outputs per chunk and the ring."""
    ring_k = torch.zeros((1, W, tc.n_kv_heads, tc.resolved_head_dim))
    ring_v = torch.zeros_like(ring_k)
    ys = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        plan = tattn.prefill_plan("swa", [lo], hi - lo, W, "cpu")
        ys.append(tattn.attn_prefill_cached(
            tp, _t(x[:, lo:hi]), torch.arange(lo, hi)[None], tc, "swa",
            ring_k, ring_v, plan))
    return ys, ring_k, ring_v


@pytest.mark.parametrize("bounds", [(0, 40), (0, 24, 40), (0, 64, 100),
                                    (0, 50, 64, 120, 150),
                                    (0, 30, 90, 130, 170, 200)],
                         ids=["one", "below-W", "at-W", "wraps",
                              "wrap-twice"])
def test_swa_cached_chunks_match_reference_full_forward(swa, bounds):
    """Every chunk's output equals the reference's full forward over the
    same positions (window 64; a chunk that crosses a multiple of W wraps
    the ring), and the ring afterwards equals the full forward's."""
    jc, tc, jp, tp, x = swa
    S = bounds[-1]
    W = jc.window_size
    jy, (jk, jv) = jattn.attn_prefill(jp, jnp.asarray(x[:, :S]),
                                      jnp.arange(S)[None], jc, "swa")
    ys, ring_k, ring_v = _port_chunks(tc, tp, x, bounds, W)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(jy), atol=2e-5,
                               rtol=0)
    valid = min(S, W)            # ring slots a prompt of S has written
    np.testing.assert_allclose(_np(ring_k)[:, :valid], _np(jk)[:, :valid],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(ring_v)[:, :valid], _np(jv)[:, :valid],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("bounds", [(0, 40), (0, 64, 100),
                                    (0, 64, 128, 150)])
def test_swa_cached_chunks_match_reference_cached_path(swa, bounds):
    """Where the reference's cached path is right (cache_len 0 or >= W),
    the port gives its outputs chunk for chunk."""
    jc, tc, jp, tp, x = swa
    W = jc.window_size
    ys, _, _ = _port_chunks(tc, tp, x, bounds, W)
    cache = (jnp.zeros((1, W, jc.n_kv_heads, jc.resolved_head_dim)),) * 2
    for (lo, hi), y in zip(zip(bounds[:-1], bounds[1:]), ys):
        jy, cache = jattn.attn_prefill_cached(
            jp, jnp.asarray(x[:, lo:hi]), jnp.arange(lo, hi)[None], jc,
            "swa", cache, jnp.asarray([lo]))
        np.testing.assert_allclose(_np(y), _np(jy), atol=2e-5, rtol=0)


def test_reference_swa_cached_prefill_attends_unwritten_slots(swa):
    """ROADMAP Queue C.10: with 0 < cache_len < W the reference's cached
    chunk differs from its own full forward (it sees ring slots never
    written); the port's equals the full forward."""
    jc, tc, jp, tp, x = swa
    W = jc.window_size
    jy_full, _ = jattn.attn_prefill(jp, jnp.asarray(x[:, :48]),
                                    jnp.arange(48)[None], jc, "swa")
    cache = (jnp.zeros((1, W, jc.n_kv_heads, jc.resolved_head_dim)),) * 2
    for lo, hi in ((0, 16), (16, 48)):
        jy, cache = jattn.attn_prefill_cached(
            jp, jnp.asarray(x[:, lo:hi]), jnp.arange(lo, hi)[None], jc,
            "swa", cache, jnp.asarray([lo]))
    assert np.abs(_np(jy) - _np(jy_full)[:, 16:]).max() > 0.1
    ys, _, _ = _port_chunks(tc, tp, x, (0, 16, 48), W)
    np.testing.assert_allclose(_np(ys[1]), _np(jy_full)[:, 16:], atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("S", [30, 63, 64, 150],
                         ids=["below-W", "W-1", "at-W", "above-W"])
def test_swa_decode_matches_reference_ring(swa, S):
    """Decode steps over the ring left by a prefill of S tokens (the
    reference's full forward), at positions below, at and past W."""
    jc, tc, jp, tp, x = swa
    _, (jk, jv) = jattn.attn_prefill(jp, jnp.asarray(x[:, :S]),
                                     jnp.arange(S)[None], jc, "swa")
    jcache = (jk, jv)
    tk, tv = _t(jk), _t(jv)
    W = jc.window_size
    tables = tattn.decode_tables(1, W, "cpu")
    for pos in range(S, S + 3):
        jy, jcache = jattn.attn_decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                                       jcache, jnp.asarray([pos]), jc, "swa")
        ty = tattn.attn_decode(tp, _t(x[:, pos:pos + 1]),
                               torch.tensor([pos]), tc, "swa", tk, tv,
                               tables)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(tk), _np(jcache[0]), atol=2e-5,
                                   rtol=0)


def test_swa_blockwise_full_forward_matches_jax():
    """Past the blockwise threshold (2048) the windowed online-softmax
    path of both packages agrees."""
    jc, tc = _cfgs("recurrentgemma_9b-smoke")
    jp = jattn.init_attention(jax.random.key(9), jc, "swa")
    tp = _tree(jax.tree.map(np.asarray, jp), _tensor)
    S = 2100
    x = np.random.RandomState(2).randn(1, S, jc.d_model).astype(np.float32)
    jy, (jk, _) = jattn.attn_prefill(jp, jnp.asarray(x),
                                     jnp.arange(S)[None], jc, "swa")
    ty, (tk, _) = tattn.attn_prefill(tp, _t(x), torch.arange(S)[None], tc,
                                     "swa")
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the exact_only router
# ---------------------------------------------------------------------------

def test_exact_only_router_matches_reference():
    """Bare 64-token system prompts, then prompts that extend them, repeat
    a stored prompt exactly, or share only part of one: under
    ``exact_only`` a hit is a whole stored prompt, and the port's
    decisions and hit tokens are the reference's."""
    rng = np.random.RandomState(21)
    systems = [rng.randint(0, 500, 64) for _ in range(3)]
    prompts = [s for s in systems]
    for i in range(45):
        g = systems[rng.randint(3)]
        kind = i % 3
        if kind == 0:
            p = np.concatenate([g, rng.randint(0, 500, 16 * rng.randint(
                1, 5))])
        elif kind == 1:
            p = prompts[rng.randint(len(prompts))]
        else:
            p = np.concatenate([g[:32], rng.randint(0, 500, 40)])
        prompts.append(p)
    port = Router(make_policy("lmetric"), 4, block_size=16,
                  exact_only=True, device="cpu")
    refr = JRouter(jmake("lmetric"), 4, block_size=16, exact_only=True)
    got, want = [], []
    for i, p in enumerate(prompts):
        t = 0.05 * i
        treq = Request(rid=i, arrival=t,
                       blocks=tuple(tokens_to_blocks(p.tolist(), 16)),
                       prompt_len=len(p), output_len=4)
        jreq = JRequest(rid=i, arrival=t,
                        blocks=tuple(j_blocks(p.tolist(), 16)),
                        prompt_len=len(p), output_len=4)
        got.append((port.route(treq, t), treq.hit_tokens))
        want.append((refr.route(jreq, t), jreq.hit_tokens))
        for r, router in ((treq, port), (jreq, refr)):
            router.on_prefill_progress(r.sched_to, r.new_tokens)
            router.on_start_running(r.sched_to, r)
            if i % 2:
                router.on_finish(r.sched_to, r)
    assert got == want
    assert sum(h for _, h in got) > 0
    assert all(h % 16 == 0 for _, h in got)
