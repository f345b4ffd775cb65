"""The port's recurrent kernels and the head-dim-256 attention variants
against their plain PyTorch versions on the card (``-m cuda``; they skip
without one: a CUDA kernel has no CPU mode).  This file imports no JAX;
the plain versions are held against the JAX package in
``tests/test_torch_recurrent.py``.

Tolerances, kernel against plain version on the same inputs:

* ``rglru_scan``: atol 2e-5 on |h| up to ~20.  The kernel fuses each
  step's multiply-add (one rounding instead of two); the carry forgets
  the difference at the rate of a < 1.
* ``mlstm_chunk``, float32: atol 1e-4 and rtol 1e-4.  Both take every
  product in f32; the kernel sums over L and hd in another order
  (tiles of 16), and h divides by a normaliser that can be small.
* ``mlstm_chunk``, bfloat16 q/k/v: h is rounded to bf16 by both (atol
  2e-2, rtol 1e-2: one bf16 ulp of |h| up to ~4); the f32 state as
  float32.  The kernel's tensor-core products split each f32 operand
  into bf16 hi + lo (``tests/test_torch_recurrent_split.py`` shows on
  the CPU that this holds these tolerances).
* attention: as ``tests/test_torch_attention_cuda.py`` (f32 atol 1e-4;
  bf16 |diff| <= 5e-3 + 1e-2 |plain|, with q drawn at scale 2 so that
  each softmax peaks over a few keys).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mlstm_cell as mc  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as fp  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402

#: (atol, rtol) and the scale q is drawn at, by dtype
ATTN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (5e-3, 1e-2)}
Q_SCALE = {torch.float32: 0.5, torch.bfloat16: 2.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                            * scale).to(dev, dtype)


def _assert_attn_close(got, want, dtype):
    atol, rtol = ATTN_TOL[dtype]
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - rtol * want.abs()).max().item()
    assert excess <= atol, excess


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", [(2, 40, 96), (1, 7, 130), (3, 64, 64),
                                   (2, 257, 128), (1, 512, 4096),
                                   (1, 333, 4000), (2, 17, 31),
                                   # the segment and window edges of the
                                   # serving width's plan (P = 32, 16
                                   # positions a segment), and B = 2
                                   (1, 1, 4096), (1, 31, 4096),
                                   (1, 33, 4096), (1, 511, 4096),
                                   (1, 513, 4096), (2, 512, 4096)])
def test_rglru_scan_kernel_matches_plain(card, B, S, D):
    rng = np.random.RandomState(B * 7 + S + D)
    a = torch.from_numpy((rng.rand(B, S, D) * 0.95).astype(
        np.float32)).to(card)
    x = _randn(rng, (B, S, D), card)
    h0 = _randn(rng, (B, D), card)
    n0 = rs.LAUNCHES
    h, hl = rs.rglru_scan(a, x, h0)
    hp, hlp = rs.rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert rs.LAUNCHES == n0 + 1
    assert (h - hp).abs().max().item() <= 2e-5
    assert (hl - hlp).abs().max().item() <= 2e-5
    assert torch.equal(hl, h[:, -1])


@pytest.mark.cuda
def test_rglru_scan_kernel_unaligned_tensors_match_plain(card):
    """Contiguous tensors 4 bytes off a 16-byte boundary take the scalar
    channel path (segment_plan's vec = 1)."""
    rng = np.random.RandomState(9)
    B, S, D = 1, 512, 4096

    def off(x):
        buf = torch.empty(x.numel() + 1, device=card)
        buf[1:].copy_(x.reshape(-1))
        return buf[1:].view(x.shape)

    a = off(torch.from_numpy((rng.rand(B, S, D) * 0.95).astype(
        np.float32)).to(card))
    x, h0 = off(_randn(rng, (B, S, D), card)), off(_randn(rng, (B, D), card))
    assert rs.launch_plan(a)["vec"] == 1
    h, hl = rs.rglru_scan(a, x, h0)
    hp, hlp = rs.rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert (h - hp).abs().max().item() <= 2e-5
    assert torch.equal(hl, h[:, -1])


@pytest.mark.cuda
def test_rglru_scan_kernel_rejects_what_it_does_not_take(card):
    a = torch.zeros((1, 4, 8), device=card)
    with pytest.raises(ValueError, match="float32"):
        rs.rglru_scan(a.bfloat16(), a.bfloat16(), a[:, 0].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a,
                      a[:, 0])


# ---------------------------------------------------------------------------
# mlstm_chunk
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, dev, B, L, H, hd, m0=None, dtype=torch.float32):
    q, k, v = (_randn(rng, (B, L, H, hd), dev, 0.3, dtype)
               for _ in range(3))
    il = _randn(rng, (B, L, H), dev, 0.5)
    fl = -_randn(rng, (B, L, H), dev, 0.3).abs()
    C0 = _randn(rng, (B, H, hd, hd), dev, 0.1)
    n0 = _randn(rng, (B, H, hd), dev, 0.1).abs()
    m0 = (_randn(rng, (B, H), dev, 0.1) if m0 is None
          else torch.full((B, H), m0, device=dev))
    return q, k, v, il, fl, C0, n0, m0


def _close_mlstm(got, want, dtype):
    (h, st), (hp, stp) = got, want
    if dtype == torch.float32:
        torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(h.float(), hp.float(), atol=2e-2,
                                   rtol=1e-2)
    for g, w in zip(st, stp):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,hd,m0", [(2, 16, 3, 32, None),
                                         (1, 32, 4, 64, None),
                                         (2, 8, 1, 128, None),
                                         (1, 37, 4, 512, 0.0),
                                         (1, 37, 4, 512, -1e30),
                                         (1, 256, 4, 512, None),
                                         (1, 256, 4, 128, 0.0),
                                         (1, 1, 2, 64, 0.0),
                                         # the engines' warm-up chunk,
                                         # B = 2 at the serving widths,
                                         # ragged slabs, a head dim that
                                         # is not a multiple of 64 (no
                                         # tensor maps) or of 8 (scalar
                                         # loads)
                                         (1, 8, 4, 512, 0.0),
                                         (2, 8, 4, 512, -1e30),
                                         (2, 256, 4, 512, None),
                                         (1, 300, 4, 512, None),
                                         (1, 100, 2, 96, None),
                                         (1, 50, 2, 36, 0.0)])
def test_mlstm_chunk_kernel_matches_plain(card, B, L, H, hd, m0, dtype):
    rng = np.random.RandomState(B + L + H + hd)
    inputs = _mlstm_inputs(rng, card, B, L, H, hd, m0, dtype)
    if m0 is not None and m0 < -1e29:       # a fresh state
        inputs[5].zero_()
        inputs[6].zero_()
    n0 = mc.LAUNCHES
    got = mc.mlstm_chunk(*inputs)
    want = mc.mlstm_chunk_plain(*inputs)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == n0 + 1
    assert got[0].dtype == dtype and got[1][0].dtype == torch.float32
    _close_mlstm(got, want, dtype)


@pytest.mark.cuda
def test_mlstm_chunk_kernel_padded_rows_match_plain(card):
    """A last chunk padded as the model pads it (zero q/k/v, ilog -1e30,
    flog 0): every row, padded ones included, is the plain version's."""
    rng = np.random.RandomState(3)
    q, k, v, il, fl, C0, n0, m0 = _mlstm_inputs(rng, card, 1, 64, 4, 128,
                                                0.0)
    for t in (q, k, v):
        t[:, 40:] = 0
    il[:, 40:] = -1e30
    fl[:, 40:] = 0
    got = mc.mlstm_chunk(q, k, v, il, fl, C0, n0, m0)
    want = mc.mlstm_chunk_plain(q, k, v, il, fl, C0, n0, m0)
    torch.cuda.synchronize()
    _close_mlstm(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_chunk_kernel_chain_matches_plain_chain(card, dtype):
    """Four chunks of xLSTM-350M's widths (L 256, H 4, hd 512) from a
    fresh state: each chunk's h and the final state."""
    rng = np.random.RandomState(11)
    q, k, v, il, fl, *_ = _mlstm_inputs(rng, card, 1, 1024, 4, 512, 0.0,
                                        dtype)
    st = (torch.zeros((1, 4, 512, 512), device=card),
          torch.zeros((1, 4, 512), device=card),
          torch.full((1, 4), -1e30, device=card))
    stp = st
    for c in range(4):
        sl = slice(256 * c, 256 * (c + 1))
        args = [t[:, sl].contiguous() for t in (q, k, v, il, fl)]
        h, st = mc.mlstm_chunk(*args, *st)
        hp, stp = mc.mlstm_chunk_plain(*args, *stp)
        _close_mlstm((h, st), (hp, stp), dtype)


@pytest.mark.cuda
def test_mlstm_chunk_kernel_rejects_what_it_does_not_take(card):
    rng = np.random.RandomState(0)
    q, k, v, il, fl, C0, n0, m0 = _mlstm_inputs(rng, card, 1, 8, 2, 16)
    with pytest.raises(ValueError, match="float32"):
        mc.mlstm_chunk(q, k, v, il.bfloat16(), fl, C0, n0, m0)
    with pytest.raises(ValueError, match="contiguous"):
        mc.mlstm_chunk(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       il, fl, C0, n0, m0)


# ---------------------------------------------------------------------------
# attention at head dim 256 (RecurrentGemma: KV 1, G 16, window 2048)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,kept,window", [(512, 0, 2048),
                                            (512, 1024, 2048),
                                            (512, 2048, 2048),
                                            (300, 1800, 2048),
                                            (37, 64, 64), (64, 30, 64),
                                            (100, 0, None)])
def test_prefill_kernel_hd256_matches_plain(card, Sq, kept, window, dtype):
    rng = np.random.RandomState(Sq + kept)
    q = _randn(rng, (1, Sq, 16, 256), card, Q_SCALE[dtype], dtype)
    k = _randn(rng, (1, kept + Sq, 1, 256), card, 0.5, dtype)
    v = _randn(rng, (1, kept + Sq, 1, 256), card, 0.5, dtype)
    offs = torch.full((1,), kept, dtype=torch.int32, device=card)
    got = fp.flash_prefill(q, k, v, offs, window)
    want = fp.flash_prefill_plain(q, k, v, offs, window)
    torch.cuda.synchronize()
    _assert_attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_hd256_over_rings_matches_plain(card, dtype):
    """Eight slots of a (8, 2048) ring viewed as 16-row pages, contexts
    below and at the window (the engine's ``min(pos, W-1) + 1``)."""
    rng = np.random.RandomState(5)
    B, W = 8, 2048
    ring_k = _randn(rng, (B, W, 1, 256), card, 0.5, dtype)
    ring_v = _randn(rng, (B, W, 1, 256), card, 0.5, dtype)
    pages = (B * W // 16, 16, 1, 256)
    bt = torch.arange(B * W // 16, dtype=torch.int32,
                      device=card).reshape(B, -1)
    ctx = torch.tensor([1, 17, 600, 2047, 2048, 2048, 1500, 2048],
                       dtype=torch.int32, device=card)
    q = _randn(rng, (B, 16, 256), card, Q_SCALE[dtype], dtype)
    got = pa.paged_attention(q, ring_k.view(pages), ring_v.view(pages), bt,
                             ctx)
    want = pa.paged_attention_plain(q, ring_k.view(pages),
                                    ring_v.view(pages), bt, ctx)
    torch.cuda.synchronize()
    _assert_attn_close(got, want, dtype)


# ---------------------------------------------------------------------------
# the recurrent smoke models on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recurrentgemma_9b-smoke",
                                  "xlstm_350m-smoke"])
def test_recurrent_model_runs_the_kernels_on_the_card(card, name):
    """A float32 smoke model on the card: chunked prefill (64 tokens, then
    16 over them: at the smoke window) and a decode step through the
    kernels give the plain full forward's logits (atol 1e-3: a few layers
    of f32 work, the attention products at ~16 bits), with the expected
    launches of each kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, 80))).to(card)
    cache = m.init_cache(1, 128)
    before = (rs.LAUNCHES, mc.LAUNCHES, fp.LAUNCHES, pa.LAUNCHES)
    m.prefill_cached(params, toks[:, :64], torch.arange(64)[None], cache,
                     [0])
    got, _ = m.prefill_cached(params, toks[:, 64:], torch.arange(64, 80)[None],
                              cache, [64])
    dec, _ = m.decode_step(params, toks[:, :1], torch.tensor([80]), cache)
    torch.cuda.synchronize()
    after = (rs.LAUNCHES, mc.LAUNCHES, fp.LAUNCHES, pa.LAUNCHES)
    n = {k: sum(x == k for x in cfg.block_pattern)
         for k in ("rglru", "mlstm", "swa")}
    assert tuple(b - a for a, b in zip(before, after)) == (
        2 * n["rglru"], 2 * n["mlstm"], 2 * n["swa"], n["swa"])
    want, _ = m.prefill(params, toks)
    assert (got - want[:, 64:]).abs().max().item() <= 1e-3
    want, _ = m.prefill(params, torch.cat([toks, toks[:, :1]], dim=1),
                        last_only=True)
    assert (dec - want).abs().max().item() <= 1e-3
    # the plain full forward launched no kernel
    assert (rs.LAUNCHES, mc.LAUNCHES, fp.LAUNCHES, pa.LAUNCHES) == after
