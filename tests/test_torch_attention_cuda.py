"""The port's two attention kernels against their plain PyTorch versions
on the card (``-m cuda``; they skip without one: a CUDA kernel has no CPU
mode).  This file imports no JAX, so it runs on a machine with a card and
no JAX; the plain versions are held against the JAX package in
``tests/test_torch_attention.py``.

Tolerances, kernel against plain version on the same inputs:

* float32: atol 1e-4.  The kernel takes each f32 product as three bf16
  tensor-core products of split halves (about 16 mantissa bits) with f32
  accumulation in another order than the plain version.
* bfloat16: |diff| <= 5e-3 + 1e-2 |plain|.  Both read the same bf16
  inputs and accumulate in f32; the kernel rounds the softmax weights to
  bf16 before the PV product (the atol) and both round the output to
  bf16 (one ulp is at most 2^-7 of it: the rtol).  q is drawn at scale 2
  (k, v at 0.5) so that each softmax peaks over a few keys and outputs
  reach ~1: a wrong or dropped key moves an output by more than 1e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as fp  # noqa: E402
from repro_torch.serving.block_manager import BlockManager  # noqa: E402
from repro_torch.core.radix import tokens_to_blocks  # noqa: E402

#: (atol, rtol) and the scale q is drawn at, by dtype
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (5e-3, 1e-2)}
Q_SCALE = {torch.float32: 0.5, torch.bfloat16: 2.0}
DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=0.5):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                            * scale).to(dev, dtype)


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - rtol * want.abs()).max().item()
    assert excess <= atol, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize(
    "B,Sq,off,H,KV,hd,window",
    [(2, 24, 16, 4, 2, 64, None),
     (1, 17, 5, 8, 8, 64, None),
     (2, 32, 0, 4, 1, 128, None),
     (2, 24, 16, 4, 2, 64, 8),
     (1, 64, 32, 8, 2, 64, 16),
     (1, 37, 100, 28, 4, 64, None),       # G = 7, ragged
     (1, 512, 0, 28, 4, 128, None),       # Qwen2-7B widths
     (1, 512, 3072, 28, 4, 128, None),
     (1, 300, 1000, 28, 4, 128, None),
     (1, 512, 1024, 28, 4, 128, 256),
     (2, 40, 0, 28, 4, 128, None),        # kv_offset 0, 280 rows: ragged
     (1, 100, 0, 16, 1, 256, None),       # hd 256, 1600 rows: whole tiles
     (1, 77, 30, 16, 1, 256, 64),         # hd 256, window culls key tiles
     (1, 300, 1800, 16, 1, 256, 2048),    # RecurrentGemma-9B's ring
     (2, 50, 200, 14, 2, 64, 32),         # G = 7, window culls, ragged
     (1, 130, 0, 8, 1, 128, 16),          # window 16 < one key tile
     (1, 512, 1024, 32, 4, 128, None),    # Qwen3-30B-A3B widths, G = 8
     (1, 512, 1024, 24, 8, 64, None)])    # Granite-MoE widths, G = 3
def test_prefill_kernel_matches_plain(card, B, Sq, off, H, KV, hd, window,
                                      dtype):
    rng = np.random.RandomState(B * 1000 + Sq + off)
    Sk = off + Sq
    q = _randn(rng, (B, Sq, H, hd), dtype, card, Q_SCALE[dtype])
    k = _randn(rng, (B, Sk, KV, hd), dtype, card)
    v = _randn(rng, (B, Sk, KV, hd), dtype, card)
    offs = torch.full((B,), off, dtype=torch.int32, device=card)
    before = fp.LAUNCHES
    got = fp.flash_prefill(q, k, v, offs, window)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    want = fp.flash_prefill_plain(q, k, v, offs, window)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,window", [(28, 4, 128, None),
                                            (16, 1, 256, 64),
                                            (8, 2, 64, None)])
def test_prefill_kernel_on_a_cache_slice(card, H, KV, hd, window):
    """k/v as the engine passes them: the first Sk rows of a longer slot
    cache (a batch stride that is not Sk rows: the TMA tensor map's own
    stride, and rows past Sk never read), with per-row offsets that
    differ."""
    rng = np.random.RandomState(7)
    B, S, Sq = 3, 256, 40
    cache_k = _randn(rng, (B, S, KV, hd), torch.bfloat16, card)
    cache_v = _randn(rng, (B, S, KV, hd), torch.bfloat16, card)
    offs = torch.tensor([0, 60, 131], dtype=torch.int32, device=card)
    Sk = 131 + Sq
    q = _randn(rng, (B, Sq, H, hd), torch.bfloat16, card,
               Q_SCALE[torch.bfloat16])
    got = fp.flash_prefill(q, cache_k[:, :Sk], cache_v[:, :Sk], offs,
                           window)
    want = fp.flash_prefill_plain(q, cache_k[:, :Sk], cache_v[:, :Sk], offs,
                                  window)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize(
    "B,H,KV,hd,page,npages",
    [(2, 4, 4, 64, 16, 3),
     (3, 8, 2, 64, 16, 4),
     (1, 8, 1, 128, 8, 5),
     (2, 4, 2, 128, 32, 2),
     (3, 28, 4, 64, 16, 9),                # G = 7
     (8, 28, 4, 128, 16, 256),             # Qwen2-7B widths, 4096 keys
     (8, 16, 1, 256, 16, 128),             # RecurrentGemma-9B's rings
     (4, 32, 2, 64, 16, 40),               # G = 16, two kv heads
     (8, 32, 4, 128, 16, 256),             # Qwen3-30B-A3B widths, G = 8
     (8, 24, 8, 64, 16, 256)])             # Granite-MoE widths, G = 3
def test_paged_kernel_matches_plain(card, B, H, KV, hd, page, npages, dtype):
    rng = np.random.RandomState(B * 100 + npages)
    ntotal = npages * B + 2
    q = _randn(rng, (B, H, hd), dtype, card, Q_SCALE[dtype])
    kp = _randn(rng, (ntotal, page, KV, hd), dtype, card)
    vp = _randn(rng, (ntotal, page, KV, hd), dtype, card)
    bt = torch.from_numpy(rng.randint(0, ntotal, (B, npages))
                          .astype(np.int32)).to(card)
    ctx_np = rng.randint(1, npages * page + 1, B).astype(np.int32)
    ctx_np[0] = npages * page
    ctx = torch.from_numpy(ctx_np).to(card)
    before = pa.LAUNCHES
    got = pa.paged_attention(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    want = pa.paged_attention_plain(q, kp, vp, bt, ctx)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("H,KV,hd,window", [(32, 4, 128, None),
                                            (24, 8, 64, 64),
                                            (16, 1, 256, None)])
def test_kernels_soft_cap_scores(card, H, KV, hd, window, dtype):
    """With ``soft_cap`` both kernels take ``cap * tanh(s / cap)`` of each
    scaled score before the softmax, as their plain versions do; the
    smaller cap flattens the softmax visibly."""
    rng = np.random.RandomState(hd + H)
    q = _randn(rng, (1, 96, H, hd), dtype, card, Q_SCALE[dtype])
    k = _randn(rng, (1, 160, KV, hd), dtype, card)
    v = _randn(rng, (1, 160, KV, hd), dtype, card)
    offs = torch.full((1,), 64, dtype=torch.int32, device=card)
    for cap in (0.25, 30.0):
        got = fp.flash_prefill(q, k, v, offs, window, cap)
        want = fp.flash_prefill_plain(q, k, v, offs, window, cap)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype)
    bare = fp.flash_prefill_plain(q, k, v, offs, window)
    assert (fp.flash_prefill_plain(q, k, v, offs, window, 0.25).float()
            - bare.float()).abs().max() > 0.02
    kp = k.reshape(10, 16, KV, hd)
    vp = v.reshape(10, 16, KV, hd)
    bt = torch.arange(10, dtype=torch.int32, device=card)[None].repeat(4, 1)
    ctx = torch.tensor([160, 1, 77, 96], dtype=torch.int32, device=card)
    for cap in (0.25, 30.0):
        got = pa.paged_attention(q[0, :4], kp, vp, bt, ctx, cap)
        want = pa.paged_attention_plain(q[0, :4], kp, vp, bt, ctx, cap)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype)


#: contexts of the split tests: empty, a single key, the edges of one
#: 16-key tile and of a page, and a full table (a ring that is exactly full)
SPLIT_CTX = [0, 1, 15, 16, 17, 700, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("splits", [1, 2, 7, 64])
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (16, 1, 256),
                                     (14, 2, 64)])
def test_paged_kernel_forced_splits(card, H, KV, hd, splits, dtype):
    """Split counts forced from 1 to 64 (the last ones hold no key at short
    contexts): the same result as the plain version, and no NaN."""
    rng = np.random.RandomState(splits * 7 + hd)
    B, page, npages = len(SPLIT_CTX), 16, 2048 // 16
    q = _randn(rng, (B, H, hd), dtype, card, Q_SCALE[dtype])
    kp = _randn(rng, (B * npages, page, KV, hd), dtype, card)
    vp = _randn(rng, (B * npages, page, KV, hd), dtype, card)
    bt = torch.from_numpy(rng.permutation(B * npages).astype(np.int32)
                          .reshape(B, npages)).to(card)
    ctx = torch.tensor(SPLIT_CTX, dtype=torch.int32, device=card)
    pa._check(q, kp, vp, bt, ctx)
    got = pa._launch(q, kp, vp, bt, ctx, splits)
    want = pa.paged_attention_plain(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert not got.isnan().any()
    assert got[0].abs().max().item() == 0.0
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (16, 1, 256)])
def test_paged_kernel_is_deterministic(card, H, KV, hd):
    """The partials are merged in split order without float atomics, so two
    launches on the same inputs give the same bits."""
    rng = np.random.RandomState(5)
    B, page, npages = 8, 16, 128
    q = _randn(rng, (B, H, hd), torch.bfloat16, card, 2.0)
    kp = _randn(rng, (B * npages, page, KV, hd), torch.bfloat16, card)
    vp = _randn(rng, (B * npages, page, KV, hd), torch.bfloat16, card)
    bt = torch.arange(B * npages, dtype=torch.int32,
                      device=card).reshape(B, npages)
    ctx = torch.from_numpy(rng.randint(1, npages * page + 1, B)
                           .astype(np.int32)).to(card)
    splits, grid = pa.launch_config(q, kp, bt)
    assert splits > 1 and grid == (splits, -(-(H // KV) // 16) * KV, B)
    first = pa.paged_attention(q, kp, vp, bt, ctx)
    second = pa.paged_attention(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_kernel_zero_context_gives_zero(card):
    rng = np.random.RandomState(3)
    q = _randn(rng, (2, 28, 128), torch.bfloat16, card,
               Q_SCALE[torch.bfloat16])
    kp = _randn(rng, (4, 16, 4, 128), torch.bfloat16, card)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=card)
    ctx = torch.tensor([0, 5], dtype=torch.int32, device=card)
    got = pa.paged_attention(q, kp, kp, bt, ctx)
    want = pa.paged_attention_plain(q, kp, kp, bt, ctx)
    torch.cuda.synchronize()
    assert got[0].abs().max().item() == 0.0
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_paged_kernel_on_block_manager_tables(card):
    """Block tables from the ported BlockManager: shared prefix pages, and
    two sequences with one shared prompt that each decode into a private
    page (the manager's copy-on-write rule)."""
    rng = np.random.RandomState(11)
    PS, KV, hd, H = 16, 4, 128, 28
    bm = BlockManager(n_pages=64, page_size=PS)
    shared = list(range(5 * PS))
    seqs = {s: shared + list(range(1000 * (s + 1), 1000 * (s + 1) + PS * s))
            for s in range(4)}
    for sid, toks in seqs.items():
        bm.allocate(sid, [(h,) for h in tokens_to_blocks(toks, PS)])
    bm.allocate(9, [(h,) for h in tokens_to_blocks(shared, PS)])
    for sid in (0, 9):                   # both decode past the shared pages
        bm.append_token(sid)
    sids = [0, 1, 2, 3, 9]
    width = max(len(bm.block_table(s)) for s in sids)
    bt = torch.tensor([bm.block_table(s, pad_to=width) for s in sids],
                      dtype=torch.int32, device=card)
    ctx = torch.tensor([bm.context_len(s) for s in sids], dtype=torch.int32,
                       device=card)
    kp = _randn(rng, (64, PS, KV, hd), torch.bfloat16, card)
    vp = _randn(rng, (64, PS, KV, hd), torch.bfloat16, card)
    q = _randn(rng, (len(sids), H, hd), torch.bfloat16, card,
               Q_SCALE[torch.bfloat16])
    got = pa.paged_attention(q, kp, vp, bt, ctx)
    want = pa.paged_attention_plain(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    assert bm.block_table(0)[:5] == bm.block_table(9)[:5]
    assert bm.block_table(0)[5] != bm.block_table(9)[5]


@pytest.mark.cuda
def test_model_and_engine_run_the_kernels_on_the_card(card):
    """A float32 smoke model on the card: chunked prefill over a cached
    prefix and decode (both kernels) give the plain full forward's logits
    (atol 1e-3: 2 layers of f32 work, the kernels' products at ~16 bits),
    and an engine serves a request through both kernels."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import Model
    from repro_torch.serving.engine import InstanceEngine
    cfg = dataclasses.replace(get_config("qwen2_7b-smoke"), dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, 70))).to(card)
    cache = m.init_cache(1, 128)
    f0, p0 = fp.LAUNCHES, pa.LAUNCHES
    m.prefill_cached(params, toks[:, :40], torch.arange(40)[None], cache, [0])
    got, _ = m.prefill_cached(params, toks[:, 40:], torch.arange(40, 70)[None],
                              cache, [40])
    want, _ = m.prefill(params, toks)
    torch.cuda.synchronize()
    assert (got - want[:, 40:]).abs().max().item() <= 1e-3
    dec, _ = m.decode_step(params, toks[:, :1], torch.tensor([70]), cache)
    want, _ = m.prefill(params, torch.cat([toks, toks[:, :1]], dim=1),
                        last_only=True)
    assert (dec - want).abs().max().item() <= 1e-3
    assert fp.LAUNCHES == f0 + 2 * cfg.n_layers
    assert pa.LAUNCHES == p0 + cfg.n_layers
    eng = InstanceEngine(m, params, max_batch=2, max_len=128,
                         chunk_tokens=32, block_size=16)
    req = Request(rid=0, arrival=0.0, blocks=(), prompt_len=70,
                  output_len=4)
    eng.submit(req, toks[0].cpu().numpy())
    while eng.has_work():
        ev = eng.step()
    assert len(ev["finished"][0].out_tokens) == 4


@pytest.mark.cuda
def test_kernels_reject_unsupported_head_dim(card):
    q = torch.zeros((1, 4, 2, 32), device=card)
    offs = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fp.flash_prefill(q, q, q, offs)
    pages = torch.zeros((2, 4, 2, 32), device=card)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        pa.paged_attention(q[:, 0], pages, pages, bt, offs)


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(card):
    """The kernels have no backward: each wrapper raises on CUDA inputs of
    which any requires grad (training runs the plain functions), and
    launches nothing; inputs computed under ``torch.no_grad()`` from ones
    that require grad do not, and launch."""
    from repro_torch.kernels import mlstm_cell as mc
    from repro_torch.kernels import rglru_scan as rg
    rng = np.random.RandomState(4)

    def r(*shape):
        return _randn(rng, shape, torch.float32, card)

    q, k, v = r(1, 8, 2, 64), r(1, 8, 2, 64), r(1, 8, 2, 64)
    offs = torch.zeros(1, dtype=torch.int32, device=card)
    kp, vp = r(4, 16, 2, 64), r(4, 16, 2, 64)
    bt = torch.arange(4, dtype=torch.int32, device=card)[None]
    ctx = torch.full((1,), 40, dtype=torch.int32, device=card)
    a, x, h0 = r(1, 8, 32).sigmoid(), r(1, 8, 32), r(1, 32)
    mq = r(1, 8, 2, 64)
    gates = (r(1, 8, 2), r(1, 8, 2))
    state = (r(1, 2, 64, 64), r(1, 2, 64), r(1, 2))
    calls = {
        "flash_prefill": (fp, lambda t: fp.flash_prefill(t(q), k, v, offs)),
        "paged_attention": (pa, lambda t: pa.paged_attention(
            t(q[:, 0]), kp, vp, bt, ctx)),
        "rglru_scan": (rg, lambda t: rg.rglru_scan(t(a), x, h0)),
        "mlstm_chunk": (mc, lambda t: mc.mlstm_chunk(
            t(mq), mq, mq, *gates, *state)),
    }
    for name, (mod, call) in calls.items():
        before = mod.LAUNCHES
        with pytest.raises(RuntimeError, match="no backward"):
            call(lambda t: t.clone().requires_grad_(True))
        assert mod.LAUNCHES == before, name
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_(True) * 1)
        call(lambda t: t)
        assert mod.LAUNCHES == before + 2, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernels_at_whisper_shapes(card, dtype):
    """Whisper's attention shapes (hd 64, one query head per KV head):
    the encoder's unmasked attention (``kv_offset = Sk = Sq``, queries
    beyond the keys), a cross chunk over the first ``enc_seq`` rows of a
    page-padded cross cache, and cross decode over its paged view with
    ``context_lens = enc_seq``; the padding rows hold large values that
    must not be read."""
    rng = np.random.RandomState(12)
    B, S, H, hd, X = 2, 300, 16, 64, 304
    qs = Q_SCALE[dtype]
    q, k, v = (_randn(rng, (B, S, H, hd), dtype, card, s)
               for s in (qs, 0.5, 0.5))
    offs = torch.full((B,), S, dtype=torch.int32, device=card)
    _assert_close(fp.flash_prefill(q, k, v, offs),
                  fp.flash_prefill_plain(q, k, v, offs), dtype)
    xk = _randn(rng, (B, X, H, hd), dtype, card)
    xv = _randn(rng, (B, X, H, hd), dtype, card)
    xk[:, S:], xv[:, S:] = 1e3, 1e3
    for Sq in (1, 37):
        qc = _randn(rng, (B, Sq, H, hd), dtype, card, qs)
        got = fp.flash_prefill(qc, xk[:, :S], xv[:, :S], offs)
        want = fp.flash_prefill_plain(qc, xk[:, :S].contiguous(),
                                      xv[:, :S].contiguous(), offs)
        _assert_close(got, want, dtype)
    pages = (B * X // 16, 16, H, hd)
    bt = torch.arange(B * X // 16, dtype=torch.int32,
                      device=card).reshape(B, -1)
    qd = _randn(rng, (B, H, hd), dtype, card, qs)
    got = pa.paged_attention(qd, xk.view(pages), xv.view(pages), bt, offs)
    want = pa.paged_attention_plain(qd, xk.view(pages), xv.view(pages), bt,
                                    offs)
    _assert_close(got, want, dtype)
    assert bool(torch.isfinite(got.float()).all())
