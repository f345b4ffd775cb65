"""The port's two attention kernels against their plain PyTorch versions
on the card (``-m cuda``; they skip without one: a CUDA kernel has no CPU
mode).  This file imports no JAX, so it runs on a machine with a card and
no JAX; the plain versions are held against the JAX package in
``tests/test_torch_attention.py``.

Tolerances, kernel against plain version on the same inputs:

* float32: atol 1e-4.  The kernel takes each f32 product as three bf16
  tensor-core products of split halves (about 16 mantissa bits) with f32
  accumulation in another order than the plain version.
* bfloat16: atol 2e-2.  Both read the same bf16 inputs and accumulate in
  f32; the kernel rounds the softmax weights to bf16 before the PV
  product and both round the output to bf16 (half an ulp is 2e-3 near 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as fp  # noqa: E402
from repro_torch.serving.block_manager import BlockManager  # noqa: E402
from repro_torch.core.radix import tokens_to_blocks  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
     (1, 512, 1024, 28, 4, 128, 256)])
def test_prefill_kernel_matches_plain(card, B, Sq, off, H, KV, hd, window,
                                      dtype):
    rng = np.random.RandomState(B * 1000 + Sq + off)
    Sk = off + Sq
    q = _randn(rng, (B, Sq, H, hd), dtype, card)
    k = _randn(rng, (B, Sk, KV, hd), dtype, card)
    v = _randn(rng, (B, Sk, KV, hd), dtype, card)
    offs = torch.full((B,), off, dtype=torch.int32, device=card)
    before = fp.LAUNCHES
    got = fp.flash_prefill(q, k, v, offs, window)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    want = fp.flash_prefill_plain(q, k, v, offs, window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_prefill_kernel_on_a_cache_slice(card):
    """k/v as the engine passes them: the first Sk rows of a longer slot
    cache, with per-row offsets that differ."""
    rng = np.random.RandomState(7)
    B, S, H, KV, hd, Sq = 3, 256, 28, 4, 128, 40
    cache_k = _randn(rng, (B, S, KV, hd), torch.bfloat16, card)
    cache_v = _randn(rng, (B, S, KV, hd), torch.bfloat16, card)
    offs = torch.tensor([0, 60, 131], dtype=torch.int32, device=card)
    Sk = 131 + Sq
    q = _randn(rng, (B, Sq, H, hd), torch.bfloat16, card)
    got = fp.flash_prefill(q, cache_k[:, :Sk], cache_v[:, :Sk], offs)
    want = fp.flash_prefill_plain(q, cache_k[:, :Sk], cache_v[:, :Sk], offs)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize(
    "B,H,KV,hd,page,npages",
    [(2, 4, 4, 64, 16, 3),
     (3, 8, 2, 64, 16, 4),
     (1, 8, 1, 128, 8, 5),
     (2, 4, 2, 128, 32, 2),
     (3, 28, 4, 64, 16, 9),                # G = 7
     (8, 28, 4, 128, 16, 256)])            # Qwen2-7B widths, 4096 keys
def test_paged_kernel_matches_plain(card, B, H, KV, hd, page, npages, dtype):
    rng = np.random.RandomState(B * 100 + npages)
    ntotal = npages * B + 2
    q = _randn(rng, (B, H, hd), dtype, card)
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
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_paged_kernel_zero_context_gives_zero(card):
    rng = np.random.RandomState(3)
    q = _randn(rng, (2, 28, 128), torch.bfloat16, card)
    kp = _randn(rng, (4, 16, 4, 128), torch.bfloat16, card)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=card)
    ctx = torch.tensor([0, 5], dtype=torch.int32, device=card)
    got = pa.paged_attention(q, kp, kp, bt, ctx)
    want = pa.paged_attention_plain(q, kp, kp, bt, ctx)
    torch.cuda.synchronize()
    assert got[0].abs().max().item() == 0.0
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


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
    q = _randn(rng, (len(sids), H, hd), torch.bfloat16, card)
    got = pa.paged_attention(q, kp, vp, bt, ctx)
    want = pa.paged_attention_plain(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
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
