"""The paged decode kernel's split-K arithmetic, on the CPU.

``csrc/paged_attention.cu`` splits each context across blocks and merges
the blocks' partial softmax states (m, l, o) in split order.
``paged_attention_split_plain`` spells that arithmetic in plain PyTorch
(f32); here it is held against the port's ``paged_attention_plain`` and
the JAX package's Pallas kernel (interpret mode) for 1, 2, 7 and 64
splits, including splits that hold no key and a zero context, and the
wrapper's choice of split count (a pure function) is held to the serving
shapes.  Tolerance: float32 atol 3e-5 / rtol 1e-4, as in
``tests/test_kernels.py`` (the merge sums in another order).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(atol=3e-5, rtol=1e-4)
PAGE, PAGES = 16, 32
#: empty, one key, the edges of a 16-key tile and page, a ragged middle
#: and a full table (a ring that is exactly full)
CONTEXTS = [0, 1, 15, 16, 17, 300, PAGE * PAGES]
#: (H, KV, hd): G = 7 at head dims 64 and 128, G = 16 at 256 and 64
SHAPES = [(14, 2, 64), (28, 4, 128), (16, 1, 256), (32, 2, 64)]


@functools.lru_cache(maxsize=None)
def _case(H, KV, hd):
    """Seeded inputs of one shape and the Pallas kernel's output on them."""
    rng = np.random.RandomState(H * 1000 + KV * 10 + hd)
    B = len(CONTEXTS)
    n_total = B * PAGES + 3
    q = (rng.randn(B, H, hd) * 0.5).astype(np.float32)
    kp = (rng.randn(n_total, PAGE, KV, hd) * 0.5).astype(np.float32)
    vp = (rng.randn(n_total, PAGE, KV, hd) * 0.5).astype(np.float32)
    bt = rng.permutation(n_total)[:B * PAGES].reshape(B, PAGES).astype(
        np.int32)
    ctx = np.asarray(CONTEXTS, np.int32)
    want = np.asarray(j_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, ctx)),
                              interpret=True))
    return (q, kp, vp, bt, ctx), want


@pytest.mark.parametrize("splits", [1, 2, 7, 64])
@pytest.mark.parametrize("H,KV,hd", SHAPES)
def test_split_plain_matches_plain_and_jax(H, KV, hd, splits):
    arrays, pallas = _case(H, KV, hd)
    args = [torch.from_numpy(a) for a in arrays]
    got = pa.paged_attention_split_plain(*args, splits=splits)
    assert got.shape == (len(CONTEXTS), H, hd) and got.dtype == torch.float32
    assert not got.isnan().any()
    assert not got[0].any()                           # zero context gives 0
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got.numpy(),
                               pa.paged_attention_plain(*args).numpy(),
                               **TOL)


@pytest.mark.parametrize("splits", [1, 2, 7, 64])
def test_split_bounds_tile_the_context_in_order(splits):
    """Each sequence's splits cover [0, ctx) in order, start on 16-key
    tiles and, when they hold keys, take at least MIN_TILES tiles (the
    last one may be ragged); the ones past the context are empty."""
    for ctx in list(range(0, 300)) + [1023, 1024, 1025, 4096]:
        bounds = pa.split_bounds(ctx, splits)
        assert len(bounds) == splits
        pos = 0
        for lo, hi in bounds:
            assert lo == pos and hi >= lo
            if hi > lo:
                assert lo % pa.KEY_TILE == 0
                assert hi == ctx or hi - lo >= pa.MIN_TILES * pa.KEY_TILE
            pos = hi
        assert pos == ctx
    assert all(hi == lo for lo, hi in pa.split_bounds(20, 64)[1:])


@pytest.mark.parametrize("name,B,KV,G,max_ctx", [
    ("Qwen2-7B, hd 128", 8, 4, 7, 4096),
    ("RecurrentGemma-9B, hd 256", 8, 1, 16, 2048)])
def test_split_count_fills_the_card_at_the_serving_shapes(name, B, KV, G,
                                                          max_ctx):
    """At the engines' decode (8 slots, page 16) on an H100's 132 SMs:
    at least one block per SM, no split narrower than a page, at most
    MAX_SPLITS."""
    n_sm = 132
    splits = pa.split_count(B, KV, G, max_ctx, n_sm)
    blocks = splits * -(-G // 16) * KV * B
    assert blocks >= n_sm, (name, splits, blocks)
    assert 1 <= splits <= pa.MAX_SPLITS
    assert max_ctx // splits >= pa.MIN_TILES * pa.KEY_TILE >= 16
    for ctx in range(0, max_ctx + 1, 7):
        for lo, hi in pa.split_bounds(ctx, splits):
            assert hi == lo or lo % 16 == 0


def test_split_count_edges():
    """Short tables get fewer splits (never a split under MIN_TILES tiles,
    never fewer than 1); a lone sequence stops at MAX_SPLITS."""
    assert pa.split_count(8, 4, 7, 16, 132) == 1
    assert pa.split_count(8, 4, 7, 0, 132) == 1
    assert pa.split_count(1, 1, 7, 10 ** 6, 132) == pa.MAX_SPLITS
    assert pa.split_count(64, 8, 7, 4096, 132) == 1
    assert pa.split_count(8, 1, 16, 128, 132) == 2
