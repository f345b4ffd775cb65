"""Whisper-medium in the port against the JAX package, on the CPU.

``whisper_medium-smoke`` (2 encoder + 2 ``xattn`` decoder layers, 32
frames of width 256, 4 heads of 64) in float32: the reference's
``Model.init`` parameters are converted with ``params_from_numpy`` and
both models take the same seeded frames and token ids.  Held: the
encoder (``_encoder_apply``), ``prefill`` (the plain full forward), two
``prefill_cached`` chunks (the first given ``enc_out``, the second
reading the cross cache) and 4 ``decode_step``s, which on the CPU run
the attention kernels' plain versions (``flash_prefill`` with
``kv_offset = enc_seq``, ``paged_attention`` over the padded cross
cache).

Tolerance: float32 atol 1e-4 on logits of magnitude ~3 and encoder
outputs of ~3 (sums in another order; the encoder's sinusoid through
another library's ``pow``/``sin``: at most ~4e-6 at 32 frames).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import _encoder_apply  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import cross_rows  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ATOL = 1e-4
_CACHE = {}


def _models(dtype="float32", **kw):
    key = (dtype, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jc = dataclasses.replace(j_get_config("whisper_medium-smoke"),
                                 dtype=dtype, **kw)
        tc = dataclasses.replace(get_config("whisper_medium-smoke"),
                                 dtype=dtype, **kw)
        jm = JModel(jc)
        jp = jm.init(jax.random.key(5))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
        _CACHE[key] = (jm, jp, Model(tc, device="cpu"), tp)
    return _CACHE[key]


def _inputs(cfg, B=2, S=20, seed=3):
    rng = np.random.RandomState(seed)
    frames = rng.randn(B, cfg.enc_seq, cfg.enc_d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, toks


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_encoder_matches_jax():
    jm, jp, tm, tp = _models()
    frames, _ = _inputs(tm.cfg)
    want = _encoder_apply(jp["encoder"], jnp.asarray(frames), jm.cfg)
    got = tm.encode(tp, frames)
    assert tuple(got.shape) == (2, 32, 256)
    _close(got, want)
    # the served path (flash_prefill at kv_offset = S) and the plain one
    _close(got, tm.encode(tp, frames, plain=True), 1e-5)


def test_prefill_matches_jax():
    jm, jp, tm, tp = _models()
    frames, toks = _inputs(tm.cfg)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks),
                            batch={"frames": jnp.asarray(frames)})
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks),
                            batch={"frames": frames})
    assert tuple(tl.shape) == (2, 20, tm.cfg.vocab_size)
    _close(tl, jl)
    # the cache entries: self K/V of the prompt, cross K/V of the frames
    for i, entry in enumerate(tcache):
        for j, name in enumerate(("k", "v", "xk", "xv")):
            _close(entry[name], jcache["units"][0][j][i])


def _drive_cached(jm, jp, tm, tp, frames, toks, n_decode=4):
    """Two prefill_cached chunks (the first given enc_out) and n_decode
    decode steps through both models; yields (port, JAX) logits."""
    B, S = toks.shape
    j_enc = _encoder_apply(jp["encoder"], jnp.asarray(frames), jm.cfg)
    t_enc = tm.encode(tp, frames)
    jcache, tcache = jm.init_cache(B, 64), tm.init_cache(B, 64)
    for lo, hi, first in ((0, 12, True), (12, S, False)):
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32)[None],
                              (B, hi - lo)).copy()
        jl, jcache = jm.prefill_cached(
            jp, jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos), jcache,
            jnp.full((B,), lo, jnp.int32), enc_out=j_enc if first else None)
        tl, tcache = tm.prefill_cached(
            tp, torch.from_numpy(toks[:, lo:hi]), torch.from_numpy(pos),
            tcache, [lo] * B, enc_out=t_enc if first else None)
        yield tl, jl, tcache
    rng = np.random.RandomState(9)
    for step in range(n_decode):
        tok = rng.randint(0, tm.cfg.vocab_size, (B, 1)).astype(np.int32)
        p = np.full((B,), S + step, np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(p),
                                    jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                    torch.from_numpy(p), tcache)
        yield tl, jl, tcache


def test_cached_chunks_and_decode_match_jax():
    """Two chunks (12 tokens with enc_out, 8 more from the cross cache)
    and 4 decode steps give the JAX logits; the chunked path ends where
    the full forward does."""
    jm, jp, tm, tp = _models()
    frames, toks = _inputs(tm.cfg)
    full, _ = tm.prefill(tp, torch.from_numpy(toks),
                         batch={"frames": frames})
    steps = list(_drive_cached(jm, jp, tm, tp, frames, toks))
    assert len(steps) == 6
    for tl, jl, _ in steps:
        _close(tl, jl)
    _close(steps[1][0][:, -1], full[:, -1])
    cache = steps[-1][2]
    assert tuple(cache[0]["xk"].shape) == (2, 32, 4, 64)


def test_cross_cache_padding_rows_never_read():
    """enc_seq 30 (not a multiple of the 16-row decode page): the cross
    cache holds 32 rows; filled with large values, the padding rows change
    no logit, and the logits still equal the reference's (whose cross
    cache holds exactly 30 rows)."""
    jm, jp, tm, tp = _models(enc_seq=30)
    assert cross_rows(30) == 32
    frames, toks = _inputs(tm.cfg, S=16)
    clean, dirty = [], []
    real_init = tm.init_cache

    def init_dirty(B, n):
        cache = real_init(B, n)
        for entry in cache:
            for name in ("xk", "xv"):
                entry[name][:, 30:] = 1e3
        return cache

    for out, init in ((clean, real_init), (dirty, init_dirty)):
        tm.init_cache = init
        try:
            out.extend(_drive_cached(jm, jp, tm, tp, frames, toks, 2))
        finally:
            tm.init_cache = real_init
    assert bool((dirty[-1][2][0]["xk"][:, 30:] == 1e3).all())
    for (cl, jl, _), (dl, _, _) in zip(clean, dirty):
        assert torch.equal(cl, dl)
        _close(cl, jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_carries_encoder_and_dec_pos(dtype):
    """The vmap-stacked encoder splits into per-layer dicts; every
    encoder leaf, ``encoder/final_norm`` and ``dec_pos`` bit for bit."""
    jm, jp, tm, tp = _models(dtype)
    cfg = tm.cfg
    enc = tp["encoder"]
    assert len(enc["layers"]) == cfg.enc_layers == 2

    def bits(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()

    def same(got, want):
        want = np.asarray(want)
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(
            bits(got), want.view(np.int16) if dtype == "bfloat16" else want)

    for i in range(cfg.enc_layers):
        for path in (("wq", "w"), ("wo", "w"), ("norm1", "scale"),
                     ("norm2", "bias"), ("ffn", "wi", "w"),
                     ("ffn", "wo", "w")):
            got, want = enc["layers"][i], jp["encoder"]["layers"]
            for k in path:
                got, want = got[k], want[k]
            same(got, np.asarray(want)[i])
    same(enc["final_norm"]["scale"], jp["encoder"]["final_norm"]["scale"])
    same(tp["dec_pos"], jp["dec_pos"])
    assert tuple(tp["dec_pos"].shape) == (cfg.max_position, cfg.d_model)
    x = tp["layers"][1]["attn"]
    for name in ("xwq", "xwk", "xwv", "xwo"):
        same(x[name]["w"], np.asarray(jp["units"][0]["attn"][name]["w"])[1])


def test_init_and_engine_refusal():
    """The port's own init draws an encoder of enc_layers dicts and a
    (max_position, d_model) dec_pos; the serving engine refuses an
    encoder-decoder, as the reference's does."""
    from repro_torch.serving.engine import InstanceEngine
    cfg = dataclasses.replace(get_config("whisper_medium-smoke"),
                              dtype="float32")
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert len(p["encoder"]["layers"]) == 2
    assert set(p["encoder"]["layers"][0]) == {"norm1", "wq", "wk", "wv",
                                              "wo", "norm2", "ffn"}
    assert abs(p["dec_pos"].std().item() - 0.01) < 0.001
    assert {"xwq", "xwk", "xwv", "xwo"} <= set(p["layers"][0]["attn"])
    cache = m.init_cache(2, 64)
    assert tuple(cache[0]["xk"].shape) == (2, 32, 4, 64)
    with pytest.raises(ValueError, match="encoder-decoder"):
        InstanceEngine(m, p, device="cpu")
