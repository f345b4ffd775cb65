"""The port's model against the JAX package's, on the CPU.

The reference's ``Model.init`` parameters are converted with
``params_from_numpy`` (bit for bit) and both models run the same seeded
token ids: ``prefill`` (the plain full forward), ``prefill_cached`` in two
chunks (the second with ``cache_len > 0``, through the port's
``flash_prefill``) and ``decode_step`` (through ``paged_attention``).
Configurations: ``qwen3_4b-smoke`` (qk-norm, tied embeddings),
``qwen2_7b-smoke`` and a G = 7 narrow cut of Qwen2-7B (28 query heads
over 4 KV heads), each in float32 and bfloat16.

Tolerances on the f32 logits: float32 atol 1e-4 (sums in another order,
f32 transcendental functions of two libraries); bfloat16 atol 0.15 on
logits of magnitude up to ~5 (activations, weights and the residual
stream round to bf16 at different places in XLA and PyTorch, and the
port rounds the lm-head product to bf16 before widening).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 0.15}


def _cfgs(name, dtype):
    if name == "g7":
        kw = dict(name="qwen2-7b-g7", n_heads=28, n_kv_heads=4, head_dim=64,
                  n_layers=2, block_pattern=("attn",) * 2)
        jc = dataclasses.replace(j_get_config("qwen2_7b-smoke"), **kw)
        tc = dataclasses.replace(get_config("qwen2_7b-smoke"), **kw)
    else:
        jc, tc = j_get_config(name), get_config(name)
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


_CACHE = {}


def _models(name, dtype):
    key = (name, dtype)
    if key not in _CACHE:
        jc, tc = _cfgs(name, dtype)
        jm = JModel(jc)
        jp = jm.init(jax.random.key(7))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
        _CACHE[key] = (jm, jp, Model(tc, device="cpu"), tp)
    return _CACHE[key]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


CASES = [(n, d) for n in ("qwen3_4b-smoke", "qwen2_7b-smoke", "g7")
         for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,dtype", CASES)
def test_params_convert_bit_for_bit(name, dtype):
    jm, jp, tm, tp = _models(name, dtype)
    cfg = tm.cfg
    assert len(tp["layers"]) == cfg.n_layers
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert ("q_norm" in tp["layers"][0]["attn"]) == cfg.qk_norm
    unit = jp["units"][0]
    for layer in range(cfg.n_layers):
        for path in (("attn", "wq", "w"), ("attn", "wo", "w"),
                     ("ffn", "wg", "w"), ("norm1", "scale")):
            want, got = unit, tp["layers"][layer]
            for k in path:
                want, got = want[k], got[k]
            want = np.asarray(want[layer])
            assert str(got.dtype) == f"torch.{dtype}"
            if dtype == "bfloat16":
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,dtype", CASES)
def test_logits_match_jax(name, dtype):
    """prefill, prefill_cached (two chunks, the second over a cached
    prefix) and two decode steps give the JAX logits."""
    jm, jp, tm, tp = _models(name, dtype)
    V = tm.cfg.vocab_size
    rng = np.random.RandomState(11)
    toks = rng.randint(0, V, (2, 40)).astype(np.int32)
    atol = TOL[dtype]

    jl, _ = jm.prefill(jp, jnp.asarray(toks))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 40, V)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)

    # chunked prefill of row 0 into a 64-slot cache: 24 tokens, then 16
    # more over the 24 cached ones
    jcache, tcache = jm.init_cache(1, 64), tm.init_cache(1, 64)
    for lo, hi in ((0, 24), (24, 40)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jl2, jcache = jm.prefill_cached(jp, jnp.asarray(toks[:1, lo:hi]),
                                        jnp.asarray(pos), jcache,
                                        jnp.full((1,), lo, jnp.int32))
        tl2, tcache = tm.prefill_cached(tp, torch.from_numpy(toks[:1, lo:hi]),
                                        torch.from_numpy(pos), tcache, [lo])
        np.testing.assert_allclose(_np(tl2), _np(jl2), atol=atol, rtol=0)
    # the chunked path ends where the full forward does
    np.testing.assert_allclose(_np(tl2)[0, -1], _np(tl)[0, -1], atol=atol,
                               rtol=0)
    np.testing.assert_allclose(
        _np(torch.stack([c["k"] for c in tcache])[:, 0, :40]),
        _np(jcache["units"][0][0][:, 0, :40]), atol=atol, rtol=0)

    for step, tok in enumerate((5, 17)):
        p = np.array([40 + step], np.int32)
        jd, jcache = jm.decode_step(jp, jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray(p), jcache)
        td, tcache = tm.decode_step(tp, torch.tensor([[tok]]),
                                    torch.from_numpy(p), tcache)
        assert tuple(td.shape) == (1, 1, V)
        np.testing.assert_allclose(_np(td), _np(jd), atol=atol, rtol=0)


def test_batched_prefill_cached_and_decode_match_jax():
    """Two sequences at different cache lengths in one call (per-row
    kv_offset) and a batched decode over both slots, in float32."""
    jm, jp, tm, tp = _models("g7", "float32")
    rng = np.random.RandomState(5)
    toks = rng.randint(0, tm.cfg.vocab_size, (2, 30)).astype(np.int32)
    jcache, tcache = jm.init_cache(2, 48), tm.init_cache(2, 48)
    # fill row 0 with 20 tokens and row 1 with 12 (one call each)
    for b, n in ((0, 20), (1, 12)):
        pos = np.arange(n, dtype=np.int32)[None]
        jsub = jax.tree.map(lambda a: a[:, b:b + 1], jcache["units"])
        _, jnew = jm.prefill_cached(jp, jnp.asarray(toks[b:b + 1, :n]),
                                    jnp.asarray(pos),
                                    {"units": jsub, "rest": ()},
                                    jnp.zeros((1,), jnp.int32))
        jcache["units"] = jax.tree.map(
            lambda a, s: a.at[:, b:b + 1].set(s), jcache["units"],
            jnew["units"])
        tm.prefill_cached(tp, torch.from_numpy(toks[b:b + 1, :n]),
                          torch.from_numpy(pos),
                          [{k: t[b:b + 1] for k, t in c.items()}
                           for c in tcache], [0])
    # one call, 6 more tokens each, at offsets 20 and 12
    chunk = np.stack([toks[0, 20:26], toks[1, 12:18]])
    pos = np.stack([np.arange(20, 26), np.arange(12, 18)]).astype(np.int32)
    jl, jcache = jm.prefill_cached(jp, jnp.asarray(chunk), jnp.asarray(pos),
                                   jcache, jnp.asarray([20, 12], jnp.int32))
    tl, tcache = tm.prefill_cached(tp, torch.from_numpy(chunk),
                                   torch.from_numpy(pos), tcache, [20, 12])
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    nxt = np.array([[3], [9]], np.int32)
    p = np.array([26, 18], np.int32)
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(p), jcache)
    td, _ = tm.decode_step(tp, torch.from_numpy(nxt), torch.from_numpy(p),
                           tcache)
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-4, rtol=0)


def test_blockwise_prefill_matches_jax():
    """A prompt past the blockwise threshold (2048) takes the online-softmax
    path in both packages."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    assert tattn.BLOCKWISE_THRESHOLD == jattn.BLOCKWISE_THRESHOLD
    assert tattn.KV_CHUNK == jattn.KV_CHUNK
    jm, jp, tm, tp = _models("qwen2_7b-smoke", "float32")
    rng = np.random.RandomState(2)
    toks = rng.randint(0, tm.cfg.vocab_size, (1, 2100)).astype(np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(toks), last_only=True)
    tl, _ = tm.prefill(tp, torch.from_numpy(toks), last_only=True)
    assert tuple(tl.shape) == (1, 1, tm.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)


def test_unported_configs_raise():
    """Every id of the reference is ported now: ``get_config`` raises only
    ``KeyError``, for an unknown id, and every id in ``ARCH_IDS`` --
    ``whisper_medium`` included, with its frames -- builds at smoke size
    and runs ``prefill``; MoE, VLM, soft-capped and sliding-window
    configs too."""
    with pytest.raises(KeyError):
        get_config("no_such_model")
    with pytest.raises(KeyError):
        get_config("no_such_model-smoke")
    assert "whisper_medium" in ARCH_IDS
    toks = torch.tensor([[3, 1, 4, 1, 5]])
    cfg = get_config("qwen2_7b-smoke")
    built = [get_config(a + "-smoke") for a in ARCH_IDS] + [
        dataclasses.replace(cfg, n_experts=4, top_k=2),
        dataclasses.replace(cfg, logit_soft_cap=30.0),
        get_config("qwen2_7b-swa-smoke")]
    for c in built:
        m = Model(c, device="cpu")
        batch = None
        if c.is_encdec:
            batch = {"frames": np.zeros((1, c.enc_seq, c.enc_d_model),
                                        np.float32)}
        logits, _ = m.prefill(m.init(torch.Generator().manual_seed(0)),
                              toks, batch)
        assert tuple(logits.shape) == (1, 5, c.vocab_size), c.name
        assert bool(torch.isfinite(logits).all()), c.name
    assert get_config("qwen2_7b-swa").block_pattern == ("swa",) * 28
    assert get_config("whisper_medium").block_pattern == ("xattn",) * 24


def test_port_config_equals_reference():
    """The port's configs are field for field the reference's: every id
    the port serves, with its smoke and sliding-window forms."""
    for name in (a + s for a in ARCH_IDS
                 for s in ("", "-smoke", "-swa", "-swa-smoke")):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name)), name


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_config("qwen2_7b-smoke"), dtype="float32")
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    p2 = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(p["layers"][1]["ffn"]["wo"]["w"],
                       p2["layers"][1]["ffn"]["wo"]["w"])
    wq = p["layers"][0]["attn"]["wq"]["w"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(p["embed"]["w"].std().item() - 0.02) < 0.002
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert tuple(p["lm_head"]["w"].shape) == (cfg.d_model,
                                              cfg.padded_vocab_size)


# ---------------------------------------------------------------------------
# the recurrent families
# ---------------------------------------------------------------------------
#: xLSTM's random-weight smoke model amplifies rounding: a 1e-6 relative
#: change of its f32 embeddings moves its logits by ~1.6e-4, one bf16 ulp
#: in 1% of its bf16 embeddings by up to ~0.3-0.4 and by an RMS ratio of
#: ~0.14 (measured on the CPU, ``test_xlstm_smoke_amplifies_rounding``),
#: so two libraries' rounding differs by that much.  Its bf16 logits are
#: held by (max |diff|, RMS of the difference over the RMS of JAX's
#: logits): port and JAX part by 0.04-0.11 in RMS ratio, a model with
#: other weights by ~1.4.  RecurrentGemma holds the other models'
#: tolerances
REC_TOL = {("recurrentgemma_9b-smoke", "float32"): 1e-4,
           ("recurrentgemma_9b-smoke", "bfloat16"): 0.15,
           ("xlstm_350m-smoke", "float32"): 5e-4,
           ("xlstm_350m-smoke", "bfloat16"): (0.6, 0.25)}
REC_CASES = list(REC_TOL)


def _close(got, want, tol):
    """``got`` within ``tol`` of ``want``: an atol, or (atol, RMS ratio)."""
    got, want = _np(got), _np(want)
    atol, rel = tol if isinstance(tol, tuple) else (tol, None)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if rel is not None:
        ratio = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert ratio <= rel, ratio


@pytest.mark.parametrize("name,dtype", REC_CASES)
def test_recurrent_logits_match_jax(name, dtype):
    """prefill, prefill_cached in three chunks (cache_len 0, 24 and 64:
    below and at the smoke window of 64) and two decode steps past the
    window give the JAX logits.  Each chunk is held to the reference's
    full forward, and to its cached path where that is right (ROADMAP
    Queue C.10: the reference's ``swa`` chunk at 0 < cache_len < W sees
    ring slots never written)."""
    jm, jp, tm, tp = _models(name, dtype)
    V = tm.cfg.vocab_size
    toks = np.random.RandomState(11).randint(0, V, (2, 80)).astype(np.int32)
    atol = REC_TOL[(name, dtype)]
    jl, _ = jm.prefill(jp, jnp.asarray(toks))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 80, V)
    _close(tl, jl, atol)
    has_swa = "swa" in tm.cfg.block_pattern
    jcache, tcache = jm.init_cache(1, 128), tm.init_cache(1, 128)
    for lo, hi in ((0, 24), (24, 64), (64, 80)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jl2, jcache = jm.prefill_cached(jp, jnp.asarray(toks[:1, lo:hi]),
                                        jnp.asarray(pos), jcache,
                                        jnp.full((1,), lo, jnp.int32))
        tl2, tcache = tm.prefill_cached(tp, torch.from_numpy(toks[:1, lo:hi]),
                                        torch.from_numpy(pos), tcache, [lo])
        _close(tl2, _np(jl)[:1, lo:hi], atol)
        if not (has_swa and 0 < lo < tm.cfg.window_size):
            _close(tl2, jl2, atol)
    for step, tok in enumerate((5, 17)):
        p = np.array([80 + step], np.int32)
        jd, jcache = jm.decode_step(jp, jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray(p), jcache)
        td, tcache = tm.decode_step(tp, torch.tensor([[tok]]),
                                    torch.from_numpy(p), tcache)
        _close(td, jd, atol)


@pytest.mark.parametrize("name", ["recurrentgemma_9b-smoke",
                                  "xlstm_350m-smoke"])
def test_recurrent_params_convert_bit_for_bit(name):
    """The scan-stacked reference parameters unstack into the port's
    layers bit for bit, and the recurrences' f32 leaves stay f32."""
    jm, jp, tm, tp = _models(name, "bfloat16")
    unit, n_units, rest = tm.cfg.repeating_unit()
    assert len(tp["layers"]) == tm.cfg.n_layers
    f32 = {"rglru": ("lambda", "wa", "ba", "wi", "bi"),
           "mlstm": ("wif", "bif"), "slstm": ("b",)}
    for i, kind in enumerate(tm.cfg.block_pattern):
        u, j = divmod(i, len(unit))
        src = jp["units"][j] if u < n_units else jp["rest"][j]
        for leaf in f32.get(kind, ()):
            want = np.asarray(src[kind][leaf])
            want = want[u] if u < n_units else want
            got = tp["layers"][i][kind][leaf]
            assert got.dtype == torch.float32, (kind, leaf)
            np.testing.assert_array_equal(got.numpy(), want)
    leaf = tp["layers"][0][unit[0]]
    w = leaf["wx"]["w"] if "wx" in leaf else leaf["up"]["w"]
    assert w.dtype == torch.bfloat16


def test_recurrentgemma_unstacks_units_and_rest():
    """RecurrentGemma-9B's 38 layers are (rglru, rglru, swa) x 12 plus
    (rglru, rglru); the converter needs only the config's unit."""
    cfg = get_config("recurrentgemma_9b")
    assert cfg.repeating_unit() == (("rglru", "rglru", "swa"), 12,
                                    ("rglru", "rglru"))
    assert sum(k == "rglru" for k in cfg.block_pattern) == 26
    xl = get_config("xlstm_350m")
    assert sum(k == "mlstm" for k in xl.block_pattern) == 21


def test_xlstm_smoke_amplifies_rounding():
    """The measurement behind REC_TOL's xLSTM entries: perturbing the
    port's own f32 embeddings by 1e-6 (relative) moves the logits by more
    than 5e-5, and one bf16 ulp in 1% of the bf16 embeddings moves them by
    more than 0.1, and by an RMS ratio of more than 0.1."""
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, 512, (2, 40)))
    gen = torch.Generator().manual_seed(0)
    for dtype, bump, floor in (("float32", None, 5e-5),
                               ("bfloat16", 2 ** -7, 0.1)):
        _, _, tm, tp = _models("xlstm_350m-smoke", dtype)
        w = tp["embed"]["w"]
        if bump is None:
            w2 = w * (1 + 1e-6 * torch.randn(w.shape, generator=gen))
        else:
            hit = torch.rand(w.shape, generator=gen) < 0.01
            w2 = torch.where(hit, (w.float() * (1 + bump)).to(w.dtype), w)
        base, _ = tm.prefill(tp, toks)
        moved, _ = tm.prefill(dict(tp, embed={"w": w2}), toks)
        assert (base - moved).abs().max().item() > floor, dtype
        if bump is not None:
            ratio = ((base - moved).square().mean()
                     / base.square().mean()).sqrt().item()
            assert ratio > 0.1, ratio
