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
from repro_torch.configs import get_config  # noqa: E402
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
    np.testing.assert_allclose(_np(tcache["k"][:, 0, :40]),
                               _np(jcache["units"][0][0][:, 0, :40]),
                               atol=atol, rtol=0)

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
                          {"k": tcache["k"][:, b:b + 1],
                           "v": tcache["v"][:, b:b + 1]}, [0])
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("recurrentgemma_9b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("qwen2_7b-swa")
    with pytest.raises(KeyError):
        get_config("no_such_model")
    cfg = get_config("qwen2_7b-smoke")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(dataclasses.replace(cfg, block_pattern=("attn", "swa")),
              device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        Model(dataclasses.replace(cfg, n_experts=4, top_k=2), device="cpu")


def test_port_config_equals_reference():
    """The port's configs are field for field the reference's."""
    for name in ("qwen2_7b", "qwen3_4b", "qwen2_7b-smoke", "qwen3_4b-smoke"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))


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
