"""The port's MoE layer against the JAX package's, on the CPU.

``repro_torch.models.layers.moe_apply`` against ``repro.models.layers.
moe_apply`` on the reference's own parameters (``init_moe``, converted
bit for bit) and the same seeded inputs, at smoke size (E 4, K 2) and on
a narrow cut with Qwen3-30B-A3B's routing widths (E 128, K 8, D 64, F 32,
S 512, where the per-row capacity of 40 drops some choices): equal top-k
experts (``jax.lax.top_k`` of the reference's float32 softmax), equal drop
masks (a loop over each row's choices in token-major, then k-major,
order, from JAX's experts), equal aux loss and outputs within float32
atol 1e-5 / bfloat16 atol 5e-2 (one or two bf16 ulps of outputs of
magnitude ~1: the two libraries round the expert products and the
weighted sum at different places).  Exact ties resolve to the lower
expert index; Arctic's dense residual; rows of a batch never interact;
MoE and VLM parameter trees convert bit for bit; a chunked prefill equals
the full forward when the capacity factor leaves nothing to drop; and a
MoE engine runs in lockstep with the reference engine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as j_engine_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import (_tensor, _tree,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serving.engine import InstanceEngine  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
#: (name, replaced fields, S): the smoke model's layer, and a cut with the
#: real routing widths of Qwen3-30B-A3B (E 128, K 8) at a 512-token chunk
SIZES = {"smoke": ({}, 40),
         "e128k8": (dict(d_model=64, n_experts=128, top_k=8, moe_d_ff=32),
                    512)}


def _cfgs(dtype, base="qwen3_30b_moe-smoke", **kw):
    return (dataclasses.replace(j_get_config(base), dtype=dtype, **kw),
            dataclasses.replace(get_config(base), dtype=dtype, **kw))


def _layer(dtype, seed=0, **kw):
    """The reference's ``init_moe`` parameters and the port's copy."""
    jc, tc = _cfgs(dtype, **kw)
    jp = jl.init_moe(jax.random.key(seed), jc, jnp.dtype(dtype))
    tp = _tree(jax.tree.map(np.asarray, jp), _tensor)
    return jc, jp, tc, tp


def _x(shape, dtype, seed=3):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _loop_keep(topi, E, cap):
    """Capacity drop mask by the definition: within each row, a (token, k)
    choice keeps its place when fewer than ``cap`` earlier choices (in
    token-major, then k-major, order) went to its expert."""
    B, S, K = topi.shape
    keep = np.zeros((B, S * K), bool)
    for b in range(B):
        count = np.zeros(E, np.int64)
        for j, e in enumerate(topi[b].reshape(-1)):
            keep[b, j] = count[e] < cap
            count[e] += 1
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(SIZES))
def test_moe_apply_matches_reference(size, dtype):
    kw, S = SIZES[size]
    jc, jp, tc, tp = _layer(dtype, **kw)
    assert tp["router"]["w"].dtype == torch.float32
    jx, tx = _x((2, S, tc.d_model), dtype)
    jy, jaux = jl.moe_apply(jp, jx, jc)
    ty, taux = tl.moe_apply(tp, tx, tc)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == tuple(tx.shape)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the routing: the reference's own ops, then the drop rule by a loop
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"]["w"], -1)
    jw, ji = jax.lax.top_k(probs, jc.top_k)
    r = tl.moe_route(tp, tx, tc)
    np.testing.assert_array_equal(r["topi"].numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        r["topw"].numpy(),
        np.asarray(jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9)),
        atol=1e-6, rtol=0)
    cap = tl.moe_capacity(S, tc)
    assert cap == max(int(np.ceil(S * tc.top_k / tc.n_experts * 1.25)),
                      tc.top_k)
    keep = _loop_keep(np.asarray(ji), tc.n_experts, cap)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if size == "e128k8":
        assert cap == 40 and 0 < (~keep).sum() < keep.size // 10


def test_topk_ties_resolve_to_lower_index():
    """Equal probabilities keep index order, as ``jax.lax.top_k`` does: a
    zero router ties all experts, and duplicated router columns tie
    pairs of them."""
    jc, jp, tc, tp = _layer("float32")
    jx, tx = _x((1, 6, tc.d_model), "float32")
    E = tc.n_experts
    cases = {"all": np.zeros((tc.d_model, E), np.float32)}
    w = np.random.RandomState(9).randn(tc.d_model, E).astype(np.float32)
    w[:, 3] = w[:, 0]
    w[:, 2] = w[:, 1]
    cases["pairs"] = w
    for name, w in cases.items():
        jp["router"]["w"] = jnp.asarray(w)
        tp["router"]["w"] = torch.from_numpy(w)
        r = tl.moe_route(tp, tx, tc)
        probs = jax.nn.softmax(jx @ jp["router"]["w"], -1)
        _, ji = jax.lax.top_k(probs, tc.top_k)
        np.testing.assert_array_equal(r["topi"].numpy(), np.asarray(ji))
        if name == "all":
            assert (r["topi"].numpy() == np.arange(tc.top_k)).all()
        else:
            # each token's top two are a tied pair, lower index first
            assert set(map(tuple, r["topi"].numpy()[0])) <= {(0, 3), (1, 2)}
        np.testing.assert_allclose(_np(tl.moe_apply(tp, tx, tc)[0]),
                                   _np(jl.moe_apply(jp, jx, jc)[0]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_dense_residual(dtype):
    """Arctic's MoE layer adds a dense FFN of the same input beside the
    experts."""
    jc, jp, tc, tp = _layer(dtype, base="arctic_480b-smoke")
    assert set(tp["dense"]) == {"wi", "wg", "wo"}
    jx, tx = _x((2, 24, tc.d_model), dtype)
    ty, _ = tl.moe_apply(tp, tx, tc)
    np.testing.assert_allclose(_np(ty), _np(jl.moe_apply(jp, jx, jc)[0]),
                               atol=TOL[dtype], rtol=0)
    experts, _ = tl.moe_apply({k: v for k, v in tp.items() if k != "dense"},
                              tx, tc)
    dense = tl.ffn_apply(tp["dense"], tx, tc.ffn_act)
    assert dense.abs().max() > 0.1
    torch.testing.assert_close(ty, experts + dense, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(SIZES))
def test_batch_rows_do_not_interact(size, dtype):
    """Capacity is per row: junk in one row (the engine's empty decode
    slots) leaves another row's output bit for bit as it was."""
    kw, S = SIZES[size]
    _, _, tc, tp = _layer(dtype, **kw)
    _, tx = _x((3, S, tc.d_model), dtype)
    y, _ = tl.moe_apply(tp, tx, tc)
    junk = tx.clone()
    junk[1] = 40.0 * torch.randn(S, tc.d_model,
                                 generator=torch.Generator().manual_seed(1))
    junk[2] = junk[1, :1]                     # one expert set for every token
    y2, _ = tl.moe_apply(tp, junk, tc)
    assert torch.equal(y2[0], y[0])
    alone, _ = tl.moe_apply(tp, tx[:1], tc)
    assert torch.equal(alone[0], y[0])


@pytest.mark.parametrize("name", ["qwen3_30b_moe-smoke", "arctic_480b-smoke",
                                  "paligemma_3b-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_moe_and_vlm_bit_for_bit(name, dtype):
    """Every leaf of the reference's MoE and VLM trees arrives unchanged:
    the experts' stacks, the float32 router, Arctic's dense residual and
    PaliGemma's ``vlm_proj``."""
    jc, tc = (dataclasses.replace(c, dtype=dtype)
              for c in (j_get_config(name), get_config(name)))
    jp = jax.tree.map(np.asarray, JModel(jc).init(jax.random.key(2)))
    tp = params_from_numpy(tc, jp)
    unit = jp["units"][0]
    n = 0
    for i in range(tc.n_layers):
        def walk(want, got, path=()):
            nonlocal n
            if isinstance(want, dict):
                assert set(want) == set(got), path
                for k in want:
                    walk(want[k], got[k], path + (k,))
                return
            want = np.asarray(want)[i]
            assert tuple(got.shape) == want.shape, path
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                assert str(got.dtype) == f"torch.{want.dtype.name}"
                np.testing.assert_array_equal(got.numpy(), want)
            n += 1
        walk(unit, tp["layers"][i])
    if tc.n_experts:
        ffn = tp["layers"][0]["ffn"]
        assert ffn["router"]["w"].dtype == torch.float32
        assert tuple(ffn["wi"]["w"].shape) == (tc.n_experts, tc.d_model,
                                               tc.resolved_moe_d_ff)
        assert tuple(ffn["wo"]["w"].shape) == (tc.n_experts,
                                               tc.resolved_moe_d_ff,
                                               tc.d_model)
        assert ("dense" in ffn) == bool(tc.dense_residual_d_ff)
    if tc.n_patches:
        np.testing.assert_array_equal(
            tp["vlm_proj"]["w"].float().numpy(),
            np.asarray(jp["vlm_proj"]["w"], np.float32))
        assert tuple(tp["vlm_proj"]["w"].shape) == (1152, tc.d_model)
    else:
        assert "vlm_proj" not in tp
    assert n > 0


def _moe_pair(name, dtype, seed=0, **kw):
    jc, tc = (dataclasses.replace(c, dtype=dtype, **kw)
              for c in (j_get_config(name), get_config(name)))
    jm = JModel(jc)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
    return jm, jp, Model(tc, device="cpu"), tp


def test_chunked_prefill_equals_full_without_drops():
    """The port's twin of ``tests/test_models_smoke.py::
    test_moe_chunked_prefill_matches_full_without_capacity_drops``, at the
    smallest capacity factor that drops nothing (E / K, so cap >= S at
    every granularity): two chunks through the cache give the full
    forward's logits in float32.  Also against JAX's full forward."""
    cfg = get_config("granite_moe_3b_a800m-smoke")
    jm, jp, tm, tp = _moe_pair("granite_moe_3b_a800m-smoke", "float32",
                               capacity_factor=cfg.n_experts / cfg.top_k)
    B, S = 2, 16
    toks = np.random.RandomState(1).randint(1, cfg.vocab_size, (B, S))
    full, _ = tm.prefill(tp, torch.from_numpy(toks))
    cache = tm.init_cache(B, S)
    half = S // 2
    pos = torch.arange(half).expand(B, half)
    tm.prefill_cached(tp, torch.from_numpy(toks[:, :half]), pos, cache,
                      [0, 0])
    l2, _ = tm.prefill_cached(tp, torch.from_numpy(toks[:, half:]),
                              pos + half, cache, [half, half])
    np.testing.assert_allclose(_np(l2), _np(full)[:, half:], atol=1e-4,
                               rtol=0)
    jfull, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(_np(full), _np(jfull), atol=1e-4, rtol=0)


def test_moe_engine_lockstep():
    """``InstanceEngine`` on ``qwen3_30b_moe-smoke`` (float32) in lockstep
    with the reference engine: the same event kinds, chunk sizes, decode
    batch sizes, first-token and finish order, KV$ hits and output
    tokens, and logits within 1e-4.  The decode step runs every slot, empty
    ones on junk tokens, and chunks of 16 drop other choices than the
    whole prompt would: both engines do the same."""
    jm, jp, tm, tp = _moe_pair("qwen3_30b_moe-smoke", "float32")
    kw = dict(max_batch=3, max_len=128, chunk_tokens=16, block_size=16)
    jeng = j_engine_mod.InstanceEngine(jm, jp, **kw)
    teng = InstanceEngine(tm, tp, device="cpu", **kw)
    jlog, tlog = [], []
    jdec = jax.jit(jm.decode_step)
    jpre_, jdec_ = jeng._prefill, jeng._decode

    def j_prefill(params, cache, toks, pos, cache_len, b):
        logits, cache = jpre_(params, cache, toks, pos, cache_len, b)
        jlog.append(np.asarray(logits, np.float32))
        return logits, cache

    def j_decode(params, cache, toks, pos):
        jlog.append(np.asarray(jdec(params, toks, pos, cache)[0][:, -1],
                               np.float32))
        return jdec_(params, cache, toks, pos)

    tpre_, tdec_ = teng._prefill, teng._decode

    def t_prefill(*a):
        out = tpre_(*a)
        tlog.append(out.numpy())
        return out

    def t_decode(*a):
        out = tdec_(*a)
        tlog.append(out.numpy())
        return out

    jeng._prefill, jeng._decode = j_prefill, j_decode
    teng._prefill, teng._decode = t_prefill, t_decode
    rng = np.random.RandomState(1)
    base = rng.randint(4, 500, 40).astype(np.int32)
    prompts = {0: (0, base),
               2: (1, np.concatenate([base[:32], rng.randint(4, 500, 9)])),
               5: (2, base[:32].copy()),
               6: (3, rng.randint(4, 500, 23).astype(np.int32))}
    jreqs, treqs, outs = {}, {}, {"j": {}, "t": {}}
    for step in range(200):
        if step in prompts:
            rid, toks = prompts[step]
            jreqs[rid] = JRequest(rid=rid, arrival=0.0, blocks=(),
                                  prompt_len=len(toks), output_len=5)
            treqs[rid] = Request(rid=rid, arrival=0.0, blocks=(),
                                 prompt_len=len(toks), output_len=5)
            jeng.submit(jreqs[rid], toks)
            teng.submit(treqs[rid], toks)
        if not jeng.has_work() and step > max(prompts):
            break
        jev, tev = jeng.step(), teng.step()
        for key in ("kind", "prefill_tokens", "decode_bs"):
            assert jev[key] == tev[key], (step, key)
        for key in ("first", "finished"):
            assert [q.req.rid for q in jev[key]] == \
                [q.req.rid for q in tev[key]], (step, key)
        for side, ev in (("j", jev), ("t", tev)):
            for q in ev["finished"]:
                outs[side][q.req.rid] = list(q.out_tokens)
    assert not teng.has_work() and len(jlog) == len(tlog) >= 15
    for a, b in zip(jlog, tlog):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    assert outs["t"] == outs["j"] and len(outs["t"]) == 4
    assert {r: q.hit_tokens for r, q in treqs.items()} == \
        {r: q.hit_tokens for r, q in jreqs.items()} == \
        {0: 0, 1: 32, 2: 31, 3: 0}
