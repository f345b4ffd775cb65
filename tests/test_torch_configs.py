"""The port's model on the decoder-only configurations beyond those of
``tests/test_torch_model.py``, against the JAX package's, on the CPU.

For each smoke configuration (the MoE models Qwen3-30B-A3B, Granite-MoE
and Arctic; PaliGemma, MiniCPM, Yi, DeepSeek; Qwen2-7B's sliding-window
variant) the reference's ``Model.init`` parameters are converted with
``params_from_numpy`` and both models run the same seeded tokens:
``prefill`` (two rows of 80), ``prefill_cached`` in three chunks (at
cache lengths 0, 24 and 64) and two decode steps, in float32 (atol 1e-4)
and bfloat16 (atol 0.15), the tolerances of ``tests/test_torch_model.py``.
Each chunk is held to the reference's cached path, which computes its
MoE capacity per chunk as the port does, except where the reference's
``swa`` cached prefill is wrong (0 < cache_len < window, ROADMAP Queue
C.10): there, and for every dense chunk, to the reference's full forward.
PaliGemma's full forward also runs with patch embeddings, and one
configuration with logit soft-capping.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.model as j_model_mod  # noqa: E402
import repro_torch.models.model as t_model_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import VISION_DIM  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 0.15}
NAMES = ["qwen3_30b_moe-smoke", "granite_moe_3b_a800m-smoke",
         "arctic_480b-smoke", "paligemma_3b-smoke", "minicpm_2b-smoke",
         "yi_6b-smoke", "deepseek_67b-smoke", "qwen2_7b-swa-smoke"]
CASES = [(n, d) for n in NAMES for d in ("float32", "bfloat16")]

_CACHE = {}


def _models(name, dtype, **kw):
    key = (name, dtype, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jc, tc = (dataclasses.replace(c, dtype=dtype, **kw)
                  for c in (j_get_config(name), get_config(name)))
        jm = JModel(jc)
        jp = jm.init(jax.random.key(7))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
        _CACHE[key] = (jm, jp, Model(tc, device="cpu"), tp)
    return _CACHE[key]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


class _Routes:
    """Each MoE layer's experts per token, in call order, from both
    packages: test-side wrappers around the two models' ``moe_apply``
    (the reference's through ``jax.debug.callback``, since its layers run
    in a scan).  Rounding can flip a token's choice between two nearly
    tied experts; a flip changes that token's output and, through the
    expert buffers' order and the K/V of later layers, the outputs of
    later tokens of its row.  (A token's choices in another order are no
    flip: they take the same buffer rows and only sum in another order.)  ``mask`` keeps the
    positions that no flip reached, and every flip must be a near tie in
    both packages (the two experts within ``NEAR_TIE`` in log-probability).
    """

    def __init__(self, monkeypatch, n_rows):
        self.j, self.t = [], []
        self.flips, self.routed, self.gaps = 0, 0, []
        self.tainted = [np.inf] * n_rows
        j_orig, t_orig = j_model_mod.moe_apply, t_model_mod.moe_apply

        def j_moe(p, x, cfg):
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"],
                                   -1)
            jax.debug.callback(
                lambda i, q: self.j.append((np.asarray(i), np.asarray(q))),
                jax.lax.top_k(probs, cfg.top_k)[1], probs, ordered=True)
            return j_orig(p, x, cfg)

        def t_moe(p, x, cfg):
            probs = torch.softmax(x.float() @ p["router"]["w"], -1)
            self.t.append((t_layers.moe_route(p, x, cfg)["topi"].numpy(),
                           probs.numpy()))
            return t_orig(p, x, cfg)

        monkeypatch.setattr(j_model_mod, "moe_apply", j_moe)
        monkeypatch.setattr(t_model_mod, "moe_apply", t_moe)

    def mask(self, positions, rows, dtype):
        """After one call of each package over ``positions`` (n, S) of
        ``rows``: the positions whose logits no flip has reached.  A flip
        whose router input no earlier flip reached (an earlier layer, or
        an earlier position of its row) must be a near tie."""
        jax.effects_barrier()
        assert len(self.j) == len(self.t) > 0
        for (ji, jp), (ti, tp) in zip(self.j, self.t):   # layer by layer
            reached = list(self.tainted)
            flip = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
            self.routed += flip.size
            for r, s in zip(*np.nonzero(flip)):
                b, p = rows[r], positions[r, s]
                self.flips += 1
                if p < reached[b]:
                    lost = np.setdiff1d(ji[r, s], ti[r, s])
                    got = np.setdiff1d(ti[r, s], ji[r, s])
                    gap = max(np.abs(np.log(q[r, s, lost][:, None])
                                     - np.log(q[r, s, got][None])).max()
                              for q in (jp, tp))
                    self.gaps.append(float(gap))
                    assert gap < NEAR_TIE[dtype], (r, s, gap)
                self.tainted[b] = min(self.tainted[b], p)
        self.j.clear()
        self.t.clear()
        return positions < np.array([self.tainted[b] for b in rows])[:, None]


#: largest router log-probability gap between two experts at which the
#: packages may choose differently: far above float32 rounding, and in
#: bfloat16 twice the largest log-probability difference measured at the
#: smoke models' routers before any flip (0.029, rounding of the residual
#: stream at different places)
NEAR_TIE = {"float32": 1e-4, "bfloat16": 2 ** -4}


@pytest.mark.parametrize("name,dtype", CASES)
def test_logits_match_jax(name, dtype, monkeypatch):
    """Full forward, three chunks and two decode steps.  MoE chunks are
    held to the reference's chunks (the same per-chunk capacity), dense
    ones to its chunks and its full forward, and where the reference's
    ``swa`` cached path is wrong (C.10) the chunks and decode steps to
    its full forward."""
    jm, jp, tm, tp = _models(name, dtype)
    cfg = tm.cfg
    V, atol = cfg.vocab_size, TOL[dtype]
    moe = cfg.n_experts > 0
    routes = _Routes(monkeypatch, 2) if moe else None
    held = []                   # (positions compared, positions) per check

    def check(got, want, pos=None, rows=None):
        """``got`` within ``atol`` of ``want`` at the positions no expert
        flip reached (all of them for a dense model)."""
        got, want = _np(got), _np(want)
        m = np.ones(got.shape[:2], bool)
        if moe and pos is not None:
            m = routes.mask(pos, rows, dtype)
        np.testing.assert_allclose(got[m], want[m], atol=atol, rtol=0)
        held.append((int(m.sum()), m.size))

    toks = np.random.RandomState(11).randint(0, V, (2, 82)).astype(np.int32)
    toks[0, 80:] = (5, 17)
    jl, _ = jm.prefill(jp, jnp.asarray(toks[:, :80]))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks[:, :80]))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 80, V)
    check(tl, jl, np.tile(np.arange(80), (2, 1)), (0, 1))
    swa = "swa" in cfg.block_pattern
    if moe:                         # row 0 again, from its first position
        routes.tainted = [np.inf] * 2
    jcache, tcache = jm.init_cache(1, 128), tm.init_cache(1, 128)
    for lo, hi in ((0, 24), (24, 64), (64, 80)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jl2, jcache = jm.prefill_cached(jp, jnp.asarray(toks[:1, lo:hi]),
                                        jnp.asarray(pos), jcache,
                                        jnp.full((1,), lo, jnp.int32))
        tl2, tcache = tm.prefill_cached(tp, torch.from_numpy(toks[:1, lo:hi]),
                                        torch.from_numpy(pos), tcache, [lo])
        if not (swa and lo > 0):
            check(tl2, jl2, pos, (0,))
        if not moe:
            check(tl2, _np(jl)[:1, lo:hi])
    for step in range(2):
        p = np.array([80 + step], np.int32)
        tok = toks[:1, 80 + step:81 + step]
        jd, jcache = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(p),
                                    jcache)
        td, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                    torch.from_numpy(p), tcache)
        assert tuple(td.shape) == (1, 1, V)
        if swa:
            jd, _ = jm.prefill(jp, jnp.asarray(toks[:1, :81 + step]),
                               last_only=True)
        check(td, jd, p[None], (0,))
    done, total = np.sum(held, axis=0)
    if not moe:
        assert done == total
    else:
        # flips are rare (about one routed token in 150 at the smoke
        # models' four experts) but taint the rest of their row, which
        # still leaves a quarter of the positions to compare
        assert routes.flips <= 0.02 * routes.routed, routes.gaps
        assert done >= total // 4, (done, total, routes.gaps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paligemma_patch_embeds_match_jax(dtype):
    """The projected patches precede the tokens, positions restart at 0,
    and the logits and the K/V cache cover patches and tokens alike."""
    jm, jp, tm, tp = _models("paligemma_3b-smoke", dtype)
    cfg = tm.cfg
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    pe = rng.randn(2, cfg.n_patches, VISION_DIM).astype(np.float32)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks),
                            {"patch_embeds": jnp.asarray(pe)})
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks),
                            {"patch_embeds": torch.from_numpy(pe)})
    assert tuple(tl.shape) == (2, cfg.n_patches + 24, cfg.vocab_size)
    _close(tl, jl, TOL[dtype])
    _close(tcache[0]["k"], jcache["units"][0][0][0], TOL[dtype])
    bare, _ = tm.prefill(tp, torch.from_numpy(toks))
    assert (tl[:, -24:] - bare).abs().max() > 5 * TOL[dtype]
    last, _ = tm.prefill(tp, torch.from_numpy(toks),
                         {"patch_embeds": torch.from_numpy(pe)},
                         last_only=True)
    _close(last, _np(tl)[:, -1:], TOL[dtype])


def test_logit_soft_cap_matches_jax():
    """Soft-capping (``cap * tanh(logits / cap)``) on a replaced config:
    every entry point, float32."""
    jm, jp, tm, tp = _models("qwen3_30b_moe-smoke", "float32",
                             logit_soft_cap=2.0)
    toks = np.random.RandomState(3).randint(0, 512, (2, 30)).astype(np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(toks))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks))
    _close(tl, jl, 1e-4)
    assert tl.abs().max() < 2.0 and tl.abs().max() > 1.5
    jcache, tcache = jm.init_cache(2, 48), tm.init_cache(2, 48)
    pos = np.broadcast_to(np.arange(30, dtype=np.int32), (2, 30))
    jl2, jcache = jm.prefill_cached(jp, jnp.asarray(toks), jnp.asarray(pos),
                                    jcache, jnp.zeros((2,), jnp.int32))
    tl2, tcache = tm.prefill_cached(tp, torch.from_numpy(toks),
                                    torch.from_numpy(pos.copy()), tcache,
                                    [0, 0])
    _close(tl2, jl2, 1e-4)
    p = np.array([30, 30], np.int32)
    jd, _ = jm.decode_step(jp, jnp.asarray([[4], [9]], jnp.int32),
                           jnp.asarray(p), jcache)
    td, _ = tm.decode_step(tp, torch.tensor([[4], [9]]), torch.from_numpy(p),
                           tcache)
    _close(td, jd, 1e-4)
