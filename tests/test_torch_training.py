"""The port's training path against the JAX package, on the CPU:
``Model.forward_train`` and its gradients, AdamW and the LR schedules,
the train step (plain and accumulated), checkpoints and the data
pipeline.  Smoke configs in float32; the reference's parameters are
converted with ``params_from_numpy``, and so are its gradient trees.

Tolerances (float32):

* ``forward_train``: loss, ce, aux, zloss within 1e-4 (5e-4 for
  xLSTM-350M, whose random-weight smoke model amplifies rounding, see
  ``tests/test_torch_model.py``); ``tokens`` exactly.
* gradients: every leaf within 1e-5 x the global gradient norm (XLA and
  PyTorch sum in other orders; the largest leaves carry most of the
  norm).
* AdamW: the update divides by ``sqrt(v) + eps``, so a rounding step in
  a tiny gradient moves the update by O(1): parameters after a step are
  compared on the scale of ``lr``, within 1e-3 x lr (f32 moments) and
  1e-2 x lr (bf16 moments, which round the same f32 values; one moment
  near a rounding tie may go the other way), plus 1e-6 relative to the
  parameter.  After a model's train step, elements whose clipped
  gradient is within 1e3 x eps of 0 are held to 2 x lr (``_hold_step``).
* ``lr_at`` within 1e-6 relative: both evaluate the same float32
  formula, through two libraries' float32 ``cos`` (measured: 2.1e-7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import optim as j_optim  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import forward_only  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import VISION_DIM  # noqa: E402
from repro_torch.training import checkpoint as t_ckpt  # noqa: E402
from repro_torch.training import optim as t_optim  # noqa: E402
from repro_torch.training import train_loop as t_loop  # noqa: E402

_CACHE = {}


def _models(name):
    if name not in _CACHE:
        jc = dataclasses.replace(j_get_config(name), dtype="float32")
        tc = dataclasses.replace(get_config(name), dtype="float32")
        jm = JModel(jc)
        jp = jm.init(jax.random.key(1))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
        _CACHE[name] = (jm, jp, Model(tc, device="cpu"), tp)
    return _CACHE[name]


def _batch(cfg, B=2, S=16, seed=4):
    """Seeded tokens and next-token targets, a few targets masked (-1);
    frames for an encoder-decoder, patches for a VLM."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :3] = -1
    if cfg.is_encdec:
        batch["frames"] = rng.randn(B, cfg.enc_seq, cfg.enc_d_model).astype(
            np.float32)
    if cfg.n_patches:
        batch["patch_embeds"] = rng.randn(B, cfg.n_patches,
                                          VISION_DIM).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


FWD_TOL = {"xlstm_350m-smoke": 5e-4}


@pytest.mark.parametrize("name", [
    "qwen3_4b-smoke", "granite_moe_3b_a800m-smoke", "paligemma_3b-smoke",
    "whisper_medium-smoke", "recurrentgemma_9b-smoke", "xlstm_350m-smoke"])
def test_forward_train_matches_jax(name):
    jm, jp, tm, tp = _models(name)
    batch = _batch(tm.cfg)
    jl, jmet = jm.forward_train(jp, _j(batch), remat=False)
    with torch.no_grad():
        tl, tmet = tm.forward_train(tp, _t(batch), remat=False)
    atol = FWD_TOL.get(name, 1e-4)
    assert abs(float(tl) - float(jl)) <= atol
    for k in ("ce", "aux", "zloss"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= atol, k
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 2 * 16 - 3
    if tm.cfg.n_experts:
        assert float(tmet["aux"]) > 0


def _grads(tm, tp, batch, remat=True):
    flat = list(t_optim.leaves(tp))
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, _ = tm.forward_train(tp, _t(batch), remat=remat)
        return loss.detach(), torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)


@pytest.mark.parametrize("name", ["qwen3_4b-smoke",
                                  "granite_moe_3b_a800m-smoke",
                                  "whisper_medium-smoke"])
def test_gradients_match_jax(name):
    """``torch.autograd`` through the checkpointed layers against
    ``jax.value_and_grad`` of the reference's ``forward_train``: every leaf
    within 1e-5 x the global norm."""
    jm, jp, tm, tp = _models(name)
    batch = _batch(tm.cfg)
    jl, jg = jax.value_and_grad(
        lambda p: jm.forward_train(p, _j(batch), remat=True)[0])(jp)
    want = list(t_optim.leaves(params_from_numpy(
        tm.cfg, jax.tree.map(np.asarray, jg))))
    tl, got = _grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= 1e-4
    gnorm = float(t_optim.global_norm(want))
    assert gnorm > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5 * gnorm,
                                   rtol=0)
    assert float(t_optim.global_norm(got)) == pytest.approx(gnorm, rel=1e-5)


def test_remat_equals_no_remat():
    _, _, tm, tp = _models("qwen3_4b-smoke")
    batch = _batch(tm.cfg)
    l1, g1 = _grads(tm, tp, batch, remat=True)
    l0, g0 = _grads(tm, tp, batch, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_jax(schedule):
    for warm, total in ((10, 100), (0, 37), (100, 50)):
        kw = dict(lr=3e-3, warmup_steps=warm, total_steps=total,
                  schedule=schedule, wsd_decay_frac=0.2)
        jc, tc = j_optim.OptimizerConfig(**kw), t_optim.OptimizerConfig(**kw)
        for step in (0, 1, 5, 10, 11, 36, 37, 50, 79, 80, 81, 99, 100, 120):
            assert t_optim.lr_at(tc, step) == pytest.approx(
                float(j_optim.lr_at(jc, step)), rel=1e-6, abs=1e-12), step


def _opt_tree(rng):
    """A parameter tree with matrices (decayed) and vectors (not)."""
    return {"a": {"w": rng.randn(6, 5).astype(np.float32)},
            "b": [{"scale": rng.randn(5).astype(np.float32)},
                  {"w": rng.randn(3, 4, 2).astype(np.float32) * 3}]}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return t_optim.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _adamw_both(cfg_kw, grads_seq, seed=0):
    rng = np.random.RandomState(seed)
    p0 = _opt_tree(rng)
    jc = j_optim.OptimizerConfig(**cfg_kw)
    tc = t_optim.OptimizerConfig(**cfg_kw)
    jp, tp = _jtree(p0), _ttree(p0)
    js, ts = j_optim.adamw_init(jp, jc), t_optim.adamw_init(tp, tc)
    out = []
    for g in grads_seq:
        jp, js, jm = j_optim.adamw_update(_jtree(g), js, jp, jc)
        tp, ts, tm = t_optim.adamw_update(_ttree(g), ts, tp, tc)
        # the port updates in place: keep this step's values
        snap = t_optim.tree_map(torch.clone, (tp, ts.m, ts.v))
        out.append((jp, js, jm, snap[0],
                    t_optim.AdamWState(ts.step, snap[1], snap[2]), tm))
    return p0, out


def _leaf_pairs(jtree, ttree):
    return zip(jax.tree.leaves(jtree), t_optim.leaves(ttree))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments):
    """Three steps, leaf for leaf: parameters within (1e-3 | 1e-2) x lr
    + 1e-6 |p|, moments within one rounding of their dtype."""
    rng = np.random.RandomState(1)
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32)
                          * 0.3, _opt_tree(np.random.RandomState(0)))
             for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
              moment_dtype=moments)
    _, out = _adamw_both(kw, grads)
    scale = 1e-3 if moments == "float32" else 1e-2
    for step, (jp, js, jm, tp, ts, tm) in enumerate(out, start=1):
        lr = float(jm["lr"])
        assert tm["lr"] == pytest.approx(lr, rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert ts.step == int(js.step) == step
        for a, b in _leaf_pairs(jp, tp):
            np.testing.assert_allclose(_np(b), _np(a),
                                       atol=scale * lr, rtol=1e-6)
        for name in ("m", "v"):
            for a, b in _leaf_pairs(getattr(js, name), getattr(ts, name)):
                assert str(b.dtype) == f"torch.{moments}"
                np.testing.assert_allclose(
                    _np(b), _np(a), rtol=1e-5 if moments == "float32"
                    else 2 ** -7, atol=1e-12)


def test_clipping_matches_jax():
    """A gradient of norm ~150 is scaled to norm 1 (the update then equals
    the reference's); one of norm < 1 is not scaled."""
    for mult, clip in ((50.0, 1.0), (0.01, 1.0), (50.0, 0.0)):
        rng = np.random.RandomState(2)
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32)
                         * mult, _opt_tree(np.random.RandomState(0)))
        kw = dict(lr=1e-2, warmup_steps=0, schedule="constant",
                  grad_clip=clip, weight_decay=0.0)
        _, [(jp, js, jm, tp, ts, tm)] = _adamw_both(kw, [g])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for a, b in _leaf_pairs(jp, tp):
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-6)
        for a, b in _leaf_pairs(js.m, ts.m):
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-9, rtol=1e-5)
    # clip 1 at gradient norm ~150: the first moment is 0.1 x g / gnorm
    m = np.concatenate([_np(x).ravel() for x in t_optim.leaves(ts.m)])
    assert 0 < np.linalg.norm(m) < 1e6


def test_decay_mask():
    """With zero gradients only leaves of ndim >= 2 decay, by lr x wd x p;
    vectors stay as they were, as in the reference."""
    zeros = jax.tree.map(np.zeros_like, _opt_tree(np.random.RandomState(0)))
    kw = dict(lr=0.5, warmup_steps=0, schedule="constant", grad_clip=0.0,
              weight_decay=0.1)
    p0, [(jp, _, _, tp, _, _)] = _adamw_both(kw, [zeros])
    assert np.array_equal(_np(tp["b"][0]["scale"]), p0["b"][0]["scale"])
    for want0, got in ((p0["a"]["w"], tp["a"]["w"]),
                       (p0["b"][1]["w"], tp["b"][1]["w"])):
        np.testing.assert_allclose(_np(got), want0 * (1 - 0.5 * 0.1),
                                   rtol=1e-6)
    for a, b in _leaf_pairs(jp, tp):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=0)


def _per_layer_mask(params):
    """The reference's decay rule (``ndim >= 2``) per layer: its
    scan-stacked leaves (under ``units`` and ``encoder/layers``) carry one
    stacking axis, which its own ``_decay_mask`` counts (Queue C.13)."""
    def mask(path, p):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        stacked = keys[0] == "units" or keys[:2] == ["encoder", "layers"]
        return p.ndim - int(stacked) >= 2
    return jax.tree_util.tree_map_with_path(mask, params)


#: an Adam step moves a parameter by lr x m / (sqrt(v) + eps): where the
#: clipped gradient is within 1e3 x eps of 0 the update's size (and sign)
#: rests on its last bits, so there two steps part by up to 2 lr; above it
#: they agree within 1e-3 lr
ILL_CONDITIONED = 1e3 * 1e-8


def _hold_step(want, got, m_want, lr, b1=0.9):
    """Parameters after one step, leaf for leaf, on the scale of ``lr``:
    within 1e-3 x lr + 1e-6 |p| where the clipped gradient
    (``m_want / (1 - b1)``, the first moment after step 1) is at least
    ``ILL_CONDITIONED``, within 2.01 x lr elsewhere.  Returns the count of
    elements held to the wide bound."""
    wide = 0
    for a, b, m in zip(t_optim.leaves(want), t_optim.leaves(got),
                       t_optim.leaves(m_want)):
        a, b, m = _np(a), _np(b), _np(m)
        ok = np.abs(m) / (1 - b1) >= ILL_CONDITIONED
        wide += int((~ok).sum())
        np.testing.assert_allclose(b[ok], a[ok], atol=1e-3 * lr, rtol=1e-6)
        assert np.all(np.abs(b - a) <= 2.01 * lr)
    return wide


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, monkeypatch):
    """One ``make_train_step`` step on qwen3_4b-smoke (batch 4 x 16), unsplit
    and in two micro-batches, against the reference's (its decay mask
    taken per layer, ``_per_layer_mask``): loss, gradient norm, and the
    parameters after the step (``_hold_step``)."""
    monkeypatch.setattr(j_optim, "_decay_mask", _per_layer_mask)
    jm, jp, tm, _ = _models("qwen3_4b-smoke")
    tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp))
    batch = _batch(tm.cfg, B=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jc, tc = j_optim.OptimizerConfig(**kw), t_optim.OptimizerConfig(**kw)
    jstep = j_loop.make_train_step(jm, jc, remat=True, accum_steps=accum)
    tstep = t_loop.make_train_step(tm, tc, remat=True, accum_steps=accum,
                                   device="cpu")
    jp2, js, jmet = jstep(jp, j_optim.adamw_init(jp, jc), _j(batch))
    tp2, ts, tmet = tstep(tp, t_optim.adamw_init(tp, tc), batch)
    assert tp2 is tp and ts.step == 1
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-4
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    lr = tmet["lr"]
    assert lr == pytest.approx(float(jmet["lr"]), rel=1e-6)

    def conv(tree):
        return params_from_numpy(tm.cfg, jax.tree.map(np.asarray, tree))
    n = sum(p.numel() for p in t_optim.leaves(tp2))
    # most elements are held to the tight bound (measured: ~4% are not)
    assert _hold_step(conv(jp2), tp2, conv(js.m), lr) < 0.1 * n
    assert not any(p.requires_grad for p in t_optim.leaves(tp2))


def test_reference_decays_stacked_norms():
    """Queue C.13: the reference's own mask decays the norm scales of its
    scanned layers (stacking makes them 2-D), not those of its final norm;
    the port decays no 1-D leaf.  A step with zero gradients shows it."""
    jm, jp, tm, _ = _models("qwen3_4b-smoke")
    kw = dict(lr=0.5, warmup_steps=0, schedule="constant", grad_clip=0.0)
    jc, tc = j_optim.OptimizerConfig(**kw), t_optim.OptimizerConfig(**kw)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jp2, _, _ = j_optim.adamw_update(zeros, j_optim.adamw_init(jp, jc), jp,
                                     jc)
    tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp))
    tp2, _, _ = t_optim.adamw_update(t_optim.tree_map(torch.zeros_like, tp),
                                     t_optim.adamw_init(tp, tc), tp, tc)
    decayed = 1 - 0.5 * 0.1
    np.testing.assert_allclose(
        np.asarray(jp2["units"][0]["norm1"]["scale"]), decayed, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jp2["final_norm"]["scale"]), 1)
    for layer in tp2["layers"]:
        assert bool((layer["norm1"]["scale"] == 1).all())
        assert bool((layer["attn"]["q_norm"]["scale"] == 1).all())


def test_accumulated_step_equals_unsplit():
    """Two micro-batches of 2 give the gradient of the batch of 4 when
    every target counts (each micro-batch's CE then has the same
    denominator): loss within 1e-5, parameters as ``_hold_step``."""
    _, jp, tm, _ = _models("qwen3_4b-smoke")
    batch = _batch(tm.cfg, B=4, seed=8)
    batch["targets"] = np.abs(batch["targets"])
    tc = t_optim.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    outs = []
    for accum in (1, 2):
        tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp))
        step = t_loop.make_train_step(tm, tc, accum_steps=accum,
                                      device="cpu")
        outs.append(step(tp, t_optim.adamw_init(tp, tc), batch))
    (p1, s1, m1), (p2, _, m2) = outs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-5)
    n = sum(p.numel() for p in t_optim.leaves(p1))
    assert _hold_step(p1, p2, s1.m, m1["lr"]) < 0.1 * n


def test_eval_step_and_train_loop(tmp_path, monkeypatch):
    """``make_eval_step`` is forward_train without a graph; ``train_loop``
    trains, logs and checkpoints on the CPU when asked; the default device
    needs a card."""
    _, _, tm, tp = _models("qwen3_4b-smoke")
    batch = _batch(tm.cfg)
    ev = t_loop.make_eval_step(tm, device="cpu")(tp, batch)
    loss, _ = tm.forward_train(tp, _t(batch), remat=False)
    assert float(ev["loss"]) == pytest.approx(float(loss), abs=1e-6)
    assert not ev["loss"].requires_grad
    data = t_pipe.DataIterator(t_pipe.DataConfig(
        vocab_size=tm.cfg.vocab_size, seq_len=16, global_batch=2))
    logs = []
    out = t_loop.train_loop(
        tm, t_optim.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4),
        data, n_steps=4, log_every=2, checkpoint_dir=str(tmp_path),
        checkpoint_every=2, log_fn=logs.append, device="cpu")
    assert [h["step"] for h in out["history"]] == [2, 4] and len(logs) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_loop.make_train_step(tm, t_optim.OptimizerConfig())


def test_checkpoint_roundtrip(tmp_path):
    """Parameters (bf16 and f32 leaves) and the AdamW state go through the
    reference's format -- npz + JSON manifest + ``latest``, bf16 stored as
    f32 -- and come back bit for bit into fresh tensors."""
    cfg = dataclasses.replace(get_config("qwen3_4b-smoke"), n_layers=1,
                              block_pattern=("attn",))
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(3))
    params["final_norm"]["scale"] = params["final_norm"]["scale"].float()
    opt = t_optim.adamw_init(params, t_optim.OptimizerConfig())
    opt = t_optim.AdamWState(5, t_optim.tree_map(torch.randn_like, opt.m),
                             opt.v)
    d = str(tmp_path / "ck")
    t_ckpt.save_checkpoint(d, 7, params, opt, extra={"data": {"step": 7}})
    assert t_ckpt.latest_step(d) == 7
    import json
    with open(f"{d}/step_00000007.json") as f:
        man = json.load(f)
    assert man["step"] == 7 and man["extra"] == {"data": {"step": 7}}
    assert man["arrays"]["params/embed/w"] == {
        "dtype": "bfloat16", "shape": list(params["embed"]["w"].shape)}
    assert man["arrays"]["opt/.step"] == {"dtype": "int32", "shape": []}
    assert "params/layers/0/attn/wq/w" in man["arrays"]
    with np.load(f"{d}/step_00000007.npz") as z:
        assert z["params__embed__w"].dtype == np.float32
        assert set(z.files) == {k.replace("/", "__") for k in man["arrays"]}
    like = t_optim.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                  device="meta"), params)
    olike = t_optim.AdamWState(0, t_optim.tree_map(torch.empty_like, opt.m),
                               opt.v)
    step, p2, o2 = t_ckpt.restore_checkpoint(d, None, like, olike,
                                             device="cpu")
    assert step == 7 and o2.step == 5
    for a, b in zip(t_optim.leaves((params, opt.m, opt.v)),
                    t_optim.leaves((p2, o2.m, o2.v))):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_checkpoint(str(tmp_path / "none"), None, like)


@pytest.mark.parametrize("world", [1, 2])
def test_data_iterator_matches_reference(world):
    """Batches byte-identical to the reference's for 3 steps on every
    rank, and ``state``/``restore`` resume the stream."""
    cfg_kw = dict(vocab_size=1000, seq_len=24, global_batch=4, seed=3)
    for rank in range(world):
        j_it = j_pipe.DataIterator(j_pipe.DataConfig(**cfg_kw), rank, world)
        t_it = t_pipe.DataIterator(t_pipe.DataConfig(**cfg_kw), rank, world)
        for _ in range(3):
            a, b = next(j_it), next(t_it)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
        state = t_it.state()
        assert state == j_it.state() == {"step": 3}
        nxt = next(t_it)
        t_it.restore(state)
        assert next(t_it)["tokens"].tobytes() == nxt["tokens"].tobytes()


def test_forward_only_guard():
    """The guard every kernel wrapper runs on CUDA inputs (the kernels
    have no backward): it raises for a tensor that requires grad."""
    x = torch.zeros(3)
    forward_only("k", x, x)
    with pytest.raises(RuntimeError, match="no backward"):
        forward_only("k", x, torch.zeros(3, requires_grad=True))


def test_launcher_single_device(tmp_path, monkeypatch):
    """The launcher's single-device path on the CPU, with accumulation and
    checkpoints; ``--dry-run`` writes the ``train_4k`` dry-run record
    (on ``meta`` tensors, nothing on a device)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch
    out = launch.main(["--arch", "qwen3_4b", "--steps", "2", "--seq", "8",
                       "--batch", "2", "--accum", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    rec = launch.main(["--arch", "qwen3_4b", "--dry-run"])
    assert rec["ok"] and (rec["shape"], rec["mesh"], rec["kind"]) == \
        ("train_4k", "16x16", "train")
    assert (tmp_path / "dryrun" / "qwen3_4b__train_4k__16x16.json").exists()
