"""The port's serving engine against the JAX package's, on the CPU.

* ``InstanceEngine`` in lockstep: the same submits to both engines, step
  for step, give the same event kinds, prefill chunk sizes, decode batch
  sizes, first-token and finish order and KV$ hit tokens (exact), and the
  same logits (float32, atol 1e-4; a sampled token is compared wherever
  the top-two logit margin exceeds 1e-3, ten times that tolerance).
* ``EngineCluster`` under one fake clock (the ``time`` attribute of both
  engine modules replaced, so every engine step takes the same virtual
  1/128 s): both clusters route every arrival to the same instance and
  report the same hit tokens and virtual first-token / finish times.
* Ports of ``tests/test_engine.py``: the cluster serves every request
  and hits the shared prefix; the engine's chunked, cached path gives the
  plain full forward's greedy tokens; a second serve of one prompt hits
  its prefix and emits the same tokens.
* The recurrent families (``recurrentgemma_9b-smoke``, ``xlstm_350m-smoke``,
  float32) in lockstep with the JAX engine, including hits on a stored
  recurrent state whose prompt has a tail past its last full block: the
  reference runs that tail through the state a second time (ROADMAP
  Queue C.9) and the port gives the reference's tokens.  RecurrentGemma's
  hits and chunks start at 0 or at the smoke window (64) or past it,
  where the reference's ``swa`` cached prefill is right (Queue C.10);
  chunks and a hit below the window, where the port computes the
  reference's full forward instead, are held to JAX's ``Model.prefill``.
  Both clusters also route alike under the fake clock, xLSTM through the
  ``exact_only`` router.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.serving.engine as j_engine_mod  # noqa: E402
import repro_torch.serving.engine as t_engine_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import LMetricPolicy as JLMetricPolicy  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.cluster.metrics import summarize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import LMetricPolicy, Request  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import EngineCluster, InstanceEngine  # noqa: E402

MARGIN = 1e-3


def _pair(dtype, name="qwen3_4b-smoke"):
    jc = dataclasses.replace(j_get_config(name), dtype=dtype)
    tc = dataclasses.replace(get_config(name), dtype=dtype)
    jm = JModel(jc)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
    return jm, jp, Model(tc, device="cpu"), tp


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


def _arrivals(n=8, seed=0, share=True):
    """``tests/test_engine.py::_arrivals``: every other request shares a
    48-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(4, 500, size=48)
    out, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        sfx = rng.randint(4, 500, size=16)
        toks = (np.concatenate([shared, sfx]) if share and i % 2 else
                rng.randint(4, 500, size=64)).astype(np.int32)
        out.append((t, toks, 6))
    return out


def _record(jeng, teng, jm):
    """Capture each step's logits from both engines: the JAX engine's jitted
    prefill returns them; its jitted decode returns only the argmax, so the
    same decode_step is run beside it on the same cache."""
    jlog, tlog = [], []
    jpre, jdec = jeng._prefill, jeng._decode
    jstep = jax.jit(jm.decode_step)

    def j_prefill(params, cache, toks, pos, cache_len, b):
        logits, cache = jpre(params, cache, toks, pos, cache_len, b)
        jlog.append(np.asarray(logits, np.float32))
        return logits, cache

    def j_decode(params, cache, toks, pos):
        jlog.append(np.asarray(jstep(params, toks, pos, cache)[0][:, -1],
                               np.float32))
        return jdec(params, cache, toks, pos)

    tpre, tdec = teng._prefill, teng._decode

    def t_prefill(*a):
        out = tpre(*a)
        tlog.append(out.float().numpy())
        return out

    def t_decode(*a):
        out = tdec(*a)
        tlog.append(out.float().numpy())
        return out

    jeng._prefill, jeng._decode = j_prefill, j_decode
    teng._prefill, teng._decode = t_prefill, t_decode
    return jlog, tlog


def test_instance_engine_lockstep(f32_pair):
    jm, jp, tm, tp = f32_pair
    kw = dict(max_batch=3, max_len=128, chunk_tokens=16, block_size=16)
    jeng = j_engine_mod.InstanceEngine(jm, jp, **kw)
    teng = InstanceEngine(tm, tp, device="cpu", **kw)
    jlog, tlog = _record(jeng, teng, jm)
    rng = np.random.RandomState(1)
    base = rng.randint(4, 500, 40).astype(np.int32)
    # the store hits when a stored prompt's block chain is a prefix of
    # the new prompt's: r1 extends r0's two blocks, r2 is exactly them
    prompts = {0: (0, base),
               2: (1, np.concatenate([base[:32], rng.randint(4, 500, 9)])),
               5: (2, base[:32].copy()),             # full-prompt hit
               6: (3, rng.randint(4, 500, 23).astype(np.int32)),
               9: (4, np.concatenate([base[:16], rng.randint(4, 500, 30)]))}
    jreqs, treqs = {}, {}
    for step in range(200):
        if step in prompts:
            rid, toks = prompts[step]
            out_len = 4 + rid % 3
            jreqs[rid] = JRequest(rid=rid, arrival=0.0, blocks=(),
                                  prompt_len=len(toks), output_len=out_len)
            treqs[rid] = Request(rid=rid, arrival=0.0, blocks=(),
                                 prompt_len=len(toks), output_len=out_len)
            jeng.submit(jreqs[rid], toks)
            teng.submit(treqs[rid], toks)
        if not jeng.has_work() and step > max(prompts):
            break
        jev, tev = jeng.step(), teng.step()
        for key in ("kind", "prefill_tokens", "decode_bs"):
            assert jev[key] == tev[key], (step, key)
        for key in ("first", "finished"):
            assert [s.req.rid for s in jev[key]] == \
                [s.req.rid for s in tev[key]], (step, key)
        assert teng.has_work() == jeng.has_work()
    assert not teng.has_work() and len(jlog) == len(tlog) >= 20
    for jl, tl in zip(jlog, tlog):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    for rid in prompts.values():
        rid = rid[0]
        assert treqs[rid].hit_tokens == jreqs[rid].hit_tokens
    assert treqs[1].hit_tokens == 32 and treqs[2].hit_tokens == 31
    assert treqs[4].hit_tokens == 0
    # sampled tokens agree wherever the decision is not a near tie
    for jl, tl in zip(jlog, tlog):
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MARGIN
        np.testing.assert_array_equal(tl.argmax(-1)[clear],
                                      jl.argmax(-1)[clear])


class _Clock:
    """One fake clock for both engine modules: every call advances 1/128 s
    (exact in binary, so both runs see identical step walls)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1 / 128
        return self.t


def test_cluster_routing_matches_jax_under_fake_clock(bf16_pair,
                                                      monkeypatch):
    jm, jp, tm, tp = bf16_pair
    clock = _Clock()
    monkeypatch.setattr(j_engine_mod, "time", clock)
    monkeypatch.setattr(t_engine_mod, "time", clock)
    kw = dict(block_size=16, max_batch=4, max_len=160, chunk_tokens=64)
    arrivals = _arrivals(n=12, seed=3)
    jc = j_engine_mod.EngineCluster(3, jm, jp, JLMetricPolicy(), **kw)
    clock.t = 0.0
    jdone = jc.run(arrivals)
    tc = EngineCluster(3, tm, tp, LMetricPolicy(), device="cpu", **kw)
    clock.t = 0.0
    tdone = tc.run(arrivals)
    assert len(tdone) == len(jdone) == 12
    jby = {r.rid: r for r in jdone}
    for r in tdone:
        j = jby[r.rid]
        assert (r.sched_to, r.hit_tokens, r.prompt_len) == \
            (j.sched_to, j.hit_tokens, j.prompt_len), r.rid
        assert r.t_first_token == j.t_first_token
        assert r.t_finish == j.t_finish
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert len({r.sched_to for r in tdone}) > 1
    assert any(r.hit_tokens >= 48 for r in tdone)


def test_cluster_serves_all_and_hits_prefix(bf16_pair):
    """Port of ``test_engine.py::test_cluster_serves_all_and_hits_prefix``."""
    _, _, m, params = bf16_pair
    cluster = EngineCluster(2, m, params, LMetricPolicy(), block_size=16,
                            device="cpu", max_batch=4, max_len=160,
                            chunk_tokens=64)
    done = cluster.run(_arrivals())
    s = summarize(done)
    assert s["n"] == 8
    assert s["ttft_mean"] > 0 and s["tpot_mean"] > 0
    hits = [r.hit_tokens for r in done]
    assert any(h >= 48 // 16 * 16 for h in hits), \
        "shared prefix must produce cache hits"


def test_engine_outputs_match_unchunked_reference(bf16_pair):
    """Port of ``test_engine.py::test_engine_outputs_match_unchunked_reference``:
    greedy decode through the engine (16-token chunks) == a plain full
    prefill of the prompt, then greedy decode steps on one cache."""
    _, _, m, params = bf16_pair
    rng = np.random.RandomState(3)
    toks = rng.randint(4, 500, size=40).astype(np.int32)
    n_new = 5
    cache = m.init_cache(1, 128)
    l, cache = m.prefill_cached(params, torch.from_numpy(toks[None]),
                                torch.arange(40)[None], cache, [0])
    ref_out = [int(l[0, -1].argmax())]
    full, _ = m.prefill(params, torch.from_numpy(toks[None]))
    assert int(full[0, -1].argmax()) == ref_out[0]
    cur, p = ref_out[0], 40
    for _ in range(n_new - 1):
        lg, cache = m.decode_step(params, torch.tensor([[cur]]),
                                  torch.tensor([p]), cache)
        cur = int(lg[0, -1].argmax())
        ref_out.append(cur)
        p += 1
    eng = InstanceEngine(m, params, max_batch=2, max_len=128,
                         chunk_tokens=16, block_size=16, device="cpu")
    req = Request(rid=0, arrival=0.0, blocks=(), prompt_len=40,
                  output_len=n_new)
    eng.submit(req, toks)
    outs = None
    for _ in range(100):
        ev = eng.step()
        if ev["finished"]:
            outs = ev["finished"][0].out_tokens
            break
    assert outs == ref_out


def test_prefix_hit_preserves_output(bf16_pair):
    """Port of ``test_engine.py::test_prefix_hit_preserves_output``."""
    _, _, m, params = bf16_pair
    rng = np.random.RandomState(5)
    toks = rng.randint(4, 500, size=64).astype(np.int32)
    eng = InstanceEngine(m, params, max_batch=2, max_len=128,
                         chunk_tokens=32, block_size=16, device="cpu")

    def serve():
        req = Request(rid=0, arrival=0.0, blocks=(), prompt_len=64,
                      output_len=4)
        eng.submit(req, toks)
        for _ in range(100):
            ev = eng.step()
            if ev["finished"]:
                return ev["finished"][0], ev["finished"][0].out_tokens
        raise AssertionError("did not finish")

    seq1, out1 = serve()
    seq2, out2 = serve()
    assert seq1.req.hit_tokens == 0
    assert seq2.req.hit_tokens >= 48, "second serve must hit the prefix"
    assert out1 == out2, "cache-hit serve must be exact"
    # stored fragments are host copies, never views of a live slot
    cache_mem = {t.untyped_storage().data_ptr() for c in eng.cache
                 for t in c.values()}
    for frag, _ in eng.prefix_store._store.values():
        assert frag.untyped_storage().data_ptr() not in cache_mem


def test_fragment_survives_reuse_of_its_slot(bf16_pair):
    """A fragment stays valid after its slot serves other requests: the
    third serve of a prompt hits it and still emits the first serve's
    tokens.  (Two slots: with one, the reference's admission stalls a
    multi-chunk prefill that holds the last slot, and the port keeps
    that behaviour.)"""
    _, _, m, params = bf16_pair
    rng = np.random.RandomState(9)
    toks = rng.randint(4, 500, size=48).astype(np.int32)
    eng = InstanceEngine(m, params, max_batch=2, max_len=128,
                         chunk_tokens=32, block_size=16, device="cpu")

    def serve(prompt):
        req = Request(rid=0, arrival=0.0, blocks=(), prompt_len=len(prompt),
                      output_len=3)
        eng.submit(req, prompt)
        while eng.has_work():
            ev = eng.step()
        return req, ev["finished"][0].out_tokens

    r1, out1 = serve(toks)                                 # slot 0
    serve(rng.randint(4, 500, size=70).astype(np.int32))   # slot 1
    serve(rng.randint(4, 500, size=70).astype(np.int32))   # slot 0 again
    r3, out3 = serve(toks)
    assert r1.hit_tokens == 0 and r3.hit_tokens == 47
    assert out3 == out1


def test_engine_device_must_match_model(bf16_pair):
    _, _, m, params = bf16_pair
    with pytest.raises(ValueError):
        InstanceEngine(m, params, device="meta")


# ---------------------------------------------------------------------------
# the recurrent families
# ---------------------------------------------------------------------------
_RPAIRS = {}


def _rpair(name):
    if name not in _RPAIRS:
        _RPAIRS[name] = _pair("float32", name)
    return _RPAIRS[name]


def _lockstep(jeng, teng, jm, prompts, atol):
    """Submit ``prompts`` ({step: (rid, tokens)}) to both engines and step
    them together; returns the two request dicts after both drain."""
    jlog, tlog = _record(jeng, teng, jm)
    jreqs, treqs = {}, {}
    for step in range(400):
        if step in prompts:
            rid, toks = prompts[step]
            out_len = 4 + rid % 3
            jreqs[rid] = JRequest(rid=rid, arrival=0.0, blocks=(),
                                  prompt_len=len(toks), output_len=out_len)
            treqs[rid] = Request(rid=rid, arrival=0.0, blocks=(),
                                 prompt_len=len(toks), output_len=out_len)
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
    assert not teng.has_work() and len(jlog) == len(tlog) >= 12
    for jl, tl in zip(jlog, tlog):
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 10 * atol
        np.testing.assert_array_equal(tl.argmax(-1)[clear],
                                      jl.argmax(-1)[clear])
    for rid in treqs:
        assert treqs[rid].hit_tokens == jreqs[rid].hit_tokens, rid
    return jreqs, treqs


#: logits tolerance of the lockstep, as tests/test_torch_model.py's REC_TOL
LOCK_TOL = {"recurrentgemma_9b-smoke": 1e-4, "xlstm_350m-smoke": 5e-4}


def _recurrent_prompts(name):
    rng = np.random.RandomState(4)
    base = rng.randint(4, 500, 70).astype(np.int32)
    if name.startswith("recurrentgemma"):
        # hits at 64 tokens (= W): an extension of the 70-token prompt,
        # then the same prompt again (its 6-token tail counted twice)
        return {0: (0, base),
                3: (1, np.concatenate([base, rng.randint(4, 500, 30)])),
                6: (2, base.copy()),
                8: (3, rng.randint(4, 500, 40).astype(np.int32)),
                11: (4, np.concatenate([base[:64], rng.randint(4, 500,
                                                                 20)]))}
    short = base[:48].copy()
    # Motivation's cases: a 48-token prompt served twice (47 hit tokens,
    # the last token counted twice), a 53-token prompt then that prompt
    # + 20 (hit 48, tail of 5 counted twice), a 48-token prompt + 20
    # (an exact hit)
    p53 = rng.randint(4, 500, 53).astype(np.int32)
    return {0: (0, short), 4: (1, short.copy()),
            7: (2, p53), 12: (3, np.concatenate([p53, rng.randint(
                4, 500, 20)])),
            15: (4, np.concatenate([short, rng.randint(4, 500, 20)]))}


@pytest.mark.parametrize("name", list(LOCK_TOL))
def test_recurrent_engine_lockstep(name):
    jm, jp, tm, tp = _rpair(name)
    kw = dict(max_batch=3, max_len=128, chunk_tokens=64, block_size=16)
    jeng = j_engine_mod.InstanceEngine(jm, jp, **kw)
    teng = InstanceEngine(tm, tp, device="cpu", **kw)
    finished = {}
    for eng, store in ((jeng, "j"), (teng, "t")):
        step = eng.step

        def logged(step=step, store=store):
            ev = step()
            for q in ev["finished"]:
                finished[(store, q.req.rid)] = list(q.out_tokens)
            return ev
        eng.step = logged
    prompts = _recurrent_prompts(name)
    jreqs, treqs = _lockstep(jeng, teng, jm, prompts, LOCK_TOL[name])
    for rid in treqs:
        assert finished[("t", rid)] == finished[("j", rid)], rid
    hits = {rid: treqs[rid].hit_tokens for rid in treqs}
    if name.startswith("recurrentgemma"):
        assert hits == {0: 0, 1: 64, 2: 64, 3: 0, 4: 64}
    else:
        assert hits == {0: 0, 1: 47, 2: 0, 3: 48, 4: 48}


@pytest.mark.parametrize("name", list(LOCK_TOL))
def test_recurrent_cluster_matches_jax_under_fake_clock(name, monkeypatch):
    """Both clusters route every arrival alike and report the same hits
    and virtual times; xLSTM has no KV block, so both routers run
    ``exact_only``."""
    jm, jp, tm, tp = _rpair(name)
    clock = _Clock()
    monkeypatch.setattr(j_engine_mod, "time", clock)
    monkeypatch.setattr(t_engine_mod, "time", clock)
    kw = dict(block_size=16, max_batch=4, max_len=128, chunk_tokens=64)
    arrivals = _arrivals(n=10, seed=5)
    jc = j_engine_mod.EngineCluster(3, jm, jp, JLMetricPolicy(), **kw)
    clock.t = 0.0
    jdone = jc.run(arrivals)
    tc = EngineCluster(3, tm, tp, LMetricPolicy(), device="cpu", **kw)
    clock.t = 0.0
    tdone = tc.run(arrivals)
    assert tc.router.factory.exact_only == jc.router.factory.exact_only \
        == name.startswith("xlstm")
    assert len(tdone) == len(jdone) == 10
    jby = {r.rid: r for r in jdone}
    for r in tdone:
        j = jby[r.rid]
        assert (r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish) == \
            (j.sched_to, j.hit_tokens, j.t_first_token, j.t_finish), r.rid


def test_recurrentgemma_engine_below_window_matches_jax_full_forward():
    """The regime the lockstep leaves out: chunks and a hit at 0 <
    cache_len < W (the smoke window is 64), where the reference's engine
    reads ring slots it never wrote (ROADMAP Queue C.10) and the port
    computes the reference's full forward instead.  Each request's
    first-token logits and every decode step's (the ring wraps at 64)
    match JAX's ``Model.prefill`` over the same tokens, and the greedy
    tokens are the full forward's."""
    jm, jp, tm, tp = _rpair("recurrentgemma_9b-smoke")
    atol = LOCK_TOL["recurrentgemma_9b-smoke"]
    W = tm.cfg.window_size
    eng = InstanceEngine(tm, tp, device="cpu", max_batch=2, max_len=128,
                         chunk_tokens=24, block_size=16)
    rng = np.random.RandomState(6)
    base = rng.randint(4, 500, 32).astype(np.int32)
    ext = np.concatenate([base, rng.randint(4, 500, 30)]).astype(np.int32)
    starts, logs = [], []
    pre, dec = eng._prefill, eng._decode

    def t_prefill(tokens, start, b):
        out = pre(tokens, start, b)
        starts.append(start)
        logs.append(out[0])
        return out

    def t_decode(tokens, pos):
        out = dec(tokens, pos)
        logs.append(out[next(iter(eng.running))])
        return out

    eng._prefill, eng._decode = t_prefill, t_decode
    for rid, prompt, out_len, hit in ((0, base, 3, 0), (1, ext, 5, 32)):
        req = Request(rid=rid, arrival=0.0, blocks=(),
                      prompt_len=len(prompt), output_len=out_len)
        eng.submit(req, prompt)
        logs.clear()
        while eng.has_work():
            ev = eng.step()
        out = ev["finished"][0].out_tokens
        assert req.hit_tokens == hit
        # the chunk that ends the prompt, then one decode step per token
        got = [logs[-out_len]] + logs[-out_len + 1:]
        toks = list(prompt)
        for j, tl in enumerate(got):
            jl, _ = jm.prefill(jp, jnp.asarray([toks], jnp.int32))
            jl = np.asarray(jl[0, -1], np.float32)
            np.testing.assert_allclose(tl.float().numpy(), jl, atol=atol,
                                       rtol=0)
            top2 = np.sort(jl)[-2:]
            if top2[1] - top2[0] > 10 * atol:
                assert out[j] == int(jl.argmax()), (rid, j)
            toks.append(out[j])
    assert starts == [0, 24, 32, 56] and all(0 < s < W for s in starts[1:])
