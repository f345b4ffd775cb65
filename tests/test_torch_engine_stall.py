"""A request stalled part-way through its prefill keeps its cache.

The engine admits nothing while no slot is free, even when the head of
the queue already holds one (ROADMAP Queue C.5, kept from the
reference): a request whose prompt spans several chunks and that took
the last free slot waits, while the running slots decode.  The decode
step runs every slot and writes each at its position; the stalled slot's
position is its previous occupant's (0 on a fresh engine), a row the
stalled request may already have prefilled.  The reference overwrites
that row (Queue C.17); the port puts the stalled slot back after the
step.  Scenario, on the smoke config in float32 on the CPU: two slots,
16-token chunks; A (20 tokens, 10 out) runs, then B (48 tokens, three
chunks) takes the last slot and stalls after its first chunk until A
finishes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving.engine as j_engine_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.core.radix import tokens_to_blocks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import InstanceEngine  # noqa: E402

KW = dict(max_batch=2, max_len=128, chunk_tokens=16, block_size=16)
RNG = np.random.RandomState(7)
A = RNG.randint(4, 500, 20).astype(np.int32)
B = RNG.randint(4, 500, 48).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    name = "qwen3_4b-smoke"
    jc = dataclasses.replace(j_get_config(name), dtype="float32")
    tc = dataclasses.replace(get_config(name), dtype="float32")
    jm = JModel(jc)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp))
    return jm, jp, Model(tc, device="cpu"), tp


def _serve(eng, make_req, with_a):
    """Serve B (after A, when ``with_a``); returns B's last prefill
    logits, the step kinds and B's output tokens."""
    logits = []
    pre = eng._prefill

    def rec(*a):
        out = pre(*a)
        logits.append(np.asarray(out[0] if isinstance(out, tuple) else out,
                                 np.float32))
        return out
    eng._prefill = rec
    kinds = []
    if with_a:
        eng.submit(make_req(0, A, 10), A)
        while not eng.running:
            kinds.append(eng.step()["kind"])
    rb = make_req(1, B, 2)
    eng.submit(rb, B)
    out = None
    while eng.has_work():
        ev = eng.step()
        kinds.append(ev["kind"])
        for seq in ev["finished"]:
            if seq.req is rb:
                out = list(seq.out_tokens)
    return logits[-1].reshape(-1), kinds, out


def _treq(rid, toks, n):
    return Request(rid=rid, arrival=0.0, blocks=(), prompt_len=len(toks),
                   output_len=n)


def _jreq(rid, toks, n):
    return JRequest(rid=rid, arrival=0.0, blocks=(), prompt_len=len(toks),
                    output_len=n)


def test_scenario_stalls_b_between_its_chunks(pair):
    """The scenario does what the module docstring says: B's three chunks
    are split by A's decode steps."""
    _, _, tm, tp = pair
    _, kinds, _ = _serve(InstanceEngine(tm, tp, device="cpu", **KW), _treq,
                         True)
    b_chunks = [i for i, k in enumerate(kinds[2:], 2) if k == "prefill"]
    assert len(b_chunks) == 3
    assert "decode" in kinds[b_chunks[0]:b_chunks[1]]


def test_stalled_prefill_keeps_its_cache(pair):
    """B's first-token logits, output tokens and stored fragment are those
    of B served alone (bit for bit: the same chunks on the CPU)."""
    _, _, tm, tp = pair
    stalled = InstanceEngine(tm, tp, device="cpu", **KW)
    alone = InstanceEngine(tm, tp, device="cpu", **KW)
    ls, _, outs = _serve(stalled, _treq, True)
    la, _, outa = _serve(alone, _treq, False)
    np.testing.assert_array_equal(ls, la)
    assert outs == outa
    key = tuple(tokens_to_blocks(B.tolist(), 16))
    fs = stalled.prefix_store.lookup(key)[1]
    fa = alone.prefix_store.lookup(key)[1]
    for x, y in zip(stalled._frag_views(fs), alone._frag_views(fa)):
        assert torch.equal(x[:48], y[:48])


def test_reference_stalled_prefill_is_overwritten(pair):
    """The reference's B, stalled, does not give its first-token logits
    served alone: its decode steps wrote row 0 of B's slot (Queue C.17).
    The port's B gives the reference's lone logits."""
    jm, jp, tm, tp = pair
    ls, _, _ = _serve(j_engine_mod.InstanceEngine(jm, jp, **KW), _jreq, True)
    la, _, _ = _serve(j_engine_mod.InstanceEngine(jm, jp, **KW), _jreq,
                      False)
    assert np.abs(ls - la).max() > 1e-2
    lt, _, _ = _serve(InstanceEngine(tm, tp, device="cpu", **KW), _treq,
                      True)
    np.testing.assert_allclose(lt, la, atol=1e-4, rtol=0)
