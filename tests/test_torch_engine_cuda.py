"""The serving engine's fragment store on the card (``-m cuda``; skipped
without one).  This file imports no JAX, so it runs on a machine with a
card and no JAX; the engine is held against the JAX package's on the CPU
in ``tests/test_torch_engine.py``.

A store on the card and a store in host memory serve the same tokens, and
a store on the card is referenced by its ``PrefixStore`` alone: dropping
the store hands its bytes back.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import InstanceEngine  # noqa: E402

pytestmark = pytest.mark.cuda
KW = dict(max_batch=2, max_len=128, chunk_tokens=32, block_size=16)


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's kernels have no "
                    "CPU mode")
    m = Model(get_config("qwen3_4b-smoke"), device="cuda")
    return m, m.init(torch.Generator(device="cuda").manual_seed(0))


def _prompts():
    """A 40-token prompt, a 48-token one, the first extended (a hit on its
    32 stored rows) and the second again (a full-prompt hit)."""
    rng = np.random.RandomState(11)
    p40 = rng.randint(4, 500, size=40).astype(np.int32)
    p48 = rng.randint(4, 500, size=48).astype(np.int32)
    ext = np.concatenate([p40, rng.randint(4, 500, size=30)]).astype(np.int32)
    return [p40, p48, ext, p48]


def _serve(eng):
    """(hit tokens, served tokens) of each prompt, served in turn."""
    got = []
    for rid, toks in enumerate(_prompts()):
        req = Request(rid=rid, arrival=0.0, blocks=(), prompt_len=len(toks),
                      output_len=4)
        eng.submit(req, toks)
        while eng.has_work():
            for seq in eng.step()["finished"]:
                got.append((req.hit_tokens, list(seq.out_tokens)))
    return got


def test_card_and_host_stores_serve_the_same_tokens(smoke):
    m, params = smoke
    card = InstanceEngine(m, params, device="cuda", **KW)
    host = InstanceEngine(m, params, device="cuda", **KW)
    host.frag_device = torch.device("cpu")
    assert card.frag_device == card.device
    got = _serve(card)
    assert [h for h, _ in got] == [0, 0, 32, 47]
    assert got == _serve(host)
    assert card.device_snapshots == card.snapshots == 4
    assert host.device_snapshots == 0 and host.snapshots == 4
    for eng, dev in ((card, card.device), (host, torch.device("cpu"))):
        assert all(frag.device == dev
                   for frag, _ in eng.prefix_store._store.values())


def test_dropping_the_store_frees_its_bytes(smoke):
    """After ``prefix_store = None`` (as the benchmark frees the engines)
    the card's allocated bytes fall by the store's, each fragment rounded
    as the caching allocator rounds it (512 bytes)."""
    m, params = smoke
    eng = InstanceEngine(m, params, device="cuda", **KW)
    _serve(eng)
    torch.cuda.synchronize()
    want = sum(-(-frag.nbytes // 512) * 512
               for frag, _ in eng.prefix_store._store.values())
    assert want > 0
    gc.collect()
    before = torch.cuda.memory_allocated()
    eng.prefix_store = None
    gc.collect()
    assert before - torch.cuda.memory_allocated() == want
