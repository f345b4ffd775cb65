"""The frozen traffic generator against the program's, and the requests
a traffic file makes from a seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from servebench import traffic_gen

HERE = Path(__file__).resolve().parent
TRAFFIC = HERE.parent / "traffic"


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_agent_family_equals_the_programs_generator(seed):
    pytest.importorskip("torch")
    from repro_torch.workloads.traces import make_trace
    fam = json.loads((TRAFFIC / "agent.json").read_text())["family"]
    got = traffic_gen.family_trace("agent", fam, 20.0, 30.0, seed)
    want = make_trace("agent", 20.0, 30.0, seed)
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert (g.arrival, g.blocks, g.output_len) == \
            (w.arrival, w.blocks, w.output_len)


def test_block_tokens_depend_on_seed_and_block_only():
    a = traffic_gen.block_tokens(np.array([1, 2, 3]), 64, 5, 152064)
    b = traffic_gen.block_tokens(np.array([3, 1]), 64, 5, 152064)
    assert a.shape == (192,) and a.min() >= 0 and a.max() < 152064
    assert (a[128:] == b[:64]).all() and (a[:64] == b[64:]).all()
    c = traffic_gen.block_tokens(np.array([1]), 64, 6, 152064)
    assert (c != a[:64]).any()


@pytest.mark.parametrize("name", ["agent", "agent_closed", "agent_unshared"])
def test_every_seed_gets_the_same_sizes_and_arrivals(name):
    tr = json.loads((TRAFFIC / f"{name}.json").read_text())
    w1 = traffic_gen.make_workload(tr, 11, 152064, 2048)
    w2 = traffic_gen.make_workload(tr, 2**31 + 99, 152064, 2048)
    shape = [[(a, len(t), n) for a, t, n in w.requests] for w in (w1, w2)]
    assert shape[0] == shape[1]
    assert any((t1 != t2).any() for (_, t1, _), (_, t2, _)
               in zip(w1.requests, w2.requests))
    assert all(len(t) + n <= 2046 for _, t, n in w1.requests)
    assert (w1.clients > 0) == (tr["loop"] == "closed")


def test_unshared_prompts_share_no_block_and_shared_ones_do():
    def blocks(name):
        tr = json.loads((TRAFFIC / f"{name}.json").read_text())
        w = traffic_gen.make_workload(tr, 3, 152064, 2048)
        seen, repeats = set(), 0
        for _, t, _ in w.requests[:300]:
            for j in range(0, len(t), 64):
                key = t[j:j + 64].tobytes()
                repeats += key in seen
                seen.add(key)
        return repeats
    assert blocks("agent_unshared") == 0
    assert blocks("agent") > 1000
