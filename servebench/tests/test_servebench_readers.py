"""The readers of what the program records about itself
(``queue_wait_p50_ms``, ``fragment_copy_ms``, ``decode_idle_ms``), in a
``--trace 1`` run of the tiny configurations on the CPU: each returns a
number or None and never raises; the recorder's rebuilt token times are
the program's own (``Request.token_times``); and against a program that
keeps no stamps and has no ranges, each reader returns None."""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from servebench import harness  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
NEW = ("queue_wait_p50_ms", "fragment_copy_ms", "decode_idle_ms")


def _traced(monkeypatch, cfg, traffic, cell):
    seen = {}

    class Seen(harness.Context):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["ctx"] = self
    monkeypatch.setattr(harness, "Context", Seen)
    out = harness.run_cell(
        BENCH, cell, 20240601, 2.0, True, "cpu", time.perf_counter(),
        cfg=json.loads((HERE / f"{cfg}.json").read_text()),
        traffic=json.loads((HERE / f"{traffic}.json").read_text()))
    return out, seen["ctx"]


@pytest.mark.parametrize("cfg,traffic,cell,n_new", [
    ("tiny_dense", "tiny_agent", "qwen2_7b.agent", 3),
    ("tiny_moe", "tiny_agent_closed", "qwen3_30b_a3b.agent_closed", 2)])
def test_new_readers_on_a_traced_cpu_run(cfg, traffic, cell, n_new,
                                         monkeypatch):
    out, ctx = _traced(monkeypatch, cfg, traffic, cell)
    names = [m["name"] for m in harness.cell_metrics(BENCH, cell, True)
             if m["name"].split(".")[0] in NEW]
    assert len(names) == n_new
    for name in names:
        v = harness.reader(name)(ctx)
        assert v is None or v >= 0, (name, v)
    metrics = out["metrics"]
    # stamps are read on the CPU too; the device trace is not
    assert [n for n in names if n in metrics] == \
        [n for n in names if not n.startswith("decode_idle_ms")]
    assert harness.reader(names[-1])(ctx) is None
    recs = ctx.window.requests.values()
    assert any(r.times for r in recs)
    for r in recs:
        assert r.times == r.req.token_times, r.rid


def test_new_readers_without_the_programs_records():
    """A program that keeps no stamps and has no ranges (the parent of
    the instrumentation): every new reader returns None."""
    from servebench.trace import Tracer
    rec = SimpleNamespace(times=[1.0, 2.0], n_traced=1, arrival=0.5,
                          req=SimpleNamespace(t_first_token=1.0))
    tracer = Tracer()
    tracer.start()
    torch.ones(4).add_(1)
    tracer.stop()
    window = SimpleNamespace(requests={0: rec}, t_cut=3.0,
                             recorder=SimpleNamespace(tracer=tracer,
                                                      steps=[]))
    ctx = SimpleNamespace(window=window, traced_steps=lambda: [])
    for name in NEW:
        assert harness.reader(name)(ctx) is None, name
