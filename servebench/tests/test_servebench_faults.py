"""A run of the harness with the timed path broken underneath must come
out not correct; a sound one correct.  Tiny configurations on the CPU
(the kernels' plain versions), the harness's look for a card skipped:
everything else of a run, from the weights to the check, runs."""
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from servebench import harness  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())


def _run(cfg="tiny_dense", traffic="tiny_agent",
         cell="qwen2_7b.agent", seed=20240601):
    return harness.run_cell(
        BENCH, cell, seed, 2.0, False, "cpu", time.perf_counter(),
        cfg=json.loads((HERE / f"{cfg}.json").read_text()),
        traffic=json.loads((HERE / f"{traffic}.json").read_text()))


def test_sound_runs_are_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    closed = _run("tiny_moe", "tiny_agent_closed",
                  "qwen3_30b_a3b.agent_closed")
    assert "output_tokens_per_s" in closed["metrics"]
    for run in (out, closed):
        assert run["checks"]["placements_differing"]["value"] == 0
        assert run["checks"]["engine_steps_differing"]["value"] == 0


def _decode_unchanged(self, params, token, pos, cache):
    """A decode step that returns the cache as it found it."""
    saved = [{k: t.clone() for k, t in e.items()} for e in cache]
    out = _ORIG["decode_step"](self, params, token, pos, cache)
    for e, s in zip(cache, saved):
        for k in e:
            e[k].copy_(s[k])
    return out


def _half_batch(self, tokens, pos):
    """Half of the slots computed; the others get the mean of theirs."""
    logits = _ORIG["_decode"](self, tokens, pos)
    h = logits.shape[0] // 2
    logits[h:] = logits[:h].mean(0, keepdim=True)
    return logits


def _token_altered(self, tokens, pos):
    """Every fourth decode step, each slot's token changed where it is
    produced."""
    logits = _ORIG["_decode"](self, tokens, pos)
    self._faulty_steps = getattr(self, "_faulty_steps", 0) + 1
    if self._faulty_steps % 4 == 0:
        logits = logits.roll(1, dims=-1)
    return logits


def _lookup_overcounted(self, blocks):
    """A stored prompt found, its length claimed a block longer."""
    key, frag, length = _ORIG["lookup"](self, blocks)
    return key, frag, length + (16 if frag is not None else 0)


_ORIG = {}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered", "placement_altered",
                                   "restore_overcounted"])
def test_faults_come_out_not_correct(fault, monkeypatch):
    from repro_torch.core.policies import LMetricPolicy
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import InstanceEngine, PrefixStore
    _ORIG["decode_step"] = Model.decode_step
    _ORIG["_decode"] = InstanceEngine._decode
    _ORIG["lookup"] = PrefixStore.lookup
    if fault == "state_unchanged":
        monkeypatch.setattr(Model, "decode_step", _decode_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(InstanceEngine, "_decode", _half_batch)
    elif fault == "token_altered":
        monkeypatch.setattr(InstanceEngine, "_decode", _token_altered)
    elif fault == "restore_overcounted":
        monkeypatch.setattr(PrefixStore, "lookup", _lookup_overcounted)
    else:
        route = LMetricPolicy.route

        def moved(self, req, factory, now):
            return (route(self, req, factory, now) + 1) % len(factory)
        monkeypatch.setattr(LMetricPolicy, "route", moved)
    out = _run()
    assert not out["correct"], (fault, out["checks"])
