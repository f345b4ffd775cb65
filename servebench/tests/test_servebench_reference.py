"""The plain references against the program at tiny sizes on the CPU,
and the control: the reference in float8 must fail the check that the
program passes."""
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from servebench import check, serving, traffic_gen  # noqa: E402
from servebench.reference import decoder  # noqa: E402

HERE = Path(__file__).resolve().parent


def _cfg(name, dtype=None):
    cfg = json.loads((HERE / f"{name}.json").read_text())
    if dtype:
        cfg["port"]["dtype"] = cfg["torch_dtype"] = dtype
    return cfg


@pytest.mark.parametrize("name", ["tiny_dense", "tiny_moe"])
def test_reference_is_the_programs_plain_forward_in_float32(name):
    cfg = _cfg(name, "float32")
    built = serving.build(cfg, 3, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (1, 90),
                         generator=torch.Generator().manual_seed(1))
    want, _ = built.model.prefill(built.params, toks)
    got = decoder.logits_at(cfg, built.params, [toks[0]],
                            [torch.arange(90)])[0]
    assert torch.allclose(got, want[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,traffic", [("tiny_dense", "tiny_agent"),
                                          ("tiny_moe", "tiny_agent_closed")])
def test_control_fails_where_the_program_passes(name, traffic):
    """Through the run's own check: the program's verdict is correct, the
    control's (float8 in its place) is not, and the control is over each
    of the configuration's limits."""
    cfg = _cfg(name)
    tr = json.loads((HERE / f"{traffic}.json").read_text())
    for seed in (1, 2, 3):
        built = serving.build(cfg, seed, "cpu")
        cluster = serving.make_cluster(built, cfg["serving"], "cpu")
        work = traffic_gen.make_workload(tr, seed, cfg["vocab_size"],
                                         cfg["serving"]["max_len"])
        win = serving.serve(cluster, work, 2.0)
        serving.drain(cluster, win, check.enough(cfg, seed), 60.0)
        serving.free(cluster)
        verdict = check.judge(cfg, built.params, win, seed, "cpu")
        assert verdict["correct"], verdict["checks"]
        ctl = check.control(cfg, built.params, win, seed, "cpu", verdict)
        assert not ctl["correct"], ctl["checks"]
        for limit_name, limit in cfg["check"]["limits"].items():
            assert ctl["checks"][limit_name]["value"] > limit, limit_name


def test_router_reference_follows_the_rule():
    from servebench.reference.lmetric_router import LMetricReference
    import numpy as np
    ref = LMetricReference(2, 4)
    a = np.arange(12)
    assert ref.route(a) == 0        # a tie: round-robin, counter 0
    # on 0 the hit is whole but 12 tokens wait there: (12 + 1) * 2 > 13 * 1
    assert ref.route(a) == 1
    ref.step(0, 12, 1, 0)
    ref.step(1, 12, 1, 0)
    assert ref.route(a) == 0        # (0 + 1) * 2 on both: counter 2
    ref.step(0, 0, 1, 2)            # the third starts, two finish
    assert ref.route(np.arange(100, 108)) == 0      # 9 * 1 < 9 * 2


def test_engine_model_restores_whole_stored_prompts():
    """A prompt is stored once its prefill ends; a later prompt that it
    begins restores it and prefills only the rest."""
    from servebench.reference.lmetric_router import EngineModel, prefix_keys
    import numpy as np
    eng = EngineModel(max_batch=2, max_len=64, chunk=8, block=4,
                      capacity=2)
    a = np.arange(12)
    b = np.concatenate([a, np.arange(100, 106)])
    eng.submit(prefix_keys(a, 4), len(a), 2)
    assert eng.step() == ("prefill", 8, 0, 0)
    assert eng.step() == ("prefill", 4, 1, 0)
    eng.submit(prefix_keys(b, 4), len(b), 1)
    assert eng.step() == ("prefill", 6, 1, 1)      # 12 restored
    assert eng.step() == ("decode", 0, 0, 1)
    eng.submit(prefix_keys(a, 4), len(a), 1)       # all of it stored:
    assert eng.step() == ("prefill", 1, 1, 1)      # one token left


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from servebench import harness
    bench = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
    out = harness.run_cell(bench, "qwen2_7b.agent", 5, 3.0, True, "cuda",
                           time.perf_counter(), cfg=_cfg("tiny_dense"),
                           traffic=json.loads(
                               (HERE / "tiny_agent.json").read_text()))
    assert out["correct"], out["checks"]
