"""The port's ``launch/serve.py`` against the JAX package's, on the CPU.

The reference's ``repro.launch.serve.main`` runs as its command line does
(``--requests 12``, once per policy; parameters from ``jax.random.key(0)``
on ``qwen3_4b-smoke``), with its finished list captured by wrapping
``repro.cluster.metrics.summarize`` (``main`` imports it when it runs)
and its arrivals by wrapping ``EngineCluster.run``.  The port's ``run``
serves the same config on ``device="cpu"`` with those parameters
converted by ``params_from_numpy``.  One fake clock drives both engine
modules (``tests/test_torch_engine.py``'s ``_Clock``: every call of
``perf_counter`` advances 1/128 s), so virtual times are exact: the
arrivals are byte-identical, every request's (instance, hit tokens,
prompt length, first-token and finish time) is equal, and so is the
printed row.  ``main``'s flags and defaults are the reference's plus
``--device``; ``--dry-run`` writes the dry run's record (with
``--multi-pod``, the 2 x 16 x 16 one), and an encoder-decoder is
refused by both engines.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.cluster.metrics as j_metrics  # noqa: E402
import repro.launch.serve as j_serve  # noqa: E402
import repro.serving.engine as j_engine_mod  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
import repro_torch.serving.engine as t_engine_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen3_4b"
N_REQ = 12


class _Clock:
    """Every call advances 1/128 s (exact in binary)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1 / 128
        return self.t


@pytest.fixture(scope="module")
def port_params():
    jp = JModel(j_get_config(ARCH + "-smoke")).init(jax.random.key(0))
    return params_from_numpy(get_config(ARCH + "-smoke"),
                             jax.tree.map(np.asarray, jp))


def _reference_run(monkeypatch, capsys, policy):
    """The reference's ``main`` under the fake clock: (arrivals, finished
    requests, printed row)."""
    seen = {}
    summarize, run = j_metrics.summarize, j_engine_mod.EngineCluster.run

    def keep_done(done, *a, **k):
        seen["done"] = list(done)
        return summarize(done, *a, **k)

    def keep_arrivals(self, arrivals, *a, **k):
        seen["arrivals"] = list(arrivals)
        return run(self, arrivals, *a, **k)

    monkeypatch.setattr(j_metrics, "summarize", keep_done)
    monkeypatch.setattr(j_engine_mod.EngineCluster, "run", keep_arrivals)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--requests",
                                      str(N_REQ), "--policy", policy])
    capsys.readouterr()
    j_serve.main()
    row = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(j_metrics, "summarize", summarize)
    monkeypatch.setattr(j_engine_mod.EngineCluster, "run", run)
    return seen["arrivals"], seen["done"], row


@pytest.mark.parametrize("policy", ["lmetric", "vllm", "linear"])
def test_serve_matches_reference_under_fake_clock(policy, port_params,
                                                  monkeypatch, capsys):
    clock = _Clock()
    monkeypatch.setattr(j_engine_mod, "time", clock)
    monkeypatch.setattr(t_engine_mod, "time", clock)
    j_arr, j_done, j_row = _reference_run(monkeypatch, capsys, policy)
    arrivals = t_serve.make_arrivals(N_REQ)
    assert len(arrivals) == len(j_arr) == N_REQ
    for (t, toks, out), (jt, jtoks, jout) in zip(arrivals, j_arr):
        assert t == jt and out == jout
        assert toks.dtype == jtoks.dtype == np.int32
        assert toks.tobytes() == jtoks.tobytes()
    clock.t = 0.0
    served = t_serve.run(get_config(ARCH + "-smoke"), policy,
                         params=port_params, device="cpu", requests=N_REQ)
    assert len(served.done) == len(j_done) == N_REQ
    jby = {r.rid: r for r in j_done}
    for r in served.done:
        j = jby[r.rid]
        assert (r.sched_to, r.hit_tokens, r.prompt_len) == \
            (j.sched_to, j.hit_tokens, j.prompt_len), r.rid
        assert r.t_first_token == j.t_first_token, r.rid
        assert r.t_finish == j.t_finish, r.rid
    assert [r.rid for r in served.done] == [r.rid for r in j_done]
    assert served.row == j_row
    assert f"n={N_REQ:>6}" in served.row
    if policy == "lmetric":
        assert len({r.sched_to for r in served.done}) > 1
        assert any(r.hit_tokens >= 96 for r in served.done)


def test_engine_settings_and_arrivals_are_the_reference_launchers():
    assert t_serve.ENGINE_KW == dict(block_size=16, max_batch=4,
                                     max_len=256, chunk_tokens=64)
    a = t_serve.make_arrivals(40)
    assert len(a) == 40
    assert all(104 <= len(toks) <= 127 and 4 <= out <= 11
               for _, toks, out in a)
    assert all(t1 < t2 for (t1, _, _), (t2, _, _) in zip(a, a[1:]))
    # three app prompts of 96 tokens
    assert len({toks[:96].tobytes() for _, toks, _ in a}) == 3


def test_main_defaults_and_cpu_run(capsys):
    out = t_serve.main(["--device", "cpu", "--requests", "6",
                        "--instances", "2", "--policy", "vllm"])
    assert len(out.done) == 6
    assert len(out.cluster.engines) == 2
    assert out.cluster.router.policy.name == "vllm"
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == out.row and printed.startswith("vllm")


@pytest.mark.parametrize("flag", ["--dry-run", "--multi-pod"])
def test_dry_run_and_multi_pod_raise(flag, tmp_path, monkeypatch):
    """``--dry-run`` delegates to ``launch.dryrun`` (``--arch`` at
    ``--shape``, default ``decode_32k``) and writes its record; with
    ``--multi-pod`` too, the 2 x 16 x 16 record.  Nothing runs on a
    device: the dry run works on ``meta`` tensors."""
    import repro_torch.launch.dryrun as dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    argv = ["--dry-run"] + (["--multi-pod"] if flag == "--multi-pod"
                            else [])
    rec = t_serve.main(argv)
    mesh = "2x16x16" if flag == "--multi-pod" else "16x16"
    assert rec["ok"] and (rec["arch"], rec["shape"], rec["mesh"]) == \
        (ARCH, "decode_32k", mesh)
    assert rec["n_devices"] == (512 if flag == "--multi-pod" else 256)
    saved = tmp_path / f"{ARCH}__decode_32k__{mesh}.json"
    assert saved.exists()


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--requests", "2"])


def test_whisper_is_refused_as_in_the_reference(monkeypatch):
    with pytest.raises(ValueError, match="encoder-decoder"):
        t_serve.run(get_config("whisper_medium-smoke"), "lmetric",
                    device="cpu", requests=2)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper_medium",
                                      "--requests", "2"])
    with pytest.raises(AssertionError, match="enc-dec"):
        j_serve.main()
