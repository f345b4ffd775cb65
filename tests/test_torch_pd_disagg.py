"""The port's PD-disaggregated simulator (``repro_torch.cluster.pd_disagg``)
against the JAX package's, on the CPU.

The port runs its own wave path: a same-timestamp arrival wave of two or
more goes through ``route_score``'s ``ptoken`` kind (its plain version,
the mirror being on the CPU) and ``commit_wave_plan``.  The reference
side routes request by request (the ``Sequential`` subclass of
``tests/test_batch_routing.py``, which never reaches JAX), except in one
case held against the reference's own wave path under the jax 0.9
``enable_x64`` shim.  Finished tuples ``(rid, sched_to, hit_tokens,
t_sched, t_first_token, t_finish)`` must be identical (exact).
"""
import copy

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.core.latency_model as rlm  # noqa: E402
import repro.workloads.traces as rtraces  # noqa: E402
from repro.cluster.pd_disagg import PDDisaggSim as RefPD  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workloads.traces as ttraces  # noqa: E402
from repro_torch.cluster.metrics import summarize  # noqa: E402
from repro_torch.cluster.pd_disagg import PDDisaggSim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)


@pytest.fixture
def x64(monkeypatch):
    """jax 0.9 removed ``jax.experimental.enable_x64``, which the
    reference calls around every wave; route it to ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


class RefSequential(RefPD):
    def _on_arrivals(self, reqs):
        for r in reqs:
            self._on_arrival(r)


class PortSequential(PDDisaggSim):
    def _on_arrivals(self, reqs):
        for r in reqs:
            self._on_arrival(r)


def quantize(trace, tick):
    for r in trace:
        r.arrival = round(r.arrival / tick) * tick
    trace.sort(key=lambda r: r.arrival)
    return trace


def key(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_sched, r.t_first_token,
             r.t_finish) for r in done]


def _specs(small):
    """The spec of ``tests/test_batch_routing.py``'s PD case, or
    Qwen2-7B's; both at the reference's peak rates."""
    if small:
        kw = dict(name="pd", active_params=3e9, n_layers=16,
                  kv_bytes_per_token=4096)
        return rcore.EngineSpec(**kw), tcore.EngineSpec(**kw, **REF_RATES)
    return (rcore.spec_from_config(ref_config("qwen2_7b")),
            tcore.spec_from_config(get_config("qwen2_7b"), **REF_RATES))


CASES = {
    # the reference test's setting: chatbot, 400 requests at 1 s ticks
    "chatbot-4x6": dict(family="chatbot", qps=20.0, duration=120.0,
                        seed=3, n_req=400, tick=1.0, n=(4, 6), small=True),
    "agent-8x8": dict(family="agent", qps=30.0, duration=40.0, seed=5,
                      n_req=None, tick=0.1, n=(8, 8), small=False),
    "coder-3x5": dict(family="coder", qps=6.0, duration=90.0, seed=2,
                      n_req=None, tick=0.5, n=(3, 5), small=False),
    # a KV$ small enough to evict mid-wave: the rest of such a wave is
    # routed one by one
    "chatbot-evicting": dict(family="chatbot", qps=20.0, duration=120.0,
                             seed=3, n_req=400, tick=1.0, n=(4, 6),
                             small=True, kv=8_000),
}


def _traces(c):
    kw = dict(qps=c["qps"], duration=c["duration"], seed=c["seed"])
    return (quantize(rtraces.make_trace(c["family"], **kw),
                     c["tick"])[:c["n_req"]],
            quantize(ttraces.make_trace(c["family"], **kw),
                     c["tick"])[:c["n_req"]])


@pytest.mark.parametrize("case", list(CASES))
def test_pd_disagg_equals_reference(case):
    c = CASES[case]
    rspec, tspec = _specs(c["small"])
    rt, tt = _traces(c)
    kv = c.get("kv", 400_000)
    port = PDDisaggSim(*c["n"], tspec, kv_capacity_tokens=kv, device="cpu")
    done = port.run(copy.deepcopy(tt))
    assert len(done) == len(tt)
    want = key(RefSequential(*c["n"], rspec, kv_capacity_tokens=kv)
               .run(copy.deepcopy(rt)))
    assert key(done) == want
    # and the port's own request-by-request path agrees
    assert key(PortSequential(*c["n"], tspec, kv_capacity_tokens=kv,
                              device="cpu").run(copy.deepcopy(tt))) == want
    if "kv" in c:
        assert port.pf.evictions > 0


def test_pd_disagg_equals_reference_wave_path(x64):
    """The reference's own wave path (its JAX ``route_score``, ptoken
    kind) gives the same run as the port's."""
    c = dict(CASES["chatbot-4x6"], n_req=250)
    rspec, tspec = _specs(True)
    rt, tt = _traces(c)
    want = key(RefPD(4, 6, rspec).run(copy.deepcopy(rt)))
    assert key(PDDisaggSim(4, 6, tspec, device="cpu")
               .run(copy.deepcopy(tt))) == want


# ---- ports of tests/test_pd_disagg.py ------------------------------------
def _spec():
    return tcore.spec_from_config(get_config("qwen2_7b"))


def test_pd_disagg_serves_everything():
    trace = ttraces.make_trace("agent", qps=8, duration=90, seed=5)
    sim = PDDisaggSim(3, 5, _spec(), device="cpu")
    done = sim.run(copy.deepcopy(trace))
    assert len(done) == len(trace)
    s = summarize(done)
    assert s["ttft_mean"] > 0
    # KV$ transfer happens between prefill completion and decode: TTFT
    # reflects prefill only (first token produced at prefill end)
    for r in done:
        assert r.t_first_token >= r.arrival
        assert r.t_finish >= r.t_first_token


def test_pd_disagg_prefill_pool_is_kv_aware():
    trace = ttraces.make_trace("toolagent", qps=6, duration=120, seed=2)
    sim = PDDisaggSim(4, 4, _spec(), device="cpu")
    done = sim.run(copy.deepcopy(trace))
    assert summarize(done)["kv_hit_ratio"] > 0.3


def test_pd_decode_pool_balanced():
    trace = ttraces.make_trace("chatbot", qps=10, duration=90, seed=3)
    sim = PDDisaggSim(3, 6, _spec(), device="cpu")
    sim.run(copy.deepcopy(trace))
    for inst in sim.df:
        assert inst.r_bs == 0   # drained at the end


def test_pd_disagg_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDDisaggSim(2, 2, _spec())
