"""The simulators with the router's mirror on the card (``-m cuda``; they
skip without one).  Every arrival wave of two or more is one launch of
the CUDA ``route_score`` kernel, and the runs must equal the same runs
with the mirror on the CPU (the kernel's plain version) exactly:
finished tuples ``(rid, sched_to, hit_tokens, t_first_token,
t_finish)``.  A host-only policy (Dynamo, llm-d, PolyServe, Preble,
session affinity, LMetric with the "cost" indicator or a hotspot
detector) routes its waves request by request and launches nothing; a
detector that never activates leaves LMetric's device-planned run as it
was.  This file imports no JAX; the CPU runs are held against
the JAX package in ``tests/test_torch_simulator.py`` and
``tests/test_torch_pd_disagg.py``.
"""
import collections
import copy

import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster.pd_disagg import PDDisaggSim  # noqa: E402
from repro_torch.cluster.simulator import ClusterSim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (HotspotDetector, LatencyModel,  # noqa: E402
                              LMetricPolicy, Router, make_policy,
                              spec_from_config)
from repro_torch.kernels import route_score  # noqa: E402
from repro_torch.workloads.traces import make_trace  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the route_score kernel has no "
                    "CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def trace():
    tr = make_trace("chatbot", qps=20.0, duration=120.0, seed=3)
    for r in tr:
        r.arrival = round(r.arrival / 0.1) * 0.1
    tr.sort(key=lambda r: r.arrival)
    return tr


def finished(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
            for r in done]


def waves(trace):
    return sum(1 for c in collections.Counter(
        r.arrival for r in trace).values() if c > 1)


def _cluster(policy, trace, device):
    spec = spec_from_config(get_config("qwen2_7b"))
    if isinstance(policy, str):
        policy = make_policy(policy)
    router = Router(policy, 8, kv_capacity_tokens=300_000, device=device)
    done = ClusterSim(router, spec).run(copy.deepcopy(trace))
    return finished(done), router


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lmetric", "vllm", "linear"])
def test_cluster_sim_on_card_equals_cpu(card, trace, policy):
    launches = route_score.LAUNCHES
    got, router = _cluster(policy, trace, card)
    assert route_score.LAUNCHES - launches == router.pipeline.waves \
        == waves(trace) > 100
    want, _ = _cluster(policy, trace, "cpu")
    assert got == want and len(got) == len(trace)


HOST_ONLY = {
    "dynamo": lambda s: make_policy("dynamo"),
    "llm-d": lambda s: make_policy(
        "llm-d", latency_model=LatencyModel(s, error_std=0.15)),
    "polyserve": lambda s: make_policy(
        "polyserve", latency_model=LatencyModel(s, error_std=0.15)),
    "preble": lambda s: make_policy("preble"),
    "session-affinity": lambda s: make_policy("session-affinity"),
    "cost": lambda s: LMetricPolicy(load_indicator="cost",
                                    latency_model=LatencyModel(s)),
    "detector": lambda s: LMetricPolicy(detector=HotspotDetector()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HOST_ONLY))
def test_host_only_policy_launches_nothing(card, trace, name):
    spec = spec_from_config(get_config("qwen2_7b"))
    launches = route_score.LAUNCHES
    got, router = _cluster(HOST_ONLY[name](spec), trace, card)
    assert route_score.LAUNCHES == launches
    assert router.pipeline.waves == 0
    want, _ = _cluster(HOST_ONLY[name](spec), trace, "cpu")
    assert got == want and len(got) == len(trace)


@pytest.mark.cuda
def test_detector_without_activation_equals_device_plan(card, trace):
    det = HotspotDetector()
    got, _ = _cluster(LMetricPolicy(detector=det), trace, card)
    assert det.history and not any(e["event"] == "activate"
                                   for e in det.events)
    launches = route_score.LAUNCHES
    want, router = _cluster("lmetric", trace, card)
    assert route_score.LAUNCHES - launches == router.pipeline.waves > 100
    assert got == want


@pytest.mark.cuda
def test_pd_disagg_on_card_equals_cpu(card, trace):
    spec = spec_from_config(get_config("qwen2_7b"))
    launches = route_score.LAUNCHES
    got = finished(PDDisaggSim(4, 4, spec, device=card)
                   .run(copy.deepcopy(trace)))
    assert route_score.LAUNCHES - launches == waves(trace)
    want = finished(PDDisaggSim(4, 4, spec, device="cpu")
                    .run(copy.deepcopy(trace)))
    assert got == want and len(got) == len(trace)
