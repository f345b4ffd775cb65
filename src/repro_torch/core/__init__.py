from .types import Request
from .radix import RadixKVIndex, tokens_to_blocks
from .indicators import (AggregatedPrefixIndex, IndicatorFactory,
                         InstanceState, resolve_device)
from .pipeline import RoutingPipeline
from .latency_model import EngineSpec, LatencyModel, spec_from_config
from .policies import (FilterKVPolicy, JSQPolicy, LinearKVPolicy,
                       LMetricPolicy, Policy, make_policy)
from .router import Router, commit_wave_plan
from .state import router_from_numpy_state

__all__ = [
    "Request", "RadixKVIndex", "tokens_to_blocks",
    "AggregatedPrefixIndex", "IndicatorFactory", "InstanceState",
    "resolve_device", "RoutingPipeline",
    "EngineSpec", "LatencyModel", "spec_from_config",
    "Policy", "JSQPolicy", "LinearKVPolicy", "FilterKVPolicy",
    "LMetricPolicy", "make_policy",
    "Router", "commit_wave_plan", "router_from_numpy_state",
]
