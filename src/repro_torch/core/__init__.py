"""The port's routing core.  Names resolve lazily (PEP 562): importing a
numpy-only module such as ``repro_torch.core.shard_backends`` — which a
spawned shard worker does — loads neither ``torch`` nor the modules that
import it."""
import importlib

_EXPORTS = {
    "types": ("Deadline", "DEFAULT_SLO", "FAMILY_SLOS", "Request", "SLO",
              "slo_for_family", "stamp_deadline"),
    "overload": ("AdmissionController", "NO_CONTROL", "OverloadControl"),
    "fleet": ("FleetSpec", "homogeneous_fleet", "make_fleet"),
    "radix": ("RadixKVIndex", "tokens_to_blocks"),
    "prefix_index": ("AggregatedPrefixIndex", "shard_bounds"),
    "faults": ("FaultEvent", "FaultInjector", "FaultPlan", "ShardError"),
    "shard_backends": ("ProcessBackend", "SerialBackend", "ShardBackend",
                       "ThreadBackend", "make_backend"),
    "sharded_index": ("ShardedPrefixIndex",),
    "indicators": ("IndicatorFactory", "InstanceState", "resolve_device"),
    "pipeline": ("RoutingPipeline",),
    "latency_model": ("EngineSpec", "LatencyModel", "spec_from_config"),
    "policies": ("DynamoPolicy", "FilterKVPolicy", "JSQPolicy",
                 "LinearKVPolicy", "LMetricPolicy", "Policy",
                 "PolyServePolicy", "PreblePolicy", "RouteThenBalancePolicy",
                 "SessionAffinityPolicy", "SimulationPolicy",
                 "make_policy"),
    "hotspot": ("HotspotDetector",),
    "router": ("Router", "commit_wave_plan"),
    "state": ("router_from_numpy_state",),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
