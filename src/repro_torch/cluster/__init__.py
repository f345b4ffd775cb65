"""Cluster layer of the port: serving metrics, the discrete-event
cluster simulator and the PD-disaggregated simulator."""
from .metrics import cdf, fmt_row, imbalance_stats, pct, summarize
from .pd_disagg import PDDisaggSim
from .simulator import WINDOW, ClusterSim, make_mixed_fleet

__all__ = ["pct", "summarize", "cdf", "imbalance_stats", "fmt_row",
           "ClusterSim", "WINDOW", "make_mixed_fleet", "PDDisaggSim"]
