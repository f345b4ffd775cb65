"""Cluster layer of the port: serving metrics, the discrete-event
cluster simulator, the PD-disaggregated simulator and their closed-loop
drivers."""
from .closed_loop import ClosedLoopPDSim, ClosedLoopSim
from .metrics import (cdf, fmt_row, hardware_class_summary,
                      imbalance_stats, interference_summary,
                      overload_summary, pct, summarize)
from .pd_disagg import PDDisaggSim
from .simulator import WINDOW, ClusterSim, make_mixed_fleet

__all__ = ["pct", "summarize", "interference_summary",
           "hardware_class_summary", "overload_summary", "cdf",
           "imbalance_stats", "fmt_row", "ClusterSim", "WINDOW",
           "make_mixed_fleet", "PDDisaggSim", "ClosedLoopSim",
           "ClosedLoopPDSim"]
