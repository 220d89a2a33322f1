"""repro_torch.obs -- metrics, per-query tracing, profile trees, slow log,
Prometheus export, build watch, ES-style stats, device byte accounting,
analytic cost rows and the diagnostics bundle.

The monitoring half of the paper's pitch, threaded through the serving
engine and both indexes at host-side seams only: instrumentation records
timestamps *around* the search dispatch, never inside a kernel, so
answers are bit-identical with the plane on or off.  The JAX package's
``repro.obs``, module for module and under its names:

* :mod:`~repro_torch.obs.metrics` -- thread-safe registry of labelled
  counters, gauges and log-bucketed histograms (ES ``_nodes/stats``);
* :mod:`~repro_torch.obs.tracing` -- sampled per-request span traces
  with ring retention; ``Tracer(annotate=True)`` opens
  ``torch.profiler.record_function`` ranges around the dispatch;
* :mod:`~repro_torch.obs.profile` -- ``_search?profile=true`` trees
  (``engine.search(..., profile=True)``);
* :mod:`~repro_torch.obs.slowlog` -- the tail-captured slow log;
* :mod:`~repro_torch.obs.export` -- Prometheus text and a JSONL snapshot
  history;
* :mod:`~repro_torch.obs.compile_watch` -- counts and attributes the
  ``nvcc`` builds of the kernel libraries, the port's recompiles;
* :mod:`~repro_torch.obs.stats` -- ``BatchedSearchEngine.stats()``
  (ES ``_cat/thread_pool``), the index's ``_cat/segments`` view,
  ``Store.stats()`` (ES ``_stats/translog``) and the cluster rollups
  ``ClusterEngine.stats()`` / ``cluster_health()`` (ES ``_cluster/stats``
  and ``_cluster/health``) and ``node_stats`` (ES ``_nodes/stats``);
* :mod:`~repro_torch.obs.device` -- exact index-resident byte accounting
  per leaf, section and device, storages counted once;
* :mod:`~repro_torch.obs.cost` -- analytic operations/bytes rows per
  (region, signature, kernel), filed by the kernels' wrappers, with the
  roofline join and the fused-vs-composed byte claim;
* :mod:`~repro_torch.obs.diagnostics` -- the one-call support bundle
  (``python -m repro_torch.launch.serve --diagnostics-on-exit``).
"""

from .compile_watch import CompileWatch, active_watch, watch_region
from .cost import (CostTable, kernel_byte_ratio, missing_cost_regions,
                   roofline, verify_kernel_claim)
from .device import (device_bytes, format_device_line, resident_leaf_entries,
                     resident_storages)
from .diagnostics import (BUNDLE_SECTIONS, diagnostics_bundle,
                          write_diagnostics)
from .export import (MetricsExporter, device_gauges, health_gauges,
                     prometheus_text)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .profile import ProfileNode, format_profile_tree, profile_from_trace
from .slowlog import SlowLog, start_request_trace
from .stats import (cluster_health, cluster_stats, engine_stats,
                    format_health_line, format_segments_line,
                    format_stats_line, index_stats, node_stats, store_stats)
from .tracing import NULL_TRACE, Span, Trace, Tracer, annotation

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "Span", "Trace", "Tracer", "NULL_TRACE", "annotation",
    "index_stats", "engine_stats", "store_stats", "cluster_stats",
    "cluster_health", "format_stats_line", "format_segments_line",
    "format_health_line",
    "ProfileNode", "format_profile_tree", "profile_from_trace",
    "SlowLog", "start_request_trace",
    "CompileWatch", "active_watch", "watch_region",
    "MetricsExporter", "prometheus_text", "health_gauges", "device_gauges",
    "device_bytes", "format_device_line", "resident_leaf_entries",
    "resident_storages", "node_stats",
    "CostTable", "missing_cost_regions", "roofline", "kernel_byte_ratio",
    "verify_kernel_claim",
    "BUNDLE_SECTIONS", "diagnostics_bundle", "write_diagnostics",
]
