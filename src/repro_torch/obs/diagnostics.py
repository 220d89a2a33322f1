"""One-call support-diagnostics bundle (the ES diagnostics tarball).

When an ES cluster misbehaves, support asks for one artifact: the
diagnostics bundle -- every ``_stats``/``_cluster/health``/
``_nodes/stats`` surface plus recent logs, captured at one instant,
parseable offline.  :func:`diagnostics_bundle` is that artifact for the
port, a single JSON document with the JAX package's sections:

========================  ==============================================
section                   contents (ES analogue)
========================  ==============================================
``meta``                  wall/monotonic timestamps, dump reason,
                          backend (``cuda`` or ``cpu``: where the served
                          index lives) + device count
``stats``                 ``engine.stats()`` rollup (``_stats``)
``health``                :func:`~repro_torch.obs.stats.cluster_health`
                          (``_cluster/health``; None for a single
                          engine -- no cluster state to report)
``nodes``                 :func:`~repro_torch.obs.stats.node_stats`
                          (``_nodes/stats``)
``device``                per-group :func:`~repro_torch.obs.device.
                          device_bytes` leaf tables (``_cat/segments``
                          bytes view)
``cost``                  analytic operations/bytes rows per watch
                          region (:class:`~repro_torch.obs.cost.CostTable`)
``compile``               build-watch counters + steady-state events
``slowlog``               the slow-log ring, NOT cleared (dumping
                          diagnostics must not eat the evidence)
``traces``                the tracer ring, when sampling is on
``metrics``               full registry snapshot, less its timeline
``metrics_history``       the exporter's recent collection ring, when
                          an exporter is polling
========================  ==============================================

Every section key is ALWAYS present (None/empty when the surface is not
wired), so consumers can assert bundle completeness structurally
(``tools/validate_diag_bundle_torch.py``).  :func:`write_diagnostics`
wraps it in a timestamped file; ``python -m repro_torch.launch.serve
--diagnostics-on-exit DIR`` dumps one at exit and automatically on
failover and ``--kill-and-recover``.  Building a bundle reads no
tensor's values.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["diagnostics_bundle", "write_diagnostics", "BUNDLE_SECTIONS"]

BUNDLE_SECTIONS = ("meta", "stats", "health", "nodes", "device", "cost",
                   "compile", "slowlog", "traces", "metrics",
                   "metrics_history")


def _jsonable(obj):
    """``json.dump`` default: numpy scalars/arrays and sets degrade to
    plain python; anything else degrades to ``repr`` rather than
    failing the bundle (a diagnostics dump must not raise over one
    exotic value)."""
    try:
        import numpy as np

        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
    except Exception:
        pass
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return repr(obj)


def diagnostics_bundle(engine, *, exporter=None,
                       reason: Optional[str] = None) -> dict:
    """Snapshot every obs surface of ``engine`` (a
    ``BatchedSearchEngine`` or ``ClusterEngine``) into one JSON-ready
    dict with the :data:`BUNDLE_SECTIONS` keys.  ``exporter`` (a
    :class:`~repro_torch.obs.export.MetricsExporter`) contributes its
    recent collection history when provided; ``reason`` records why the
    bundle was cut (``"exit"``, ``"failover"``, ``"kill-and-recover"``)."""
    import torch

    from .device import device_bytes
    from .stats import cluster_health, node_stats

    batchers = getattr(engine, "batchers", None)
    if batchers is not None:
        health = cluster_health(engine)
        indexes = [b.index for b in batchers]
    else:
        health = None
        indexes = [engine.index]
    device = {str(g): device_bytes(idx) for g, idx in enumerate(indexes)}
    backend = "cuda" if any(
        d.startswith("cuda") for dev in device.values()
        for d in dev["per_device"]) else "cpu"
    meta = {
        "t_wall": time.time(),
        "t_monotonic": time.monotonic(),
        "reason": reason,
        "backend": backend,
        "n_devices": torch.cuda.device_count() if backend == "cuda" else 1,
    }

    watch = getattr(engine, "compile_watch", None)
    slowlog = getattr(engine, "slowlog", None)
    tracer = getattr(engine, "tracer", None)

    return {
        "meta": meta,
        "stats": engine.stats(),
        "health": health,
        "nodes": node_stats(engine),
        "device": device,
        "cost": watch.costs.stats() if watch is not None else None,
        "compile": watch.stats() if watch is not None else None,
        "slowlog": (None if slowlog is None
                    else {"entries": slowlog.dump(clear=False),
                          "stats": slowlog.stats()}),
        "traces": (None if tracer is None
                   else {"entries": tracer.dump(),
                         "stats": tracer.stats()}),
        "metrics": {k: v for k, v in engine.metrics.snapshot().items()
                    if k != "timeline"},
        "metrics_history": (exporter.history()
                            if exporter is not None else []),
    }


def write_diagnostics(engine, directory: str, *, exporter=None,
                      reason: Optional[str] = None) -> str:
    """Cut a bundle and write it as ``diagnostics-<utc>-<reason>.json``
    under ``directory`` (created if needed); returns the file path.
    File names carry a monotonic disambiguator so two dumps in the same
    second (failover then exit) never clobber each other."""
    bundle = diagnostics_bundle(engine, exporter=exporter, reason=reason)
    os.makedirs(directory, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    tag = f"{time.monotonic_ns() % 1_000_000:06d}"
    path = os.path.join(
        directory,
        f"diagnostics-{stamp}-{tag}-{reason or 'manual'}.json")
    with open(path, "w") as f:
        json.dump(bundle, f, indent=1, default=_jsonable)
    return path
