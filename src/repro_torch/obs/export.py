"""Metrics exposition: Prometheus text format + a JSONL history ring.

Two consumers want
:meth:`~repro_torch.obs.metrics.MetricsRegistry.snapshot` in a stable
serialized form: scrapers/dashboards (Prometheus text exposition, the
format everything speaks) and offline analysis (periodic JSONL snapshots
with monotonic timestamps, so a latency spike can be lined up against
the counter deltas around it).  The text is the JAX package's, byte for
byte, for the same snapshot.  This module is that one seam:

* :func:`prometheus_text` -- render a registry snapshot as Prometheus
  text: counters/gauges as single samples, histograms summary-style
  (``{quantile="0.5"}`` samples + ``_count`` + ``_sum``).  Metric names
  mangle ``engine.requests.completed`` -> ``repro_engine_requests_
  completed``; the registry's ``"k=v,k=v"`` label strings become
  ``{k="v",...}`` label sets.
* :class:`MetricsExporter` -- a bounded in-memory history ring of
  ``{"t_monotonic", "metrics"}`` snapshot records (the registry's
  ``timeline`` section left out), optionally mirrored
  to an append-only JSONL file, optionally collected periodically by a
  background thread.

No sockets anywhere -- exposition is pull-from-file/ring by design: a
scrape endpoint is one ``open().read()`` away for whoever wants to serve
it.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["prometheus_text", "MetricsExporter", "health_gauges",
           "device_gauges"]

_QUANTILES = ("p50", "p90", "p99", "p999")

# exposition grammar: metric names are [a-zA-Z_:][a-zA-Z0-9_:]*, label
# names [a-zA-Z_][a-zA-Z0-9_]*.  Registry names are dotted and benign by
# convention, but nothing stops a caller labelling with arbitrary
# strings -- sanitize at the seam so the output always parses.
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _name(prefix: str, name: str, suffix: str = "") -> str:
    n = _NAME_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return prefix + n + suffix


def _label_name(k: str) -> str:
    k = _LABEL_BAD.sub("_", k)
    if not k or k[0].isdigit():
        k = "_" + k
    return k


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelset(label_str: str, extra: str = "") -> str:
    """Registry ``"k=v,k=v"`` label identity -> ``{k="v",...}`` (plus an
    optional pre-rendered extra pair, for quantile labels).  Label
    values may themselves contain ``,``/``=`` (device names, paths);
    splitting on the FIRST ``=`` of each comma part and gluing valueless
    parts back onto the previous value keeps such identities lossless
    enough for exposition, and ``_escape`` guarantees the rendered text
    always parses."""
    pairs = []
    if label_str:
        for part in label_str.split(","):
            k, eq, v = part.partition("=")
            if not eq and pairs:
                # a comma inside the previous value: re-attach
                prev_k, prev_v = pairs[-1]
                pairs[-1] = (prev_k, prev_v + "," + part)
                continue
            pairs.append((k, v))
    rendered = [f'{_label_name(k)}="{_escape(v)}"' for k, v in pairs]
    if extra:
        rendered.append(extra)
    return "{" + ",".join(rendered) + "}" if rendered else ""


def _num(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(snapshot: dict, prefix: str = "repro_") -> str:
    """One registry snapshot -> Prometheus text exposition format."""
    lines: List[str] = []
    for name in sorted(snapshot.get("counters", ())):
        metric = _name(prefix, name, "_total")
        lines.append(f"# TYPE {metric} counter")
        for label_str, v in sorted(snapshot["counters"][name].items()):
            lines.append(f"{metric}{_labelset(label_str)} {_num(v)}")
    for name in sorted(snapshot.get("gauges", ())):
        metric = _name(prefix, name)
        lines.append(f"# TYPE {metric} gauge")
        for label_str, v in sorted(snapshot["gauges"][name].items()):
            lines.append(f"{metric}{_labelset(label_str)} {_num(v)}")
    for name in sorted(snapshot.get("histograms", ())):
        metric = _name(prefix, name)
        lines.append(f"# TYPE {metric} summary")
        for label_str, h in sorted(snapshot["histograms"][name].items()):
            for key in _QUANTILES:
                v = h.get(key)
                if v is None:
                    continue
                quant = 'quantile="0.' + key[1:] + '"'
                lines.append(f"{metric}{_labelset(label_str, quant)}"
                             f" {_num(v)}")
            lines.append(f"{metric}_count{_labelset(label_str)}"
                         f" {_num(h['count'])}")
            lines.append(f"{metric}_sum{_labelset(label_str)}"
                         f" {_num(h['sum'])}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Periodic registry snapshots -> bounded ring + optional JSONL file.

    Records are ``{"t_monotonic": <time.monotonic()>, "metrics":
    registry.snapshot()}`` -- monotonic by construction, so consumers
    can difference counters across records without wall-clock hazards.
    ``start()`` spawns the periodic collector (daemon thread) when
    ``interval_s`` is set; :meth:`collect` is the manual tick.  :meth:`text` renders the
    CURRENT registry state as Prometheus text (scrape-on-demand).
    """

    def __init__(self, registry, path: Optional[str] = None,
                 capacity: int = 64, interval_s: Optional[float] = None,
                 prefix: str = "repro_"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if interval_s is not None and interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.path = path
        self.prefix = prefix
        self.interval_s = interval_s
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._file = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ snapshots
    def collect(self) -> dict:
        """Take one snapshot record: append to the ring (and the JSONL
        sink when configured) and return it."""
        snap = self.registry.snapshot()
        snap.pop("timeline", None)          # spans are not history
        rec = {"t_monotonic": time.monotonic(), "metrics": snap}
        with self._lock:
            self._ring.append(rec)
            f = self._file
            if f is None and self.path is not None:
                f = self._file = open(self.path, "a", encoding="utf-8")
            if f is not None:
                f.write(json.dumps(rec) + "\n")
                f.flush()
        return rec

    def history(self) -> List[dict]:
        """The retained snapshot records, oldest first."""
        with self._lock:
            return list(self._ring)

    def text(self) -> str:
        """Prometheus text exposition of the registry's CURRENT state."""
        return prometheus_text(self.registry.snapshot(), self.prefix)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MetricsExporter":
        if self.interval_s is None:
            return self
        if self._thread is not None:
            raise RuntimeError("exporter already started")

        def loop():
            while not self._stop.wait(self.interval_s):
                self.collect()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -------------------------------------------------- derived gauge series
_STATUS_CODE = {"green": 0, "yellow": 1, "red": 2}


def health_gauges(registry, health: dict) -> None:
    """Mirror a cluster-health dict (``status``, ``up_groups``,
    ``n_groups``, ``pending_requests``, ``in_flight_restores``,
    ``pending_maintenance``, ``generation``) into gauge series
    (``cluster.health.*``), so scrapers get the ``_cluster/health``
    verdict without parsing stats JSON.  Status encodes
    green=0 / yellow=1 / red=2 -- alert on ``> 0``."""
    registry.gauge("cluster.health.status").set(
        _STATUS_CODE.get(health["status"], 2))
    registry.gauge("cluster.health.up_groups").set(health["up_groups"])
    registry.gauge("cluster.health.n_groups").set(health["n_groups"])
    registry.gauge("cluster.health.pending_requests").set(
        health["pending_requests"])
    registry.gauge("cluster.health.in_flight_restores").set(
        health["in_flight_restores"])
    registry.gauge("cluster.health.pending_maintenance").set(
        len(health["pending_maintenance"]))
    registry.gauge("cluster.health.generation").set(health["generation"])


def device_gauges(registry, device: dict, **labels) -> None:
    """Mirror a device-bytes dict (``total_bytes``, ``sections``, and
    optionally ``per_device``) into gauge series: total index bytes (plus
    any caller labels, e.g. ``group=g``), one labelled series per
    section, one per device."""
    registry.gauge("device.index_bytes", **labels).set(
        device["total_bytes"])
    for section, b in device["sections"].items():
        registry.gauge("device.index_section_bytes", section=section,
                       **labels).set(b)
    for dev, b in device.get("per_device", {}).items():
        registry.gauge("device.resident_bytes", device=dev,
                       **labels).set(b)
