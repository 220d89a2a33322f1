"""ES ``_stats``/``_cat``-style snapshot assembly, host part.

One function per serving layer, each returning a plain nested dict (JSON-
ready, the shape ES returns from ``GET <index>/_stats`` / ``_cat``
endpoints).  ``BatchedSearchEngine.stats()``, ``ClusterEngine.stats()``
and ``Store.stats()`` expose them, but the assembly lives here so the
serving classes carry no formatting code and the obs package owns the
schema -- the JAX package's schema, key for key, but for the static-cost
rollup of its compile section (XLA's cost model has no counterpart here
yet) and the device part (``node_stats``, not ported yet).

Counter reconciliation is part of the schema contract: queries issued ==
``cluster.requests.completed`` == sum over groups of
``cluster.requests.group_completed``; one injected group failure == one
``failover.resubmits`` increment (sequential traffic) == one
``health.down_transitions`` + one readmit once healed.

What maps where:

* :func:`index_stats` -- ES ``_stats/docs,segments``: doc counts,
  per-generation segment rows/tombstones/deleted ratios (the tiered
  merge policy's inputs), active-buffer occupancy, per-shard tombstones,
  tombstone ratio (the full-compact trigger).
  :func:`format_segments_line` renders it ``_cat/segments``-style.
* :func:`engine_stats` -- ES ``_cat/thread_pool`` + node stats for one
  batcher: queue depth, in-flight, batch occupancy, queue-wait and
  dispatch-latency histograms, request, ingest and kernel-path counters,
  and the slow-log and build-watch sections.
* :func:`cluster_stats` -- the cluster-level rollup (``_cluster/stats``
  + ``_cat/shards``) of a :class:`repro_torch.cluster.ClusterEngine`:
  per-group engine stats + health state, routing counters (spills,
  failover resubmits, per-group completions), health-transition
  counters, maintenance + store sections when wired.
* :func:`cluster_health` -- ES ``_cluster/health``: the green / yellow /
  red verdict with queue depths, restores, pending maintenance and the
  transition ledger it reconciles against;
  :func:`format_health_line` renders it ``_cat/health``-style.
* :func:`store_stats` -- ES ``_stats/translog`` for one
  :class:`repro_torch.store.Store`: translog seqno, generation and
  on-disk bytes, the newest commit, commit and recovery counts and
  timings, the incremental-commit byte counts.
* :func:`format_stats_line` renders an engine (or a cluster rollup)
  dict as one ``_cat`` line.
"""

from __future__ import annotations

import math
import os
from typing import Optional

__all__ = ["index_stats", "engine_stats", "cluster_stats", "store_stats",
           "cluster_health", "format_stats_line", "format_segments_line",
           "format_health_line"]


def _hist(registry, name: str, **labels) -> dict:
    return registry.histogram(name, **labels).snapshot()


def _kernel_mix(registry, labels: dict) -> dict:
    """Dispatch counts per phase-1 path for ONE batcher, parsed from
    the ``engine.kernel_path`` series (labelled ``engine=<name>`` plus
    the batcher's own labels).  A fleet registry holds every batcher's
    series; filtering on the non-engine labels keeps each group's mix
    its own."""
    want = {k: str(v) for k, v in labels.items()}
    out: dict = {}
    for label_str, v in registry.series("engine.kernel_path").items():
        kv = dict(part.split("=", 1) for part in label_str.split(",") if part)
        eng = kv.pop("engine", None)
        if eng is None or kv != want:
            continue
        out[eng] = out.get(eng, 0) + v
    return out


def _compile_stats(watch) -> dict:
    """The build-watch section, without the (possibly long) event list
    -- stats lines want the totals; ``watch.stats()`` has the rest."""
    s = watch.stats()
    return {k: s[k] for k in ("compiles_total", "compiles_steady_state",
                              "steady", "signatures", "by_function")}


def index_stats(index) -> dict:
    """Docs/segments section for any served index (plain VectorIndex
    reports what it has; a sharded index reports the full ES segment
    story).  Attribute-guarded: works through wrappers that proxy
    attributes."""
    out = {"n_ids": int(getattr(index, "n_ids", getattr(index, "n_docs", 0)))}
    for name in ("n_docs", "n_shards", "n_replicas", "n_appended",
                 "seg_capacity"):
        v = getattr(index, name, None)
        if v is not None:
            out[name] = int(v)
    tombs = getattr(index, "shard_tombstones", None)
    if tombs is not None:
        out["shard_tombstones"] = tuple(int(t) for t in tombs)
        out["n_tombstones"] = int(getattr(index, "n_tombstones", sum(tombs)))
        out["tombstone_ratio"] = float(getattr(index, "tombstone_ratio", 0.0))
    segs = getattr(index, "segments", None)
    if segs is not None:
        # the _cat/segments view: per-generation doc/tombstone counts --
        # the per-segment deleted ratios are what the tiered merge policy
        # consults (the whole-index tombstone_ratio can't see which
        # generation the deletes hit)
        out["n_segments"] = len(segs)
        out["segments"] = [
            {"rows": int(s.n_rows), "width": int(s.width),
             "tombstones": int(s.tombstones),
             "deleted_ratio": float(s.deleted_ratio)}
            for s in segs]
        for name in ("n_active", "seg_base", "active_tombstones",
                     "n_reclaimed"):
            v = getattr(index, name, None)
            if v is not None:
                out[name] = int(v)
    seq = getattr(index, "translog_seq", None)
    if seq is not None:
        out["translog_seq"] = int(seq)
    return out


def engine_stats(engine) -> dict:
    """One batcher's thread-pool view: queue/in-flight depths, request
    counters, occupancy + latency histograms, the served index's doc
    stats."""
    reg, labels = engine.metrics, engine._metric_labels
    with engine._lock:
        queue_depth = len(engine._queue)
        inflight = engine._inflight
        index = engine.index
    # the full dispatch mix, not just this batcher's configured engine:
    # a batcher reconfigured mid-life (or sharing a registry with its
    # past self) reports every path it ever took, zero-seeded with the
    # current one so the mix is never empty
    mix = _kernel_mix(reg, labels)
    mix.setdefault(engine.engine, 0)
    out = {
        "queue_depth": queue_depth,
        "in_flight": inflight,
        "pending": queue_depth + inflight,
        "batch_size": engine.batch_size,
        "max_wait_s": engine.max_wait_s,
        "requests": {
            "submitted": reg.value("engine.requests.submitted", **labels),
            "completed": reg.value("engine.requests.completed", **labels),
            "failed": reg.value("engine.requests.failed", **labels),
        },
        "batches": _hist(reg, "engine.batch.occupancy", **labels),
        "queue_wait_s": _hist(reg, "engine.queue.wait_s", **labels),
        "dispatch_latency_s": _hist(reg, "engine.dispatch.latency_s",
                                    **labels),
        "ingest": {
            "added_docs": reg.value("engine.ingest.added_docs", **labels),
            "delete_ops": reg.value("engine.ingest.delete_ops", **labels),
            "swaps": reg.value("engine.swaps", **labels),
        },
        # dispatches by phase-1 path (labelled by engine name) -- the
        # fused-kernel rollout gauge: a mixed fleet shows its
        # fused/composed split here
        "kernel_path": mix,
        "index": index_stats(index),
    }
    slowlog = getattr(engine, "slowlog", None)
    if slowlog is not None:
        out["slowlog"] = slowlog.stats()
    watch = getattr(engine, "compile_watch", None)
    if watch is not None:
        out["compile"] = _compile_stats(watch)
    return out


def _maintenance_stats(daemon) -> dict:
    return {
        "compactions": daemon.compactions,
        "merges": daemon.merges,
        "merges_by_group": daemon.metrics.series("maintenance.merges"),
        "reclaimed_by_group": daemon.metrics.series(
            "maintenance.merge.reclaimed"),
        "commits": daemon.commits,
        "failures": len(daemon.failures),
        "probe_readmits": len(daemon.probe_events),
        "compact_duration_s": _hist(daemon.metrics,
                                    "maintenance.compact.duration_s"),
        "merge_duration_s": _hist(daemon.metrics,
                                  "maintenance.merge.duration_s"),
    }


def cluster_stats(cluster) -> dict:
    """The cluster rollup.  ``groups`` is keyed by group id and carries
    each batcher's engine stats plus its health state (``up`` /
    ``down`` / ``drained`` -- ES STARTED/UNASSIGNED/excluded)."""
    reg = cluster.metrics
    health = cluster.health.snapshot()
    down, drained = set(health["down"]), set(health["drained"])
    groups = {}
    for g, b in enumerate(cluster.batchers):
        state = ("drained" if g in drained
                 else "down" if g in down else "up")
        groups[g] = {"health": state, **engine_stats(b)}
    out = {
        "n_groups": cluster.n_groups,
        "groups": groups,
        "requests": {
            "submitted": reg.value("cluster.requests.submitted"),
            "completed": reg.value("cluster.requests.completed"),
            "failed": reg.value("cluster.requests.failed"),
            "group_completed": {
                g: reg.value("cluster.requests.group_completed", group=g)
                for g in range(cluster.n_groups)},
        },
        "routing": {
            "spills": reg.value("cluster.routing.spills"),
            "failover_resubmits": reg.value("cluster.failover.resubmits"),
        },
        "health": {
            **health,
            "down_transitions": reg.total("health.down_transitions"),
            "readmits": reg.total("health.readmits"),
            "mark_ups": reg.total("health.mark_ups"),
        },
    }
    slowlog = getattr(cluster, "slowlog", None)
    if slowlog is not None:
        out["slowlog"] = slowlog.stats()
    watch = getattr(cluster, "compile_watch", None)
    if watch is not None:
        out["compile"] = _compile_stats(watch)
    if cluster.maintenance is not None:
        out["maintenance"] = _maintenance_stats(cluster.maintenance)
    if cluster.store is not None:
        out["store"] = store_stats(cluster.store)
    return out


def cluster_health(cluster) -> dict:
    """ES ``GET _cluster/health``: one green/yellow/red verdict derived
    from the HealthMap, plus everything an operator triages with --
    queue depths, in-flight restores, pending maintenance plans, and
    the transition ledger the verdict must reconcile against.

    Status derivation (the ES shard-allocation analogy, per replica
    group): **green** = every group routable; **yellow** = some groups
    down but at least one copy still serving (reduced redundancy, full
    availability -- exactly ES yellow); **red** = no routable group.

    Reconciliation contract (pinned by tests/test_torch_cluster.py):
    the ledger's ``down`` events equal the ``health.down_transitions``
    counter total one-for-one (likewise ``up``/``readmit``), and
    replaying the ledger lands on the reported down-set -- the verdict
    can never drift from the events that produced it."""
    reg = cluster.metrics
    h = cluster.health.snapshot()
    down = set(h["down"])
    up_groups = h["n_groups"] - len(down)
    status = ("green" if not down
              else "yellow" if up_groups else "red")
    queue_depths = {}
    for g, b in enumerate(cluster.batchers):
        with b._lock:
            queue_depths[g] = len(b._queue) + b._inflight
    maint = (cluster.maintenance.pending_plans()
             if cluster.maintenance is not None else [])
    return {
        "status": status,
        "n_groups": h["n_groups"],
        "up_groups": up_groups,
        "down": h["down"],
        "drained": h["drained"],
        "generation": h["generation"],
        "queue_depths": queue_depths,
        "pending_requests": sum(queue_depths.values()),
        "in_flight_restores": getattr(cluster, "restores_in_flight", 0),
        "restores_completed": reg.total("cluster.restores"),
        "pending_maintenance": maint,
        "transitions": list(cluster.health.transitions()),
        "counters": {
            "down_transitions": reg.total("health.down_transitions"),
            "readmits": reg.total("health.readmits"),
            "mark_ups": reg.total("health.mark_ups"),
        },
    }


def format_health_line(health: dict) -> str:
    """One ``_cat/health``-style line from a :func:`cluster_health`
    dict: status, routable groups, pending work, restore/maintenance
    activity, cluster-state generation."""
    parts = [f"health {health['status']} "
             f"groups={health['up_groups']}/{health['n_groups']}up"]
    if health["down"]:
        parts.append("down=" + ",".join(str(g) for g in health["down"]))
    if health["drained"]:
        parts.append("drained="
                     + ",".join(str(g) for g in health["drained"]))
    parts.append(f"pending={health['pending_requests']}")
    parts.append(f"restores={health['in_flight_restores']}")
    parts.append(f"maint={len(health['pending_maintenance'])}")
    parts.append(f"gen={health['generation']}")
    return " ".join(parts)


def store_stats(store) -> dict:
    """Translog + commit section (ES ``_stats/translog``).  Bytes are
    the on-disk sum over retained generation files -- what a trim
    reclaims."""
    from repro_torch.store.snapshot import latest_commit

    reg = store.metrics
    tl = store.translog
    tl_bytes = 0
    n_gens = 0
    try:
        for fn in os.listdir(store.path):
            if fn.startswith("translog-") and fn.endswith(".log"):
                n_gens += 1
                tl_bytes += os.path.getsize(os.path.join(store.path, fn))
    except OSError:  # pragma: no cover - dir raced away
        pass
    commit = latest_commit(store.path, validate=False)
    return {
        "path": store.path,
        "durability": store.durability,
        "translog": {
            "seqno": tl.seqno,
            "generation": tl.generation,
            "n_generations": n_gens,
            "bytes": tl_bytes,
        },
        "commit": (None if commit is None
                   else {"generation": commit.generation,
                         "seq": commit.seq}),
        "commits": reg.value("store.commits"),
        "recoveries": reg.value("store.recoveries"),
        "commit_duration_s": _hist(reg, "store.commit.duration_s"),
        "recovery_duration_s": _hist(reg, "store.recovery.duration_s"),
        # the incremental-commit evidence: last commit's changed bytes vs
        # the bytes it references (shared blobs make written << total)
        "commit_bytes": {
            "written_total": reg.value("store.commit.bytes_written"),
            "last_written": reg.value("store.commit.last_bytes_written"),
            "last_total": reg.value("store.commit.last_bytes_total"),
        },
    }


def _ms(v: Optional[float]) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "-"
    if math.isinf(v):
        return "inf"
    return f"{v * 1e3:.1f}ms"


def format_segments_line(stats: dict) -> str:
    """One ``_cat/segments``-style line from an :func:`index_stats` dict:
    base docs, then each sealed generation as ``rows-tombstones``, then
    the active buffer -- the operator's glanceable view of the segment
    story (``seg`` entries read ``rows(-dead)``)."""
    base = stats.get("n_docs", stats.get("n_ids", 0))
    parts = [f"segments base={base}"]
    for i, s in enumerate(stats.get("segments", ())):
        dead = f"-{s['tombstones']}" if s["tombstones"] else ""
        parts.append(f"seg{i}={s['rows']}{dead}")
    if stats.get("n_active"):
        dead = stats.get("active_tombstones", 0)
        parts.append(f"active={stats['n_active']}"
                     + (f"-{dead}" if dead else ""))
    if stats.get("n_reclaimed"):
        parts.append(f"reclaimed={stats['n_reclaimed']}")
    if stats.get("n_tombstones"):
        parts.append(f"tombstones={stats['n_tombstones']}")
    return " ".join(parts)


def _kernel_field(mix: dict) -> str:
    """``kernel=codes:5/fused:3`` -- the fused/composed dispatch mix,
    sorted by path name so the rendering is deterministic."""
    return "/".join(f"{k}:{v}" for k, v in sorted(mix.items())) or "-"


def format_stats_line(stats: dict) -> str:
    """One compact ``_cat``-style line from a cluster OR engine stats
    dict (the ``--stats-interval`` periodic printer)."""
    if "groups" in stats:                      # cluster rollup
        req = stats["requests"]
        waits = [g["queue_wait_s"] for g in stats["groups"].values()]
        disp = [g["dispatch_latency_s"] for g in stats["groups"].values()]
        pend = sum(g["pending"] for g in stats["groups"].values())
        up = sum(1 for g in stats["groups"].values()
                 if g["health"] == "up")
        p99s = [h["p99"] for h in disp if h["p99"] is not None]
        w50s = [h["p50"] for h in waits if h["p50"] is not None]
        mix: dict = {}
        for g in stats["groups"].values():
            for eng, v in g.get("kernel_path", {}).items():
                mix[eng] = mix.get(eng, 0) + v
        return (f"stats groups={up}/{stats['n_groups']}up "
                f"pending={pend} "
                f"done={req['completed']}/{req['submitted']} "
                f"failed={req['failed']} "
                f"spills={stats['routing']['spills']} "
                f"resubmits={stats['routing']['failover_resubmits']} "
                f"kernel={_kernel_field(mix)} "
                f"wait_p50={_ms(max(w50s) if w50s else None)} "
                f"dispatch_p99={_ms(max(p99s) if p99s else None)}")
    req = stats["requests"]                    # single engine
    occ = stats["batches"]["p50"]
    return (f"stats pending={stats['pending']} "
            f"done={req['completed']}/{req['submitted']} "
            f"failed={req['failed']} "
            f"occupancy_p50={'-' if occ is None else format(occ, '.2f')} "
            f"kernel={_kernel_field(stats.get('kernel_path', {}))} "
            f"wait_p50={_ms(stats['queue_wait_s']['p50'])} "
            f"dispatch_p99={_ms(stats['dispatch_latency_s']['p99'])}")
