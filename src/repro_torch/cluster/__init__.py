"""Serving control plane over the doc-sharded data plane.

The paper's production claim is that a fulltext-engine-backed vector
database inherits Elasticsearch's robustness/stability/scalability.  The
data plane (:mod:`repro_torch.dist`) reproduces the *index* side of that
claim -- doc-shards, replica copies, segments, tombstones.  This package
is the *cluster* side: the machinery that keeps serving when copies die,
keeps QPS scaling with replicas, and keeps segments healthy in the
background.  It is the JAX package's ``repro.cluster``, module for module
and under its names.  Every component maps onto an ES concept:

===============================  ==========================================
this package                     Elasticsearch analogue
===============================  ==========================================
:class:`ClusterEngine`           the coordinating node's request routing:
(:mod:`~repro_torch.cluster.     R independent request batchers, one per
router`)                         replica group (R concurrent search
                                 programs where the groups sit on
                                 disjoint devices; on one card their
                                 kernels share its default stream);
                                 stream affinity = ``preference=
                                 <custom_string>`` user stickiness;
                                 least-loaded spill = adaptive replica
                                 selection.
:class:`HealthMap`               the cluster state's routing table (shard
(:mod:`~repro_torch.cluster.     copies ``STARTED``/``UNASSIGNED``);
health`)                         ``mark_down``/``mark_up`` = shard-failed
                                 / shard-started cluster-state updates,
                                 ``generation`` = cluster-state version.
failover resubmit                ES retrying a failed shard fetch on the
(in :class:`ClusterEngine`)      next copy of the same shard -- here the
                                 whole request replays on a surviving
                                 group and results stay bit-identical,
                                 because every group computes
                                 bit-identical results.
:class:`MaintenanceDaemon` +     Lucene's ConcurrentMergeScheduler +
:class:`TieredMergePolicy`       TieredMergePolicy: each sweep plans per
(:mod:`~repro_torch.cluster.     replica group -- first a delete-heavy
maintenance`)                    segment rewrite (``index.merge.policy
                                 .deletes_pct_allowed``, consulting
                                 PER-SEGMENT deleted ratios), else a fold
                                 of ``merge_factor`` similar-sized sealed
                                 segments, else (only past the global
                                 tombstone threshold) the demoted full
                                 compact -- and applies concurrently
                                 across groups, off the query path,
                                 installing via the ``swap_index`` CAS so
                                 no in-flight query is dropped.  Given a
                                 durability store (:mod:`repro_torch.
                                 store`), it also rolls a commit point
                                 after each pass and trims the replayed
                                 translog -- the ES flush that follows a
                                 merge.
canary health probing            the master pinging an unresponsive node
(``MaintenanceDaemon.            and re-promoting its shard copies once
probe_once``)                    it answers: downed groups get a canary
                                 query each tick and ``mark_up`` when it
                                 succeeds -- re-admission without manual
                                 intervention.
``ClusterEngine.restore_group``  replica recovery from the primary's
                                 translog: a group whose MEMORY is gone
                                 rebuilds from commit point + translog
                                 replay (:mod:`repro_torch.store`) onto
                                 its own mesh column and rejoins,
                                 bit-identical to its surviving siblings.
===============================  ==========================================

The data-plane hooks these build on live in
:class:`repro_torch.dist.shard_index.ShardedVectorIndex`:
``replica_group(g)`` (a replica column as an independent one-group index
-- group addressability), ``search(..., live_groups=...)`` (the
health-masked merge), and ``tombstone_ratio`` / exact-df deletes (the
maintenance trigger).  The cluster's ``stats()`` and ``cluster_health()``
are assembled by :mod:`repro_torch.obs.stats`.
"""

from repro_torch.cluster.health import HealthMap
from repro_torch.cluster.maintenance import (MaintenanceDaemon,
                                             TieredMergePolicy)
from repro_torch.cluster.router import ClusterEngine

__all__ = ["ClusterEngine", "HealthMap", "MaintenanceDaemon",
           "TieredMergePolicy"]
