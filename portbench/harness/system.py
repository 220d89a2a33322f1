"""The system under test, built from a configuration file: the port's
index behind its batcher (``front: "batched"``) or behind the cluster
router (``front: "cluster"``).  Only here does the benchmark call into
the program: build, submit, add, close, and read its counters."""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


class System:
    """``submit(q, stream) -> Future`` of (ids, scores); ``add(rows)``;
    ``close()``; ``registry`` holds the program's counters; ``groups()``
    the served index of every replica group."""

    def __init__(self, config: dict, base: torch.Tensor, device,
                 wrap: Optional[Callable] = None):
        from repro_torch.core import TrimFilter
        from repro_torch.core.encoding import RoundingEncoder
        from repro_torch.core.search import VectorIndex
        from repro_torch.obs.metrics import MetricsRegistry

        self.config = config
        self.registry = MetricsRegistry()
        lay, bat = config["layout"], config["batcher"]
        enc = RoundingEncoder(int(config["encoder"]["precision"]))
        trim = (TrimFilter(float(config["trim"]))
                if config.get("trim") is not None else None)
        common = dict(batch_size=int(bat["batch_size"]),
                      max_wait_s=float(bat["max_wait_s"]),
                      k=int(config["k"]), page=int(config["page"]),
                      trim=trim, engine=config["engine"],
                      metrics=self.registry)
        index = VectorIndex.build(base, encoder=enc, device=device)
        if config["engine"] == "fused_int8":
            index.quantized            # one int8 table, shared by the groups
        wrap = wrap or (lambda idx: idx)
        if lay["front"] == "batched":
            from repro_torch.serve.engine import BatchedSearchEngine

            self.engine = BatchedSearchEngine(wrap(index), **common)
            self._cluster = None
        elif lay["front"] == "cluster":
            from repro_torch.cluster.router import ClusterEngine
            from repro_torch.launch.mesh import make_shard_mesh

            mesh = make_shard_mesh(int(lay["shards"]), int(lay["replicas"]),
                                   device=device)
            sharded = index.shard(mesh)
            del index
            groups = [wrap(sharded.replica_group(g))
                      for g in range(sharded.n_replicas)]
            del sharded
            cl = config["cluster"]
            self._cluster = self.engine = ClusterEngine(
                groups, merge=cl["merge"],
                spill_factor=float(cl["spill_factor"]),
                auto_compact=cl.get("auto_compact"), **common)
        else:
            raise ValueError(f"unknown front {lay['front']!r}")

    @property
    def n_groups(self) -> int:
        return 1 if self._cluster is None else self._cluster.n_groups

    def submit(self, q: np.ndarray, stream: int = -1):
        if self._cluster is None:
            return self.engine.submit(q)
        return self._cluster.submit(q, stream=None if stream < 0 else
                                    int(stream))

    def submit_to_group(self, q: np.ndarray, g: int):
        """Warm-up: one query straight to group ``g``'s batcher."""
        if self._cluster is None:
            return self.engine.submit(q)
        return self._cluster.batchers[g].submit(q)

    def add(self, rows: np.ndarray) -> int:
        return self.engine.add_documents(rows)

    def groups(self) -> List:
        if self._cluster is None:
            return [self.engine.index]
        return [self._cluster.group_index(g)
                for g in range(self._cluster.n_groups)]

    def close(self) -> None:
        self.engine.close()
