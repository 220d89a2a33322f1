"""Doc-sharded search with the segment lifecycle (ingest, seal, delete,
merge, compact), S doc-shards x R replica groups on one device.

The layout is a :class:`repro_torch.launch.mesh.ShardMesh`; its axes are
named by :mod:`repro_torch.dist.sharding`, which also holds the parameter
sharding rules of the model families (read by the dry run and
``train/elastic.py``).
"""

from .shard_index import DEFAULT_SEAL_THRESHOLD, Segment, ShardedVectorIndex
from .sharding import (DATA_AXIS, MODEL_AXIS, REPLICA_AXIS, P, batch_axes,
                       generic_param_spec, lm_param_spec,
                       lm_param_spec_inference, opt_state_spec, tree_specs)

__all__ = ["ShardedVectorIndex", "Segment", "DEFAULT_SEAL_THRESHOLD",
           "DATA_AXIS", "MODEL_AXIS", "REPLICA_AXIS", "P", "batch_axes",
           "generic_param_spec", "lm_param_spec", "lm_param_spec_inference",
           "opt_state_spec", "tree_specs"]
