"""Axis names, and declarative parameter-sharding rules.

``data`` partitions the corpus into contiguous doc-shards (and, for the
model families, the batch); ``replica`` holds R serving copies of every
shard, across which query batches round-robin -- a pure QPS axis, never a
placement one; ``model`` is the tensor- and expert-parallel axis.

A *rule* is ``rule(path, leaf, mesh) -> P``; :func:`tree_specs` maps one
over a parameter tree (a model's is its ``tree()``, the reference's
stacked tree).  Rules read only ``mesh.shape`` and ``mesh.axis_names``,
and are divisibility-aware: every axis placement checks that the dim
divides the mesh axis and falls back to replication (``None``), so one
rule serves every architecture on every mesh.  They are the JAX
package's ``dist/sharding.py`` rules entry for entry:

* **FSDP** -- weight matrices shard their d_model-sized dim over ``data``.
* **TP**   -- attention shards the *head* dim over ``model`` (never d_head);
  dense/shared FFNs shard d_ff over ``model``; the unembed shards vocab
  over ``model``.
* **EP**   -- MoE expert weights shard the expert dim over ``model`` when
  it divides, else fall back to TP over d_ff.
* **Embeddings** are never vocab-sharded (token gather stays shard-local).
* Vectors/scalars (norms, biases, routers) replicate.

Leading stacked-layer dims are always ``None``: layers run one after
another.  On one card a spec is checked and recorded (the dry run's
per-device bytes, ``train/elastic.py``'s placement); splitting a leaf
across cards waits for a machine with several.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np

from repro_torch.train.tree import tree_map_with_path

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "REPLICA_AXIS",
    "P",
    "batch_axes",
    "tree_specs",
    "lm_param_spec",
    "lm_param_spec_inference",
    "generic_param_spec",
    "opt_state_spec",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"

# leaves replicate below this size under generic rules (a 16 MB f32 table)
_GENERIC_MIN_SIZE = 1 << 22

Entry = Union[None, str, Tuple[str, ...]]


class P:
    """A partition spec: one entry a leading dim, each ``None``
    (replicated), an axis name, or a tuple of names (the dim split over
    their product; a tuple of one name is that name, as JAX's
    ``PartitionSpec`` keeps it).  Immutable; equal by its entries; a leaf
    of every tree (it is not a tuple)."""

    __slots__ = ("_parts",)

    def __init__(self, *parts: Entry):
        for p in parts:
            ok = p is None or isinstance(p, str) or (
                isinstance(p, tuple) and all(isinstance(a, str) for a in p))
            if not ok:
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of names, got {p!r}")
        parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                      for p in parts)
        object.__setattr__(self, "_parts", parts)

    def __setattr__(self, name, value):
        raise AttributeError("P is immutable")

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(("P", self._parts))

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 else \
            f"P({self._parts[0]!r})"


def batch_axes(mesh) -> tuple:
    """Every data-parallel mesh axis, outermost first (pod before data)."""
    return tuple(a for a in ("pod", DATA_AXIS) if a in mesh.axis_names)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        key = getattr(entry, "key", getattr(entry, "name", None))
        if key is not None:
            return str(key)
    return ""


def _axis_if(mesh, axis: str, dim_size: int) -> Optional[str]:
    """``axis`` when it exists and divides ``dim_size``, else None."""
    if axis not in mesh.axis_names:
        return None
    n = int(mesh.shape[axis])
    return axis if dim_size % n == 0 and dim_size >= n else None


def lm_param_spec(path, leaf, mesh) -> P:
    """Sharding rule for the transformer LM parameter tree."""
    name = _leaf_name(path)
    s = tuple(leaf.shape)
    data = lambda d: _axis_if(mesh, DATA_AXIS, s[d])
    model = lambda d: _axis_if(mesh, MODEL_AXIS, s[d])

    if name == "embed" and len(s) == 2:                  # (V, D)
        return P(None, data(1))                          # gather-safe: V whole
    if name == "unembed" and len(s) == 2:                # (D, V)
        return P(data(0), model(1))
    if name in ("wq", "wk", "wv") and len(s) == 4:       # (L, D, H|KV, dh)
        return P(None, data(1), model(2), None)
    if name == "wo" and len(s) == 4:                     # (L, H, dh, D)
        return P(None, model(1), None, data(3))
    if name in ("wg", "wu") and len(s) == 4:             # MoE (L, E, D, F)
        if model(1) is not None:                         # expert parallelism
            return P(None, MODEL_AXIS, None, data(3))
        return P(None, None, data(2), model(3))          # TP fallback
    if name == "wd" and len(s) == 4:                     # MoE (L, E, F, D)
        if model(1) is not None:
            return P(None, MODEL_AXIS, data(2), None)
        return P(None, None, model(2), data(3))
    if name in ("wg", "wu") and len(s) == 3:             # dense/shared (L, D, F)
        return P(None, data(1), model(2))
    if name == "wd" and len(s) == 3:                     # dense/shared (L, F, D)
        return P(None, model(1), data(2))
    return P()                                           # norms, biases, router


def lm_param_spec_inference(path, leaf, mesh) -> P:
    """TP-only variant for serving: weights stay resident (no per-layer
    FSDP gathers on the latency path); only ``model`` placements kept."""
    spec = lm_param_spec(path, leaf, mesh)
    return P(*(p if p == MODEL_AXIS else None for p in spec))


def generic_param_spec(path, leaf, mesh) -> P:
    """Family-agnostic rule (GNN / recsys): row-shard only leaves big
    enough to matter (embedding tables) over ``model``; replicate the
    rest."""
    s = tuple(leaf.shape)
    if (len(s) >= 1 and int(np.prod(s)) >= _GENERIC_MIN_SIZE
            and _axis_if(mesh, MODEL_AXIS, s[0]) is not None):
        return P(MODEL_AXIS, *(None,) * (len(s) - 1))
    return P()


def opt_state_spec(param_spec: P, ndim: int, which: str) -> P:
    """Adafactor factored-stat specs: ``vr`` reduces away the last dim,
    ``vc`` the second-to-last; the surviving dims keep the param
    placement."""
    parts = list(param_spec) + [None] * (ndim - len(param_spec))
    if which == "vr":
        del parts[ndim - 1]
    elif which == "vc":
        del parts[ndim - 2]
    else:
        raise ValueError(f"unknown factored stat {which!r}")
    return P(*parts)


def tree_specs(tree, mesh, rule: Callable):
    """Map ``rule`` over a parameter tree -> a tree of :class:`P`."""
    return tree_map_with_path(lambda path, leaf: rule(path, leaf, mesh), tree)
