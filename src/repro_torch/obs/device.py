"""Device-resident index memory accounting (what is holding memory, where).

The serving index is a set of tensors -- base shards, append buffers,
sealed segments, posting tables, lazily derived int8 quant tables -- and
the first question an operator asks when a card fills up is *which part
of the index owns those bytes, and on which device do they live?*  ES
answers it with ``_nodes/stats`` (``indices.store.size_in_bytes`` per
node) and ``_cat/segments`` (bytes per segment); this module is that
ledger, with the JAX package's names and keys:

* :func:`device_bytes` walks every resident leaf an index holds --
  including the quant-table caches that are not dataclass fields -- and
  returns exact byte totals per leaf, per section (``base`` / ``active``
  / ``segments`` / ``quant``, or ``index`` for a flat
  :class:`~repro_torch.core.VectorIndex`), and per physical device.
* the accounting is *computed*, never measured: byte counts come from
  shapes, dtypes and storage sizes, so the walk costs no device
  synchronisation and is safe to poll from the serving path.

**Aliases are storages.**  The port's shards are views of the flat
index's tensors (:meth:`ShardedVectorIndex.from_index`) and its replica
groups share tensors (:meth:`ShardedVectorIndex.replica_group`), so one
Python object per leaf is the wrong identity in both directions.  A
leaf is keyed by its view of a storage -- (device, storage address,
storage offset, shape, stride, dtype) -- so one view reached twice
counts once and is reported in ``aliased_leaves``; a tensor of no bytes
has no storage to share and is never an alias.  ``total_bytes`` is the
sum over unique views, as in the JAX package.  ``per_device`` is each
distinct storage's ``nbytes`` once, on its tensor's device: what the card
pays, which may exceed the views when a view covers part of a storage.

**Stated deviation.**  The JAX package charges a leaf replicated over
the ``replica`` mesh axis once per device that holds a copy (2 x the
total at 4 shards x 2 groups).  Here every cell of a mesh is one device
and the groups hold one copy, so ``per_device`` counts it once.

**Reconciliation** keeps the JAX package's five keys.  On the card
``process_live_bytes`` is ``torch.cuda.memory_allocated`` of each CUDA
device the index uses and ``accounted_bytes`` the storage bytes of the
leaves on those devices (so accounted <= live: "what else is holding
memory" is the difference).  On the CPU, which keeps no allocator
count, both come from storage identity: ``accounted_bytes`` is the
unique views' bytes and ``process_live_bytes`` the bytes of the
storages those views keep alive.  ``process_live_arrays`` (the JAX
package's count of every live array in the process) has no counterpart
and holds ``None``.

Both indexes expose their leaves through ``resident_leaves()``, an
iterator of ``(path, section, tensor)`` triples; the flat
:class:`~repro_torch.core.VectorIndex` yields the paths the JAX
package's tree walk gives its flat index.  Wrapper indexes (the
cluster's failpoint wrapper, ``DurableIndex``) proxy attribute access,
so the walk sees through them.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

__all__ = ["device_bytes", "resident_leaf_entries", "resident_storages",
           "format_device_line"]

_MB = 1024.0 * 1024.0


def resident_leaf_entries(index) -> Iterator[Tuple[str, str, object]]:
    """``(path, section, tensor)`` for every device-resident leaf of
    ``index``: its ``resident_leaves()`` (the sharded index's includes
    the quant caches)."""
    yield from index.resident_leaves()


def _view_key(t: torch.Tensor):
    """One view of one storage: the identity a leaf is deduplicated by."""
    return (str(t.device), t.untyped_storage().data_ptr(),
            t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)


def _storage_key(t: torch.Tensor):
    return str(t.device), t.untyped_storage().data_ptr()


def _dtype_name(dtype: torch.dtype) -> str:
    """``float32``, ``int8``, ``bool``: the numpy name, as JAX prints it."""
    return str(dtype).rsplit(".", 1)[-1]


def resident_storages(index, skip_sections=()) -> Dict[tuple, tuple]:
    """``{(device, storage address): (device, storage nbytes)}`` for the
    storages behind ``index``'s leaves (those of ``skip_sections``
    left out): what the card pays, each storage once.  Two indexes'
    dicts answer which bytes one holds that the other does not."""
    out = {}
    for _path, section, t in resident_leaf_entries(index):
        if section in skip_sections or t.untyped_storage().nbytes() == 0:
            continue
        out[_storage_key(t)] = (str(t.device), t.untyped_storage().nbytes())
    return out


def device_bytes(index, *, reconcile: bool = True) -> dict:
    """Exact index-resident byte accounting: per leaf, per section, per
    device.

    Returns a JSON-ready dict::

        {"total_bytes": int,          # sum of unique view nbytes
         "sections": {section: bytes},
         "leaves": [{"path", "section", "shape", "dtype", "nbytes"}],
         "per_device": {device: bytes},   # each storage once
         "n_leaves": int, "aliased_leaves": int,
         "reconciliation": {...}}

    ``reconcile=False`` skips the allocator reads (a poller on a hot
    path may skip them).  Reads no tensor's values."""
    leaves = []
    leaf_devices = []
    sections: dict = {}
    seen: set = set()
    total = 0
    aliased = 0
    for path, section, t in resident_leaf_entries(index):
        nbytes = t.numel() * t.element_size()
        if nbytes:
            key = _view_key(t)
            if key in seen:
                aliased += 1
                continue
            seen.add(key)
        total += nbytes
        sections[section] = sections.get(section, 0) + nbytes
        leaves.append({
            "path": path,
            "section": section,
            "shape": tuple(int(d) for d in t.shape),
            "dtype": _dtype_name(t.dtype),
            "nbytes": nbytes,
        })
        leaf_devices.append(str(t.device))
    per_device: dict = {}
    for dev, nb in resident_storages(index).values():
        per_device[dev] = per_device.get(dev, 0) + nb
    out = {
        "total_bytes": total,
        "sections": dict(sorted(sections.items())),
        "leaves": leaves,
        "per_device": dict(sorted(per_device.items())),
        "n_leaves": len(leaves),
        "aliased_leaves": aliased,
    }
    if reconcile:
        out["reconciliation"] = _reconcile(leaf_devices, total, per_device)
    return out


def _reconcile(leaf_devices, total: int, per_device: dict) -> dict:
    cuda = [d for d in per_device if d.startswith("cuda")]
    if cuda:
        accounted = sum(per_device[d] for d in cuda)
        live = sum(torch.cuda.memory_allocated(torch.device(d))
                   for d in cuda)
        live_leaves = sum(1 for d in leaf_devices if d in cuda)
    else:
        accounted = total
        live = sum(per_device.values())
        live_leaves = len(leaf_devices)
    return {
        # index bytes found where the process says memory is live
        "accounted_bytes": int(accounted),
        "live_leaves": int(live_leaves),
        # the process truth: the allocator's count on the card, the
        # storages the index keeps alive on the CPU
        "process_live_bytes": int(live),
        "process_live_arrays": None,
        "device_resident_bytes": int(sum(per_device.values())),
    }


def format_device_line(dev: dict) -> str:
    """One ``_cat``-style line from a :func:`device_bytes` dict: total,
    per-section split, device count -- the glanceable "what is holding
    memory" view."""
    parts = [f"device_bytes total={dev['total_bytes'] / _MB:.2f}MB"]
    for section, b in dev["sections"].items():
        parts.append(f"{section}={b / _MB:.2f}MB")
    parts.append(f"leaves={dev['n_leaves']}")
    if dev.get("per_device"):
        parts.append(f"devices={len(dev['per_device'])}")
    return " ".join(parts)
