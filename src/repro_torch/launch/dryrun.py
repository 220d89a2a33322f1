"""Dry run: trace every (arch x shape) cell once and record what a step
costs and what each device of the production meshes would hold.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all+paper --mesh both

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell on 512 virtual CPU devices.  Here each cell's
``fn`` runs once on its abstract (``meta``) arguments under the op
census of ``launch/op_analysis.py`` (the counterpart of
``launch/hlo_analysis.py``): no memory is allocated and nothing is
computed, but every op the step runs is seen.  ``--device cpu`` (or
``cuda``) runs the step for real instead, on arguments of zeros.  Per
cell and mesh it writes ``<out>/<mesh>/<arch>__<shape>.json`` with the
reference's record keys; existing records are skipped unless
``--force``.

Where the record differs from the reference's:

* ``flops_per_device``, ``dot_flops_per_device`` and ``bytes_per_device``
  are the whole step's: no partitioner splits the step over devices, so
  the global counts do not depend on the mesh, and one trace serves both
  meshes;
* ``collective_bytes_per_device`` and ``collective_breakdown`` are
  ``null``: one device runs no collective, and the census of the
  collectives waits for placement on several cards;
* ``xla_flops_per_device``, ``xla_bytes_per_device``, ``hlo_lines``,
  ``lower_s`` and ``compile_s`` are ``null``: there is no compiler;
  ``trace_s`` is the seconds of the traced step;
* ``memory_analysis`` holds ``argument_size_in_bytes`` (the arguments'
  bytes) and ``output_size_in_bytes`` (the outputs' bytes), both whole,
  and ``temp_size_in_bytes: null``;
* ``input_bytes_per_device`` is the reference's exactly: each argument's
  bytes over the product of the mesh axes its spec names.

A ``meta`` step counts the FLOPs a real one does, op for op.  Its bytes
can differ from a real step's by data movement a ``meta`` tensor cannot
show: it has no address, so a model's ``load_tree`` finds every stacked
leaf "already in place" and skips the write-back, and a Python constant
becomes a tensor by other ops.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import P
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.train.tree import as_tree, tree_leaves, tree_map

__all__ = ["run_cell", "trace_cell", "materialize", "main"]


def _flat_args(args) -> list:
    """The arguments' tensors in the reference's flatten order (a model
    as its ``tree()``)."""
    return [leaf for a in args for leaf in tree_leaves(as_tree(a))
            if isinstance(leaf, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _analytic_arg_bytes(args, in_specs, mesh) -> int:
    """Per-device bytes of the inputs under their specs (params + state +
    batch)."""
    total = 0
    flat_args = _flat_args(args)
    flat_specs = tree_leaves(in_specs)
    if len(flat_args) != len(flat_specs):
        raise ValueError(f"{len(flat_args)} argument leaves, "
                         f"{len(flat_specs)} specs")
    for a, s in zip(flat_args, flat_specs):
        if not isinstance(s, P):
            raise TypeError(f"a spec leaf must be a P, got {s!r}")
        size = np.prod(a.shape, dtype=np.int64) if a.shape else 1
        shard = 1
        for axes in s:
            if axes is None:
                continue
            for ax in (axes if isinstance(axes, tuple) else (axes,)):
                shard *= mesh.shape[ax]
        total += int(size) * a.element_size() // max(shard, 1)
    return total


def materialize(args, device) -> tuple:
    """The abstract arguments as zeros on ``device`` (a model moved there
    in place, its parameters zeroed): every id is 0, in range."""
    def one(a):
        if isinstance(a, torch.nn.Module):
            a.to_empty(device=device)
            with torch.no_grad():
                for p in a.parameters():
                    p.zero_()
            return a
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=device), a)
    return tuple(one(a) for a in args)


def trace_cell(cell, device="meta") -> Dict[str, Any]:
    """Run ``cell.fn`` once under the op census -> the census, with
    ``trace_s`` and the arguments' and outputs' whole bytes."""
    device = torch.device(device)
    args = cell.args if device.type == "meta" else materialize(cell.args,
                                                               device)
    arg_bytes = _nbytes(_flat_args(args))
    t0 = time.perf_counter()
    with OpAnalysis() as oa:
        out = cell.fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace_s = time.perf_counter() - t0
    outs = out if isinstance(out, tuple) else (out,)
    census = oa.result()
    census.update(trace_s=trace_s, device=str(device),
                  argument_size_in_bytes=arg_bytes,
                  output_size_in_bytes=_nbytes(_flat_args(outs)))
    return census


def run_cell(cell, mesh, mesh_name: str, out_dir: str, force: bool = False,
             device="meta", census: Optional[Dict[str, Any]] = None):
    """The cell's record on ``mesh`` (read back if written before and not
    ``force``).  ``census``, a dict the meshes of one cell share, holds
    its trace: an empty one is filled by this call's trace, a filled one
    is used as it is."""
    path = os.path.join(out_dir, mesh_name, f"{cell.arch}__{cell.shape}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if census is None:
        census = {}
    if not census:
        census.update(trace_cell(cell, device))
    record = {
        "arch": cell.arch,
        "shape": cell.shape,
        "kind": cell.kind,
        "mesh": mesh_name,
        "mesh_shape": dict(mesh.shape),
        "note": cell.note,
        # the whole step's (launch/op_analysis.py): no partitioner
        "flops_per_device": census["flops"],
        "dot_flops_per_device": census["dot_flops"],
        "bytes_per_device": census["bytes"],
        "collective_bytes_per_device": None,
        "collective_breakdown": None,
        "xla_flops_per_device": None,
        "xla_bytes_per_device": None,
        "input_bytes_per_device": _analytic_arg_bytes(cell.args,
                                                      cell.in_specs, mesh),
        "memory_analysis": {
            "argument_size_in_bytes": census["argument_size_in_bytes"],
            "output_size_in_bytes": census["output_size_in_bytes"],
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
        },
        "lower_s": None,
        "compile_s": None,
        "hlo_lines": None,
        "trace_s": round(census["trace_s"], 2),
        "device": census["device"],
        "elementwise_flops": census["elementwise_flops"],
        "kernel_flops": census["kernel_flops"],
        "ops": census["ops"],
        "kernels": census["kernels"],
    }
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    from repro_torch.configs import ALL_IDS, ARCH_IDS, arch_shapes, get_arch
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all' (10 assigned), or 'all+paper'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (abstract, the default), cpu or cuda")
    args = ap.parse_args(argv)

    if args.arch == "all":
        arch_ids = ARCH_IDS
    elif args.arch == "all+paper":
        arch_ids = ALL_IDS
    else:
        arch_ids = [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    t_all = time.perf_counter()
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        shapes = arch_shapes(arch_id) if args.shape == "all" else [args.shape]
        for shape in shapes:
            census = {}               # one trace serves both meshes
            for multi in meshes:
                mesh_name = "multi_2x16x16" if multi else "single_16x16"
                mesh = make_production_mesh(multi_pod=multi)
                cell = arch.cell(shape, mesh)
                if cell is None:
                    print(f"SKIP  {arch_id:28s} {shape:16s} {mesh_name} (by rule)")
                    continue
                try:
                    t0 = time.perf_counter()
                    rec = run_cell(cell, mesh, mesh_name, args.out,
                                   force=args.force, device=args.device,
                                   census=census)
                    print(f"OK    {arch_id:28s} {shape:16s} {mesh_name} "
                          f"flops={rec['flops_per_device']:.3e} "
                          f"in/dev={rec['input_bytes_per_device']:.3e} "
                          f"trace={rec['trace_s']}s "
                          f"({time.perf_counter()-t0:.0f}s)", flush=True)
                except Exception as e:
                    failures.append((arch_id, shape, mesh_name, repr(e)))
                    print(f"FAIL  {arch_id:28s} {shape:16s} {mesh_name}: {e!r}")
                    traceback.print_exc()
    print(f"\ntotal {time.perf_counter() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall requested dry-run cells traced")


if __name__ == "__main__":
    main()
