"""Operation census of an eager step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference reads FLOPs and bytes from the compiled, partitioned HLO
text, multiplying each ``while`` body by its trip count.  Eager PyTorch
has no HLO: :class:`OpAnalysis` is a ``TorchDispatchMode`` that sees
every aten op a function runs (the forward, an autograd backward and a
checkpoint's recompute alike), on any device, the ``meta`` device
included, where no op computes anything.  A Python loop runs every
iteration, so no trip count has to be recovered.  Per op:

* **dot_flops** -- ``2 * prod(result) * contracted`` for ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` (what ``einsum`` and ``matmul``
  decompose into) and every other op with a formula registered in
  ``torch.utils.flop_counter`` (convolutions, fused attention);
* **flops** -- dot FLOPs plus one FLOP per output element of each
  elementwise op (aten's ``pointwise`` tag, and dtype conversions:
  hlo_analysis's elementwise set, ``convert`` included); reductions and
  data movement count none, as there;
* **bytes** -- each op's result bytes plus its tensor operands' bytes.
  Eager execution fuses nothing, so this is what the ops move, one at a
  time; the reference counts at fusion boundaries, so the two differ by
  what XLA fuses.  Views (a result aliasing an operand, unwritten) and
  uninitialised allocations (``empty``) move nothing and count none;
* **ops** -- the number of aten ops dispatched, views included.

A composite op (``matmul``, ``einsum``) that reaches the census whole,
as it does under ``inference_mode``, is counted as the ops it decomposes
into, as autograd would have dispatched them.

A hand-written kernel is not an aten op.  Its wrapper marks each call
with :func:`repro_torch.obs.cost.kernel_call`, and the census counts the
call as one op of the kernel's analytic work (its ``ops`` into ``flops``,
its ``nbytes`` into ``bytes``, its launch under ``kernels``), on the card
and on the plain path alike: the plain version's own aten ops inside the
call are not counted, so a step's census does not depend on the device.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.obs import cost

__all__ = ["OpAnalysis", "analyze"]

_aten = torch.ops.aten
_CONVERTS = {_aten._to_copy, _aten.copy_, _aten.copy}
_EMPTY = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
          _aten.new_empty_strided}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as oa: fn(...)`` -> ``oa.result()``."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.elementwise_flops = 0
        self.kernel_flops = 0.0
        self.bytes = 0
        self.ops = 0
        self.kernels: Counter = Counter()
        self._depth = 0          # inside a kernel call: its ops not counted
        self._listening = None

    # --------------------------------------------- hand-written kernels
    def enter(self, program: str, work) -> None:
        if self._depth == 0:
            self.kernels[program] += 1
            self.kernel_flops += work.ops
            self.bytes += int(work.nbytes)
            self.ops += 1
        self._depth += 1

    def exit(self) -> None:
        self._depth -= 1

    def __enter__(self):
        self._listening = cost.kernel_listener(self)
        self._listening.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listening.__exit__(*exc)

    # --------------------------------------------------------- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth:
            return func(*args, **kwargs)
        if func.overloadpacket not in flop_counter.flop_registry:
            # a composite op reaches the mode whole where autograd is off
            # (``inference_mode``): count the ops it decomposes into
            TorchDispatchMode.__enter__(self)
            try:
                r = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if packet in flop_counter.flop_registry:
            self.dot_flops += int(flop_counter.flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.elementwise_flops += sum(t.numel() for t in outs)
        elif packet in _CONVERTS:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if ins and outs and ins[-1].dtype != outs[0].dtype:
                self.elementwise_flops += outs[0].numel()
        if packet in _EMPTY or _is_view(func):
            return out
        operands = [t for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, outs)) + sum(map(_nbytes, operands))
        return out

    def result(self) -> Dict[str, Any]:
        flops = self.dot_flops + self.elementwise_flops + self.kernel_flops
        return {"flops": float(flops), "dot_flops": float(self.dot_flops),
                "elementwise_flops": float(self.elementwise_flops),
                "kernel_flops": float(self.kernel_flops),
                "bytes": float(self.bytes), "ops": self.ops,
                "kernels": dict(self.kernels)}


def analyze(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpAnalysis` ->
    (its output, the census)."""
    with OpAnalysis() as oa:
        out = fn(*args, **kwargs)
    return out, oa.result()
