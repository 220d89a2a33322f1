"""The least work of a kernel call, and the least time an H100 could take.

A frozen copy of the port's analytic work models
(``src/repro_torch/obs/cost.py`` as of the first benchmark), so that a
change to the program cannot move the yardstick a roofline share is read
against.  Each model counts every input byte read once and every output
byte written once, and the operations the algorithm needs for the call.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates).  The integer compare / select / add of the code-match engines
runs on the CUDA cores; it is priced at the fp32 instruction rate (67
TFLOP/s counts an FMA as two operations, so 33.5e12 instructions a
second), which is an assumed peak: the data sheet gives no integer rate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM
CUDA_CORE_OPS_PER_S = 33.5e12      # 67 TFLOP/s fp32 non-tensor / 2 per FMA
INT8_TC_OPS_PER_S = 1979e12        # dense int8 tensor cores
OPS_PER_ELEMENT = 3                # compare, select, add per (q, doc, col)

PEAK = {"cuda_core": CUDA_CORE_OPS_PER_S,
        "int8_tensor_core": INT8_TC_OPS_PER_S}


class Work(NamedTuple):
    ops: float
    nbytes: int
    kind: str = "cuda_core"


def fused_phase1_work(d: int, Q: int, C: int, page: int, code_bytes: int,
                      live: bool) -> Work:
    """fused_phase1: the (d, C) codes, the queries' codes and weights and
    the live mask read once, the (Q, page) page written once; Q*d*C
    elements at OPS_PER_ELEMENT CUDA-core instructions each."""
    nbytes = (d * C * code_bytes + Q * C * (code_bytes + 4)
              + (d if live else 0) + Q * page * 8)
    return Work(OPS_PER_ELEMENT * Q * d * C, nbytes)


def quant_work(d: int, Q: int, n: int, page: int, live: bool) -> Work:
    """fused_phase1_quant on the int8 tensor cores: the int8 rows, scale,
    zero, live mask and queries read once, the page written once;
    2*Q*d*K*3 int8 operations (the queries as three int8 pieces, K = n
    padded to whole 32-code steps)."""
    nbytes = d * n + 8 * d + (d if live else 0) + Q * n * 4 + Q * page * 8
    return Work(2 * Q * d * (-(-n // 32) * 32) * 3, nbytes,
                "int8_tensor_core")


def rerank_work(Q: int, P: int, n: int, rows: int) -> Work:
    """The exact rescore of a page: ``rows`` distinct candidate rows read
    once, the ids and queries read once, the scores written once; one FMA
    per (query, candidate, feature)."""
    return Work(Q * P * n, rows * n * 4 + Q * P * 4 + Q * n * 4 + Q * P * 4)


def bound_s(work: Work) -> Tuple[float, str]:
    """-> (least seconds on an H100 SXM, ``"bytes"`` or ``"operations"``,
    whichever bounds it)."""
    t_bytes = work.nbytes / HBM_BYTES_PER_S
    t_ops = work.ops / PEAK[work.kind]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# kernel name -> (work model, the scorer named in its device kernels)
KERNELS = {
    "fused_phase1": (fused_phase1_work, "MatchScorer"),
    "fused_phase1_quant": (quant_work, "QuantScorer"),
}
