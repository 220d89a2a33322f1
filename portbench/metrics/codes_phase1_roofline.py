"""Phase 1's share of its roofline on the ``codes`` engine: 100 x the
least time of a batch's phase 1 (``portbench/roofline/codes.py``:
``fused_phase1``'s frozen bound at the cell's shapes, scaled by the
window's ``search.codes.cells`` a batch over Q·d·C) over the mean device
time of a batch's phase 1 in the traced window.  None untraced, or where
the program counts no comparisons.

A batch's phase 1 is every device operation of the window but the copies
to and from the host and the rescore's own kernels (:data:`NOT_PHASE1`),
as ``postings_phase1_roofline`` reads it.  In a traced 30 s window of the
cell (NVIDIA H100 80GB HBM3, 700 W; device seconds over 75 batches of 798
doc blocks) they were:

* each block's cast of its {0, 1} match to float32,
  ``unrolled_elementwise_kernel<direct_copy_kernel_cuda...>`` (11.78 s);
  its compare, ``elementwise_kernel<...CompareEqFunctor<signed char>>``
  (10.58 s); its ``bmm``, cuBLAS's ``gemv2T_kernel_val`` (6.70 s); its
  write into the (Q, d) matrix, ``elementwise_kernel<128, 2,
  ...direct_copy_kernel_cuda...>`` (0.15 s);
* the page's cut, the ``page_select_*`` kernels (0.06 s), and encode's
  kernels (a norm, a dozen elementwise ones, its ``searchsorted``).

The rescore's product runs as cuBLAS's ``gemvx`` kernel, a name the
blocks' ``bmm`` does not use.  The rescore's small copies and its
scatter-gather (under 10 us a batch) have names phase 1 also uses and are
counted with it."""

from portbench.roofline.codes import least_phase1_s

# copies to and from the host, and the rescore's own kernels: its
# product (gemvx), its page-of-320 sort and its final gather
NOT_PHASE1 = ("Memcpy HtoD", "Memcpy DtoH", "gemvx", "radixSortKVInPlace",
              "vectorized_gather_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    batches, _ = run.hist_delta("engine.dispatch.latency_s")
    cells = run.counter_delta("search.codes.cells")
    if not batches or not cells:
        return None
    dev_s = sum(b - a for n, a, b in tr.ops
                if not any(p in n for p in NOT_PHASE1)) * 1e-9
    if dev_s <= 0:
        return None
    return 100.0 * least_phase1_s(run.config, cells / batches) / (
        dev_s / batches)
