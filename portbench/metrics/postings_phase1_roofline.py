"""Phase 1's share of its roofline on the ``postings`` engine: 100 x the
least time of a batch's phase 1 (``portbench/roofline/postings.py``: the
least of the walk's bound at the window's mean posting entries a batch,
``search.postings.entries`` over the batches dispatched, and the scan's
bound) over the mean device time of a batch's phase 1 in the traced
window.  None untraced, or where the program counts no posting entries.

A batch's phase 1 is every device operation of the window but the copies
to and from the host and the rescore's own kernels (:data:`NOT_PHASE1`).
In a traced 30 s window of the cell (NVIDIA H100 80GB HBM3, 700 W;
device seconds over 324 batches) they were:

* the expansions of the kept posting ranges: ``compute_cuda_kernel<long>``
  (``repeat_interleave``, 7.89 s), ``_scatter_gather_elementwise_kernel``
  (its gathers, 3.25 s), ``CUDAFunctor_add<long>`` (3.57 s),
  ``arange_cuda_out`` (1.47 s), ``index_elementwise_kernel`` (the doc
  ids' gather, 1.07 s), ``DeviceScanKernel`` / ``DeviceScanInitKernel``
  (``cumsum``), ``MulFunctor<long>``;
* the rounds: ``indexFuncLargeIndex<float, ...ReduceAdd>`` (400 a batch,
  7.28 s), and ``indexFuncLargeIndex<long, ...>`` (the entry counts);
* the accumulator's fill, ``FillFunctor<float>``; the lookup,
  ``searchsorted_cuda_kernel``; the kept tokens, ``DeviceSelectSweep``,
  ``DeviceCompactInit``, ``DeviceReduce*``, ``write_indices``;
* the page's sort: ``DeviceRadixSortOnesweepKernel`` (2.22 s),
  ``DeviceRadixSortHistogramKernel``, ``DeviceRadixSortExclusiveSum``,
  ``fill_reverse_indices_kernel``, ``Memcpy DtoD``, ``Memset``.

Encode's kernels (a norm, a dozen elementwise ones, its ``searchsorted``)
take about 0.02 ms a batch and are counted with phase 1, as are three
kernels of the rescore under names the walk also uses (a row gather, a
scatter-gather, an ``arange``, about 0.03 ms a batch): no name tells them
apart, and together they are under 0.1% of a batch's phase 1."""

from portbench.roofline.postings import least_phase1_s

# copies to and from the host, and the rescore's own kernels: its
# product (gemv), its page-of-320 sort and its final gather
NOT_PHASE1 = ("Memcpy HtoD", "Memcpy DtoH", "gemv", "radixSortKVInPlace",
              "vectorized_gather_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    batches, _ = run.hist_delta("engine.dispatch.latency_s")
    entries = run.counter_delta("search.postings.entries")
    if not batches or not entries:
        return None
    dev_s = sum(b - a for n, a, b in tr.ops
                if not any(p in n for p in NOT_PHASE1)) * 1e-9
    if dev_s <= 0:
        return None
    return 100.0 * least_phase1_s(run.config, entries / batches) / (
        dev_s / batches)
