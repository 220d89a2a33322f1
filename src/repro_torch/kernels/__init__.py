"""Kernels written by hand for Hopper, one package each, with the JAX
package's ``kernel.py`` / ``ops.py`` / ``ref.py`` split:

* ``fused_phase1`` -- scores plus a running stable top-``page``, over the
  code table (the ``fused`` engine; ``csrc/fused_phase1.cu``, replacing
  ``src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas``) or
  over the int8 vector table (the ``fused_int8`` engine;
  ``csrc/fused_phase1_quant.cu``, replacing ``fused_phase1_quant_pallas``
  of the same file); both share the fold of ``csrc/topk_fold.cuh``;
* ``code_match`` -- the full (Q, d) code-match matrix (the
  ``codes_pallas`` engine; ``csrc/code_match.cu``, replacing
  ``src/repro/kernels/code_match/kernel.py::code_match_pallas``);
* ``rerank_topk`` -- phase-2 exact scores of a candidate page, the gather
  of the rows by id fused in (``csrc/rerank_topk.cu``, replacing
  ``src/repro/kernels/rerank_topk/kernel.py::rerank_scores_pallas``);
* ``bucketize`` -- fused row normalize + quantize at build and ingest
  (``csrc/bucketize.cu``, replacing
  ``src/repro/kernels/bucketize/kernel.py::bucketize_pallas``);
* ``postings_walk`` -- the ``postings`` engine's walk of the kept posting
  ranges into dense (Q, d) scores, a doc tile of the accumulator a block
  in shared memory (``csrc/postings_walk.cu`` with ``csrc/walk_cut.cuh``;
  it replaces no TPU kernel: the JAX package's walk is a plain
  ``segment_sum``);
* ``page_select`` -- the page of a composed engine's dense (Q, d) scores
  by a radix threshold selection, the bits of ``stable_topk``
  (``csrc/page_select.cu`` with ``csrc/select_key.cuh``; it replaces no
  TPU kernel: the JAX package cuts the page with ``lax.top_k``).

As in the JAX package, ``VectorIndex`` calls neither ``rerank_topk`` nor
``bucketize``: they are reached through their wrappers,
``rerank_topk.ops.rerank_topk`` and ``bucketize.ops.encode``.
``csrc/match_tree.cuh`` holds the fp32 code-match cell scorer both
code-match kernels use, ``csrc/block_scan.cuh`` the block scan of the
walk and the page selection.  ``_build`` compiles the CUDA sources with
``nvcc`` at first use.
"""

__all__ = ["launch_counts"]


def launch_counts() -> dict:
    """The CUDA kernels each wrapper has launched in this process, by
    kernel: what a run reads to show that its path went through them."""
    from .bucketize import ops as bk_ops
    from .code_match import ops as cm_ops
    from .fused_phase1 import ops as fp_ops
    from .page_select import ops as ps_ops
    from .postings_walk import ops as pw_ops
    from .rerank_topk import ops as rk_ops

    return {"fused_phase1": fp_ops.launches,
            "fused_phase1_quant": fp_ops.quant_launches,
            "code_match": cm_ops.launches, "bucketize": bk_ops.launches,
            "rerank_topk": rk_ops.launches,
            "postings_walk": pw_ops.launches,
            "page_select": ps_ops.launches}
