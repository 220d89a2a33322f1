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
  ``src/repro/kernels/code_match/kernel.py::code_match_pallas``).

``csrc/match_tree.cuh`` holds the fp32 code-match cell scorer both
code-match kernels use.  ``_build`` compiles the CUDA sources with
``nvcc`` at first use.
"""
