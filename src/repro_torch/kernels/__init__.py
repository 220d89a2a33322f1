"""Kernels written by hand for Hopper, one package each, with the JAX
package's ``kernel.py`` / ``ops.py`` / ``ref.py`` split:

* ``fused_phase1`` -- code-match scoring plus a running stable top-``page``
  (the ``fused`` engine); CUDA C++ in ``fused_phase1/csrc/``, replacing
  ``src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas``.

``_build`` compiles the CUDA sources with ``nvcc`` at first use.
"""
