"""PyTorch/CUDA port of the semantic-vector-encoding search system.

The paper's system encodes each feature of a dense semantic vector as a
(column, bucket) token and retrieves with a fulltext-style two-phase
search: phase 1 scores documents by weighted token matches and keeps a
candidate page, phase 2 re-ranks the page by exact cosine.

This package mirrors the JAX package's layout (``core/``, ``kernels/``,
``serve/``) in PyTorch idiom: plain functions on tensors, an explicit
``device`` argument (``"cuda"`` unless the caller asks for the CPU),
explicit ``torch.Generator``s.  Every Pallas kernel of the reference
becomes a kernel written by hand for Hopper; each keeps a plain PyTorch
version of the same math beside it, which a wrapper takes only for a
tensor that lies on the CPU.
"""
