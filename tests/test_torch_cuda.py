"""repro_torch on the card: the hand-written kernels against their plain
versions, and the card's encoders against the CPU's.

Every test here is marked ``cuda`` and skips without a CUDA card.  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import encoding as tenc
from repro_torch.kernels.fused_phase1 import kernel as tkernel
from repro_torch.kernels.fused_phase1 import ops as tops
from repro_torch.kernels.fused_phase1 import ref as tref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,dtype", [
    ((131072, 8, 400, 320), torch.int8), ((5001, 9, 23, 33), torch.int16),
    ((700, 5, 37, 17), torch.int32), ((100, 1, 1, 10), torch.int8),
    ((3000, 40, 800, 1024), torch.int8)])
def test_fused_phase1_kernel_vs_plain(gen, shape, dtype):
    """Scores bit-equal, ids equal where finite, ids in range; both CUDA
    kernels of a call counted."""
    d, q, c, page = shape
    D = torch.randint(-8, 8, (d, c), generator=gen, device="cuda").to(dtype)
    Q = torch.randint(-8, 8, (q, c), generator=gen, device="cuda").to(dtype)
    W = torch.rand((q, c), generator=gen, device="cuda")
    live = torch.rand(d, generator=gen, device="cuda") < 0.9
    for lv in (None, live):
        before = tops.launches
        s, i = tops.fused_phase1(D, Q, W, page, live=lv)
        assert tops.launches == before + tkernel.KERNELS_PER_CALL
        ws, wi = tref.fused_phase1_ref(D, Q, W, page, live=lv)
        assert torch.equal(s, ws)
        fin = torch.isfinite(ws)
        assert torch.equal(i[fin], wi[fin])
        assert bool(((i >= 0) & (i < d)).all())


def test_fused_phase1_kernel_rejects_bad_input(gen):
    D = torch.zeros((64, 8), dtype=torch.int8, device="cuda")
    Q = torch.zeros((2, 8), dtype=torch.int16, device="cuda")
    W = torch.zeros((2, 8), device="cuda")
    with pytest.raises(TypeError):
        tops.fused_phase1(D, Q, W, 8)
    with pytest.raises(ValueError, match="page"):
        tops.fused_phase1(torch.zeros((4096, 8), dtype=torch.int8,
                                      device="cuda"),
                          Q.to(torch.int8), W, 2048)


@pytest.mark.parametrize("encoder", [
    tenc.RoundingEncoder(2), tenc.IntervalEncoder(0.1),
    tenc.CombinedEncoder(tenc.RoundingEncoder(1), tenc.IntervalEncoder(0.1))],
    ids=lambda e: e.scheme_id)
def test_encoders_card_equals_cpu(gen, encoder):
    x = torch.randn((4096, 400), generator=gen, device="cuda")
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    edges = torch.arange(-10, 11, device="cuda", dtype=torch.float32) * 0.1
    x[0, :21] = edges
    x[1, :21] = torch.nextafter(edges, edges + 1)
    x[2, :21] = torch.nextafter(edges, edges - 1)
    assert torch.equal(encoder.encode(x).cpu(), encoder.encode(x.cpu()))
