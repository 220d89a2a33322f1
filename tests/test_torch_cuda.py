"""repro_torch on the card: the hand-written kernels against their plain
versions, the card's encoders and quant table against the CPU's, and
every search engine on the card against the same search on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA card.  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import encoding as tenc
from repro_torch.core import quantize as tquant
from repro_torch.kernels.code_match import kernel as cm_kernel
from repro_torch.kernels.code_match import ops as cm_ops
from repro_torch.kernels.code_match import ref as cm_ref
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
    with pytest.raises(ValueError, match="on cpu|CUDA"):
        tops.fused_phase1(D, Q.to(torch.int8), W.cpu(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.fused_phase1_cuda(D.T.contiguous().T, Q.to(torch.int8), W, 8)
    with pytest.raises(ValueError, match="shape"):
        tops.fused_phase1(D, Q.to(torch.int8)[:, :4], W, 8)
    # past the shared memory of the card, the error names the largest
    # page that fits
    big = torch.zeros((40000, 8), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="largest page that fits is 8192"):
        tops.fused_phase1(big, Q.to(torch.int8), W, 20000)


def _assert_quant_parity(got, want, d, tol=1e-4):
    """Scores within rtol 1e-5 / atol 1e-4 of the plain version, ids equal
    wherever the plain version separates neighbours by more than 1e-4,
    every id in range."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    fin = np.isfinite(s_w)
    assert np.array_equal(fin, np.isfinite(s_g))
    np.testing.assert_allclose(s_g[fin], s_w[fin], rtol=1e-5, atol=tol)
    sep = fin.copy()
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            tie = np.abs(s_w[:, :-1] - s_w[:, 1:]) <= tol
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    assert np.array_equal(i_g[sep], i_w[sep])
    assert (i_g >= 0).all() and (i_g < d).all()


def _quant_inputs(gen, d, n, q):
    V = torch.randn((d, n), generator=gen, device="cuda") * (
        0.1 + 3.9 * torch.rand((d, 1), generator=gen, device="cuda"))
    codes, scale, zero = tquant.quantize_rows(V)
    return codes, scale, zero, torch.randn((q, n), generator=gen,
                                           device="cuda")


@pytest.mark.parametrize("shape", [(131072, 400, 8, 320), (5001, 23, 9, 33),
                                   (700, 37, 5, 17), (100, 1, 1, 10),
                                   (3000, 401, 40, 1024)])
def test_fused_phase1_quant_kernel_vs_plain(gen, shape):
    """The _assert_quant_parity contract, with and without a live mask;
    both CUDA kernels of a call counted."""
    d, n, q, page = shape
    codes, scale, zero, Q = _quant_inputs(gen, d, n, q)
    live = torch.rand(d, generator=gen, device="cuda") < 0.9
    for lv in (None, live):
        before = tops.quant_launches
        got = tops.fused_phase1_quant(codes, scale, zero, Q, page, live=lv)
        assert tops.quant_launches == before + tkernel.KERNELS_PER_CALL
        want = tref.fused_phase1_quant_ref(codes, scale, zero, Q, page,
                                           live=lv)
        _assert_quant_parity(got, want, d)


def test_fused_phase1_quant_kernel_live_below_page(gen):
    d, n, q, page = 90, 12, 3, 48
    codes, scale, zero, Q = _quant_inputs(gen, d, n, q)
    live = torch.rand(d, generator=gen, device="cuda") < 0.3
    n_live = int(live.sum())
    assert 0 < n_live < page
    got = tops.fused_phase1_quant(codes, scale, zero, Q, page, live=live)
    _assert_quant_parity(got, tref.fused_phase1_quant_ref(
        codes, scale, zero, Q, page, live=live), d)
    assert bool((torch.isfinite(got[0]).sum(1) == n_live).all())


def test_fused_phase1_quant_kernel_rejects_bad_input(gen):
    codes, scale, zero, Q = _quant_inputs(gen, 64, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_phase1_quant_cuda(codes.cpu(), scale.cpu(), zero.cpu(),
                                        Q.cpu(), 8)
    with pytest.raises(ValueError, match="on cpu|CUDA"):
        tops.fused_phase1_quant(codes, scale.cpu(), zero, Q, 8)
    with pytest.raises(TypeError, match="int8"):
        tops.fused_phase1_quant(codes.to(torch.int16), scale, zero, Q, 8)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_phase1_quant(codes, scale, zero, Q.double(), 8)
    with pytest.raises(ValueError, match="shape"):
        tops.fused_phase1_quant(codes, scale[:10], zero, Q, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_phase1_quant(codes, scale, zero,
                                torch.cat([Q, Q], 1)[:, ::2], 8)
    with pytest.raises(ValueError, match="live"):
        tops.fused_phase1_quant(codes, scale, zero, Q, 8,
                                live=torch.ones(63, dtype=torch.bool,
                                                device="cuda"))


def test_fused_kernels_answer_page_5000(gen):
    """page = d = 5000, past the old 1024 limit: both fused kernels answer
    and hold their contracts."""
    d = page = 5000
    D = torch.randint(-8, 8, (d, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (4, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((4, 400), generator=gen, device="cuda")
    s, i = tops.fused_phase1(D, Qc, W, page)
    ws, wi = tref.fused_phase1_ref(D, Qc, W, page)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    codes, scale, zero, Q = _quant_inputs(gen, d, 400, 4)
    _assert_quant_parity(
        tops.fused_phase1_quant(codes, scale, zero, Q, page),
        tref.fused_phase1_quant_ref(codes, scale, zero, Q, page), d)


@pytest.mark.parametrize("shape,dtype", [
    ((131072, 8, 400), torch.int8), ((5001, 9, 23), torch.int16),
    ((700, 5, 37), torch.int32), ((100, 1, 1), torch.int8),
    ((3000, 40, 800), torch.int8), ((1031, 3, 96), torch.int16)])
def test_code_match_kernel_vs_plain(gen, shape, dtype):
    """rtol/atol 1e-5 against code_match_ref, bit-equal to the
    match_scores tree; one CUDA kernel per call counted."""
    d, q, c = shape
    hi = 100 if dtype == torch.int8 else 3000
    D = torch.randint(-hi, hi, (d, c), generator=gen,
                      device="cuda").to(dtype)
    Qc = D[torch.randint(0, d, (q,), generator=gen, device="cuda")].clone()
    Qc[:, ::3] = torch.randint(-hi, hi, Qc[:, ::3].shape, generator=gen,
                               device="cuda").to(dtype)
    W = torch.rand((q, c), generator=gen, device="cuda")
    before = cm_ops.launches
    got = cm_ops.code_match(D, Qc, W)
    assert cm_ops.launches == before + cm_kernel.KERNELS_PER_CALL
    torch.testing.assert_close(got, cm_ref.code_match_ref(D, Qc, W),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tref.match_scores(D, Qc, W))


def test_code_match_kernel_rejects_bad_input(gen):
    D = torch.zeros((64, 8), dtype=torch.int8, device="cuda")
    Q = torch.zeros((2, 8), dtype=torch.int8, device="cuda")
    W = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cm_kernel.code_match_cuda(D.cpu(), Q.cpu(), W.cpu())
    with pytest.raises(ValueError, match="on cpu|CUDA"):
        cm_ops.code_match(D, Q, W.cpu())
    with pytest.raises(TypeError):
        cm_ops.code_match(D, Q.to(torch.int16), W)
    with pytest.raises(TypeError, match="float32"):
        cm_ops.code_match(D, Q, W.double())
    with pytest.raises(ValueError, match="shape"):
        cm_ops.code_match(D, Q[:, :4], W)
    with pytest.raises(ValueError, match="contiguous"):
        cm_ops.code_match(D.T.contiguous().T, Q, W)


def test_quantize_table_card_equals_cpu(gen):
    """codes, scale and zero bit-equal between card and CPU, degenerate
    rows included."""
    x = torch.randn((4096, 400), generator=gen, device="cuda") * (
        0.05 + 5 * torch.rand((4096, 1), generator=gen, device="cuda"))
    x[0] = 0.0
    x[1] = 1.75
    got = tquant.quantize_table(x)
    want = tquant.quantize_table(x.cpu())
    for a, b in ((got.codes, want.codes), (got.scale, want.scale),
                 (got.zero, want.zero)):
        assert torch.equal(a.cpu(), b)


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


@pytest.mark.parametrize("engine", ["postings", "codes", "onehot",
                                    "codes_pallas", "fused", "fused_int8"])
def test_search_engines_card_vs_cpu(gen, engine):
    """Every engine of VectorIndex.search on the card returns the ids the
    same index returns on the CPU (at least 99%: a query normalized on the
    card may move a code across a bucket edge), with scores within 1e-5
    where the ids agree (the fp32 rescore and the phase-1 sums reduce in
    another order)."""
    from repro_torch import interop
    from repro_torch.core import TrimFilter, VectorIndex

    V = torch.randn((3000, 48), generator=gen, device="cuda")
    Q = V[:16] + 0.05 * torch.randn((16, 48), generator=gen, device="cuda")
    cidx = VectorIndex.build(V.cpu(), device="cpu")
    gidx = interop.index_from_numpy(
        cidx.vectors.numpy(), cidx.codes.numpy(),
        cidx.postings.post_docs.numpy(), cidx.postings.post_codes.numpy(),
        cidx.encoder, device="cuda")
    for page in (3000, 320):
        got = gidx.search(Q, k=10, page=page, trim=TrimFilter(0.05),
                          engine=engine)
        want = cidx.search(Q.cpu(), k=10, page=page, trim=TrimFilter(0.05),
                           engine=engine)
        assert got[0].is_cuda and got[0].dtype == torch.int32
        same = got[0].cpu() == want[0]
        assert same.float().mean() >= 0.99
        torch.testing.assert_close(got[1].cpu()[same], want[1][same],
                                   rtol=0, atol=1e-5)
