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
from repro_torch.core import rerank as trerank
from repro_torch.kernels.bucketize import kernel as bk_kernel
from repro_torch.kernels.bucketize import ops as bk_ops
from repro_torch.kernels.bucketize import ref as bk_ref
from repro_torch.kernels.code_match import kernel as cm_kernel
from repro_torch.kernels.code_match import ops as cm_ops
from repro_torch.kernels.code_match import ref as cm_ref
from repro_torch.kernels.fused_phase1 import kernel as tkernel
from repro_torch.kernels.fused_phase1 import ops as tops
from repro_torch.kernels.fused_phase1 import ref as tref
from repro_torch.kernels.rerank_topk import kernel as rk_kernel
from repro_torch.kernels.rerank_topk import ops as rk_ops
from repro_torch.kernels.rerank_topk import ref as rk_ref

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
    # past the shared memory of the card the fold spills to device memory
    # and answers: no page that fits device memory is refused
    big = torch.randint(-8, 8, (40000, 8), generator=gen,
                        device="cuda").to(torch.int8)
    s, i = tops.fused_phase1(big, Q.to(torch.int8), W, 20000)
    ws, wi = tref.fused_phase1_ref(big, Q.to(torch.int8), W, 20000)
    assert torch.equal(s, ws) and torch.equal(i, wi)


def _assert_quant_parity(got, want, d, rtol=1e-5, atol=1e-4):
    """Scores within rtol 1e-5 / atol 1e-4 of the plain version, ids equal
    wherever the plain version separates neighbours by more than that same
    tolerance (atol + rtol |s|: at |s| ~ 180 a legal difference of 1e-4
    swaps neighbours 1.2e-4 apart), every id in range.  ``want`` may hold
    one column more than ``got`` (the plain version at page + 1), so that
    a near-tie across the page's last slot counts as one."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    page = s_g.shape[1]
    sep = np.isfinite(s_w)
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            tie = (np.abs(s_w[:, :-1] - s_w[:, 1:])
                   <= atol + rtol * np.abs(s_w[:, :-1]))
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    s_w, i_w, sep = s_w[:, :page], i_w[:, :page], sep[:, :page]
    fin = np.isfinite(s_w)
    assert np.array_equal(fin, np.isfinite(s_g))
    np.testing.assert_allclose(s_g[fin], s_w[fin], rtol=rtol, atol=atol)
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
        want = tref.fused_phase1_quant_ref(codes, scale, zero, Q,
                                           min(page + 1, d), live=lv)
        _assert_quant_parity(got, want, d)


def test_fused_phase1_quant_kernel_live_below_page(gen):
    d, n, q, page = 90, 12, 3, 48
    codes, scale, zero, Q = _quant_inputs(gen, d, n, q)
    live = torch.rand(d, generator=gen, device="cuda") < 0.3
    n_live = int(live.sum())
    assert 0 < n_live < page
    got = tops.fused_phase1_quant(codes, scale, zero, Q, page, live=live)
    _assert_quant_parity(got, tref.fused_phase1_quant_ref(
        codes, scale, zero, Q, page + 1, live=live), d)
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


def test_fused_kernels_answer_page_16384(gen):
    """d 65,536, Q 8, page 16,384: past the shared-memory route, both
    fused kernels fold in the device workspace and hold their
    contracts."""
    d, q, page = 65536, 8, 16384
    D = torch.randint(-8, 8, (d, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (q, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((q, 400), generator=gen, device="cuda")
    live = torch.rand(d, generator=gen, device="cuda") < 0.9
    for lv in (None, live):
        s, i = tops.fused_phase1(D, Qc, W, page, live=lv)
        ws, wi = tref.fused_phase1_ref(D, Qc, W, page, live=lv)
        assert torch.equal(s, ws)
        fin = torch.isfinite(ws)
        assert torch.equal(i[fin], wi[fin])
    codes, scale, zero, Q = _quant_inputs(gen, d, 400, q)
    _assert_quant_parity(
        tops.fused_phase1_quant(codes, scale, zero, Q, page),
        tref.fused_phase1_quant_ref(codes, scale, zero, Q, page + 1), d)


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


@pytest.mark.parametrize("d,q,p,n", [
    (131072, 32, 320, 400), (20000, 32, 8192, 400), (5000, 9, 777, 37),
    (1000, 3, 50, 401), (64, 1, 1, 1)])
def test_rerank_kernel_vs_plain(gen, d, q, p, n):
    """rtol 1e-4 / atol 5e-5 against the plain gather + einsum, in both
    forms (table + ids, gathered); rerank_topk selects the core path's
    ids away from near-ties, with the core path's bits; one CUDA kernel
    per call counted."""
    V = trerank.normalize(torch.randn((d, n), generator=gen, device="cuda"))
    ids = torch.randint(0, d, (q, p), generator=gen, device="cuda",
                        dtype=torch.int32)
    Q = trerank.normalize(torch.randn((q, n), generator=gen, device="cuda"))
    before = rk_ops.launches
    got = rk_ops.candidate_scores(V, ids, Q)
    assert rk_ops.launches == before + rk_kernel.KERNELS_PER_CALL
    want = rk_ref.candidate_scores_ref(V, ids, Q)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-5)
    cand = V[ids.long()]
    torch.testing.assert_close(rk_ops.rerank_scores(cand, Q),
                               rk_ref.rerank_scores_ref(cand, Q),
                               rtol=1e-4, atol=5e-5)
    k = min(10, p)
    i_g, s_g = rk_ops.rerank_topk(V, ids, Q, k)
    i_c, s_c = trerank.rerank_topk(V, ids, Q, k)
    srt = torch.sort(want, dim=1, descending=True).values
    apart = (srt[:, k - 1] - srt[:, k] > 1e-4) if k < p else \
        torch.ones(q, dtype=torch.bool, device="cuda")
    assert torch.equal(i_g[apart], i_c[apart])
    same = i_g == i_c
    assert torch.equal(s_g[same], s_c[same])


def test_rerank_kernel_rejects_bad_input(gen):
    V = torch.randn((64, 8), generator=gen, device="cuda")
    ids = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
    Q = torch.randn((2, 8), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        rk_kernel.rerank_scores_cuda(V.cpu(), ids.cpu(), Q.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        rk_kernel.rerank_scores_cuda(V, ids, Q.cpu())
    with pytest.raises(TypeError, match="int32"):
        rk_kernel.rerank_scores_cuda(V, ids.long(), Q)
    with pytest.raises(TypeError, match="float32"):
        rk_ops.candidate_scores(V.double(), ids, Q)
    with pytest.raises(ValueError, match="shape"):
        rk_ops.candidate_scores(V, ids, Q[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rk_ops.candidate_scores(V, ids, torch.cat([Q, Q], 1)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        rk_ops.rerank_scores(V[:10].reshape(2, 5, 8).transpose(0, 1), Q)


def _assert_codes(got, want):
    """The reference suite's contract: >= 99.99% of codes equal, every
    other code one bucket off."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.long() - want.long()).abs()
    assert (diff == 0).float().mean() >= 0.9999
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("mode,param,dtype", [
    ("round", 100.0, torch.int8), ("round", 1000.0, torch.int16),
    ("floor", 0.1, torch.int8), ("floor", 0.05, torch.int16)])
@pytest.mark.parametrize("shape", [(131071, 400), (5001, 37), (64, 800),
                                   (3, 1)])
def test_bucketize_kernel_vs_plain(gen, mode, param, dtype, shape):
    x = torch.randn(shape, generator=gen, device="cuda") * (
        0.1 + 3 * torch.rand((shape[0], 1), generator=gen, device="cuda"))
    x[0] = 0.0
    before = bk_ops.launches
    got = bk_ops.bucketize(x, mode, param, dtype)
    assert bk_ops.launches == before + bk_kernel.KERNELS_PER_CALL
    _assert_codes(got, bk_ref.bucketize_ref(x, mode, param, dtype))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("encoder", [
    tenc.RoundingEncoder(2), tenc.IntervalEncoder(0.1),
    tenc.CombinedEncoder(tenc.RoundingEncoder(1), tenc.IntervalEncoder(0.1))],
    ids=lambda e: e.scheme_id)
def test_bucketize_encode_vs_encoder(gen, encoder):
    """ops.encode on the card against encoder.encode(normalize(x)); one
    launch per encoder half."""
    x = torch.randn((4096, 400), generator=gen, device="cuda")
    before = bk_ops.launches
    got = bk_ops.encode(x, encoder)
    halves = 2 if isinstance(encoder, tenc.CombinedEncoder) else 1
    assert bk_ops.launches == before + halves
    _assert_codes(got, encoder.encode(trerank.normalize(x)))


def test_bucketize_interval_codes_at_edges_equal_cpu(gen):
    """Rows [1, e] (and [1, e, 0, 0], the vector path) have norm exactly
    1 in any summation order, so the kernel's interval division meets
    bucket edges e = k * width and their float neighbours as the CPU's
    does: an IEEE division by the float32 width, never a multiply by its
    reciprocal (which some of these inputs tell apart)."""
    told_apart = 0
    for width in (1e-4, 3e-5, 7e-5):
        w = np.float32(width)
        k = np.arange(-2, 3, dtype=np.float32)
        e = (k * w).astype(np.float32)
        e = np.concatenate([e, np.nextafter(e, e + 1), np.nextafter(e, e - 1)])
        assert (np.float32(1) + (e.astype(np.float64) ** 2).max()
                .astype(np.float32)) == 1
        told_apart += int((np.floor(e / w)
                           != np.floor(e * (np.float32(1) / w))).sum())
        for n in (2, 4):
            x = torch.zeros((e.size, n))
            x[:, 0] = 1.0
            x[:, 1] = torch.from_numpy(e)
            got = bk_ops.bucketize(x.cuda(), "floor", float(w), torch.int16)
            want = bk_ref.bucketize_ref(x, "floor", float(w), torch.int16)
            assert torch.equal(got.cpu(), want)
    assert told_apart > 0


def test_bucketize_kernel_rejects_bad_input(gen):
    x = torch.randn((16, 8), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        bk_kernel.bucketize_cuda(x.cpu(), "round", 10.0)
    with pytest.raises(TypeError, match="float32"):
        bk_ops.bucketize(x.double(), "round", 10.0)
    with pytest.raises(TypeError, match="out_dtype"):
        bk_ops.bucketize(x, "round", 10.0, torch.int32)
    with pytest.raises(ValueError, match="mode"):
        bk_ops.bucketize(x, "ceil", 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        bk_ops.bucketize(x.T, "round", 10.0)
    with pytest.raises(ValueError, match="2-D"):
        bk_ops.bucketize(x[0], "round", 10.0)


def _spread_weights(gen, shape):
    """Weights over six decades, so that another order of adds shows."""
    return (torch.rand(shape, generator=gen, device="cuda")
            * 10 ** (6 * torch.rand(shape, generator=gen, device="cuda") - 3))


def test_score_postings_fixed_order_on_card(gen):
    """score_postings_batch on the card sums in column order: two runs
    give the same bits, and so does the CPU on the same tables and
    weights.  d 200,000 and six codes a column, so each (query, doc)
    gathers some eight contributions."""
    from repro_torch.core import postings as tpost

    d, C, Q = 200_000, 48, 8
    codes = torch.randint(-3, 3, (d, C), generator=gen,
                          device="cuda").to(torch.int8)
    post = tpost.build_postings(codes)
    qc = codes[torch.randint(0, d, (Q,), generator=gen, device="cuda")]
    cw = _spread_weights(gen, (Q, C))
    mask = torch.rand((Q, C), generator=gen, device="cuda") < 0.9
    runs = [tpost.score_postings_batch(post, qc, mask, weighting="count",
                                       col_weights=cw) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    cpu = tpost.score_postings_batch(
        tpost.Postings(post.post_docs.cpu(), post.post_codes.cpu(), d),
        qc.cpu(), mask.cpu(), weighting="count", col_weights=cw.cpu())
    assert torch.equal(runs[0].cpu(), cpu)
    assert float((runs[0] > 0).float().mean()) > 0.9


def test_mlt_scores_fixed_order_on_card(gen):
    """MLTIndex.scores on the card: two runs give the same bits."""
    from repro_torch.core import MLTIndex
    from repro_torch.data import make_corpus

    corpus = make_corpus(n_docs=3000, vocab_size=4000, n_topics=20, seed=0)
    mlt = MLTIndex.build(corpus.doc_terms, corpus.doc_tf, corpus.vocab_size,
                         device="cuda")
    runs = [mlt.scores(corpus.doc_terms[:64], corpus.doc_tf[:64])
            for _ in range(2)]
    assert runs[0].is_cuda and torch.equal(runs[0], runs[1])
    ids, scores = mlt.more_like_this(corpus.doc_terms[:64],
                                     corpus.doc_tf[:64])
    assert torch.equal(scores, torch.gather(runs[0], 1, ids.long()))


def test_rmatvec_bags_fixed_order_on_card(gen):
    """A.T @ X on the card: two runs give the same bits, over blocks in
    which one term gets many contributions."""
    from repro_torch.lsa import svd as tsvd

    d, T, r, V = 20_000, 96, 64, 5000
    terms = torch.randint(-1, V, (d, T), generator=gen, device="cuda",
                          dtype=torch.int32)
    weights = _spread_weights(gen, (d, T))
    X = torch.randn((d, r), generator=gen, device="cuda")
    runs = [tsvd.rmatvec_bags(terms, weights, X, V, block=4096)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(
        runs[0].cpu(), tsvd.rmatvec_bags(terms.cpu(), weights.cpu(),
                                         X.cpu(), V, block=4096),
        rtol=1e-5, atol=1e-4)
