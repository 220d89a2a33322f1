"""repro_torch on the card: the hand-written kernels against their plain
versions, the card's encoders and quant table against the CPU's, every
search engine on the card against the same search on the CPU, and the
dense LM on the card against the CPU and its bit-exact resume, a
recsys model and GIN's neighbour sum on the card against the CPU and
bit-equal run to run, the MoE FFN on the card against the CPU with
the MoE LMs' training steps bit-equal under deterministic algorithms,
and vectordb-wiki's encode cell and ``train/elastic.py``'s moves between
the card and the host.

Every test here is marked ``cuda`` and skips without a CUDA card.  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math
import os

import numpy as np
import pytest

# the MoE steps run under torch.use_deterministic_algorithms, which needs
# cuBLAS's workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

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


@pytest.mark.parametrize("d,n,q,page,live_frac", [
    (131072, 400, 8, 320, None), (5001, 23, 9, 33, None),
    (90, 12, 3, 48, 0.3), (5000, 400, 4, 5000, None),
    (3000, 401, 40, 1024, 0.9), (65536, 400, 8, 16384, None)])
def test_fused_phase1_quant_kernel_bit_equal_to_split(gen, d, n, q, page,
                                                      live_frac):
    """At chip_smoke phase A's shapes, the tensor-core kernel's scores equal
    ref.quant_split_scores' stable top-page bit for bit, and so do its ids
    where the score is finite; both stay within the _assert_quant_parity
    contract of the plain version."""
    codes, scale, zero, Q = _quant_inputs(gen, d, n, q)
    live = (None if live_frac is None
            else torch.rand(d, generator=gen, device="cuda") < live_frac)
    got = tops.fused_phase1_quant(codes, scale, zero, Q, page, live=live)
    want = tref.fused_phase1_quant_split_ref(codes, scale, zero, Q, page,
                                             live)
    assert torch.equal(got[0], want[0])
    fin = torch.isfinite(want[0])
    assert torch.equal(got[1][fin], want[1][fin])
    _assert_quant_parity(got, tref.fused_phase1_quant_ref(
        codes, scale, zero, Q, min(page + 1, d), live=live), d)


@pytest.mark.parametrize("n", [400, 64, 23])
def test_fused_phase1_quant_kernel_unaligned_table(gen, n):
    """A table that starts at an odd address takes the 4-byte copy route
    (no 16-byte row alignment), and gives the same bits."""
    d, q, page = 3001, 5, 64
    codes, scale, zero, Q = _quant_inputs(gen, d, n, q)
    raw = torch.empty(d * n + 1, dtype=torch.int8, device="cuda")
    odd = raw[1:].view(d, n)
    odd.copy_(codes)
    assert odd.data_ptr() % 2 == 1
    got = tops.fused_phase1_quant(odd, scale, zero, Q, page)
    want = tops.fused_phase1_quant(codes, scale, zero, Q, page)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    split = tref.fused_phase1_quant_split_ref(codes, scale, zero, Q, page)
    assert torch.equal(got[0], split[0])


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


def _rerank_inputs(gen, d, q, p, n, kind):
    """Unit table rows (``misaligned``: 4 bytes past a 16-byte boundary),
    ids of ``kind`` (``random``, ``duplicate``: 64 ids, half of them
    repeated at once, ``out_of_range``: -d to 2d), unit queries."""
    V = trerank.normalize(torch.randn((d, n), generator=gen, device="cuda"))
    if kind == "misaligned":
        buf = torch.empty(d * n + 1, device="cuda")
        buf[1:].copy_(V.flatten())
        V = buf[1:].view(d, n)
    lo, hi = {"duplicate": (0, 64), "out_of_range": (-d, 2 * d)}.get(
        kind, (0, d))
    ids = torch.randint(lo, hi, (q, p), generator=gen, device="cuda",
                        dtype=torch.int32)
    if kind == "duplicate":
        ids[:, 1::2] = ids[:, ::2][:, :p // 2]
    Q = trerank.normalize(torch.randn((q, n), generator=gen, device="cuda"))
    return V, ids, Q


_RERANK_SHAPES = [
    (131072, 32, 320, 400, "random"), (20000, 32, 8192, 400, "random"),
    (5000, 9, 777, 37, "random"), (1000, 3, 50, 401, "random"),
    (64, 1, 1, 1, "random"), (100000, 32, 3000, 400, "random"),
    (100000, 5, 999, 4, "random"), (20000, 4, 777, 4096, "random"),
    (50000, 8, 1000, 400, "duplicate"), (50000, 8, 1000, 400, "out_of_range"),
    (50000, 8, 1000, 400, "misaligned")]


@pytest.mark.parametrize("d,q,p,n,kind", _RERANK_SHAPES)
def test_rerank_kernel_vs_plain(gen, d, q, p, n, kind):
    """rtol 1e-4 / atol 5e-5 against the plain gather + einsum (on the
    clamped ids), in both forms (table + ids, gathered); the bulk body ran
    where n % 4 == 0 on an aligned table (n = 400 among them), the simple
    body elsewhere, one CUDA kernel per call counted; rerank_topk selects
    the core path's ids away from near-ties, with the core path's bits."""
    V, ids, Q = _rerank_inputs(gen, d, q, p, n, kind)
    body = "bulk" if n % 4 == 0 and kind != "misaligned" else "simple"
    before = rk_ops.launches
    by_body = dict(rk_ops.launches_by_body)
    got = rk_ops.candidate_scores(V, ids, Q)
    assert rk_ops.launches == before + rk_kernel.KERNELS_PER_CALL
    by_body[body] += 1
    assert rk_ops.launches_by_body == by_body
    want = rk_ref.candidate_scores_ref(V, ids.clamp(0, d - 1), Q)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-5)
    if kind == "out_of_range":      # the core path does not clamp
        return
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


@pytest.mark.parametrize("d,q,p,n,kind", _RERANK_SHAPES)
def test_rerank_bodies_bit_equal_to_lane_order(gen, d, q, p, n, kind):
    """Each body that can run a shape gives ref.lane_order_scores' bits
    (the kernels' summation order in torch, fmaf rounded once), so the two
    bodies are bit-equal where both run; forcing the bulk body on a shape
    it does not take raises."""
    V, ids, Q = _rerank_inputs(gen, d, q, p, n, kind)
    vec = n % 4 == 0 and kind != "misaligned"
    want = rk_ref.lane_order_scores(V, ids, Q, vec=vec)
    assert torch.equal(rk_kernel.rerank_scores_cuda(V, ids, Q, body="simple"),
                       want)
    if vec:
        assert torch.equal(
            rk_kernel.rerank_scores_cuda(V, ids, Q, body="bulk"), want)
    else:
        with pytest.raises(ValueError, match="bulk body"):
            rk_kernel.rerank_scores_cuda(V, ids, Q, body="bulk")


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
    with pytest.raises(ValueError, match="body must be"):
        rk_kernel.rerank_scores_cuda(V, ids, Q, body="tiled")


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


# (d, C, Q, codes a column, max_postings): several tiles with d not a
# multiple of the tile, a table narrower than one tile, Q 1 and 32, the
# truncated walk, and the most columns a block takes
_WALK_SHAPES = [(200_003, 48, 32, 6, None), (200_003, 48, 1, 6, None),
                (700, 400, 32, 3, None), (700, 37, 1, 3, None),
                (100_000, 64, 8, 4, 5_000), (65_537, 4096, 2, 2, None)]


def _walk_inputs(gen, d, C, Q, n_codes, max_postings):
    """A posting table and the walk's ranges and weights as
    score_postings_batch makes them, with a column no query keeps, a
    column of zero weights, a column of codes the table lacks (empty
    ranges), zero weights and masked tokens at random."""
    from repro_torch.core import postings as tpost

    codes = torch.randint(0, n_codes, (d, C), generator=gen,
                          device="cuda").to(torch.int8)
    post = tpost.build_postings(codes)
    qc = codes[torch.randint(0, d, (Q,), generator=gen, device="cuda")]
    qc[:, 3 % C] = n_codes + 1
    lo, hi = tpost.lookup(post, qc)
    w = _spread_weights(gen, (Q, C))
    w[torch.rand((Q, C), generator=gen, device="cuda") < 0.1] = 0
    w[:, 2 % C] = 0
    mask = torch.rand((Q, C), generator=gen, device="cuda") < 0.8
    mask[:, 1 % C] = False
    if max_postings is not None:
        hi = torch.minimum(hi, lo + max_postings)
    hi = torch.where(mask & (w != 0) & (hi > lo), hi, lo)
    return post, lo, hi, w


@pytest.mark.parametrize("shape", _WALK_SHAPES)
def test_postings_walk_kernel_vs_plain(gen, shape):
    """The walk kernel bit-equal to its plain version on the card, both
    CUDA kernels of a call counted."""
    from repro_torch.kernels.postings_walk import kernel as pw_kernel
    from repro_torch.kernels.postings_walk import ops as pw_ops
    from repro_torch.kernels.postings_walk import ref as pw_ref

    post, lo, hi, w = _walk_inputs(gen, *shape)
    before = pw_ops.launches
    got = pw_ops.postings_walk(post.post_docs, lo, hi, w)
    assert pw_ops.launches == before + pw_kernel.KERNELS_PER_CALL
    want = pw_ref.postings_walk_ref(post.post_docs, lo, hi, w)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    if shape[-1] is None:
        assert float((got > 0).float().mean()) > 0.5
    else:
        assert bool(((hi - lo) == shape[-1]).any())   # lists were cut


def test_postings_walk_kernel_rejects_bad_input(gen):
    from repro_torch.kernels.postings_walk import kernel as pw_kernel

    post, lo, hi, w = _walk_inputs(gen, 1000, 8, 3, 3, None)
    with pytest.raises(TypeError, match="int32"):
        pw_kernel.postings_walk_cuda(post.post_docs.long(), lo, hi, w)
    with pytest.raises(TypeError, match="float32"):
        pw_kernel.postings_walk_cuda(post.post_docs, lo, hi, w.double())
    with pytest.raises(ValueError, match="shape"):
        pw_kernel.postings_walk_cuda(post.post_docs, lo[:, :4], hi, w)
    with pytest.raises(ValueError, match="contiguous"):
        pw_kernel.postings_walk_cuda(post.post_docs.T.contiguous().T, lo,
                                     hi, w)
    with pytest.raises(ValueError, match="empty"):
        pw_kernel.postings_walk_cuda(post.post_docs, lo[:0], hi[:0], w[:0])
    with pytest.raises(ValueError, match="on cpu"):
        pw_kernel.postings_walk_cuda(post.post_docs, lo.cpu(), hi, w)


@pytest.mark.parametrize("max_postings", [None, "auto"])
def test_sharded_postings_search_kernel_vs_plain_on_card(gen, monkeypatch,
                                                         max_postings):
    """A 2-shard index with sealed generations, a delete and an active
    buffer, searched with engine="postings": the walk kernel, once a shard
    a search, gives the ids and scores the plain walk gives on the card."""
    import types

    from repro_torch.core import postings as tpost
    from repro_torch.kernels.postings_walk import kernel as pw_kernel
    from repro_torch.kernels.postings_walk import ops as pw_ops
    from repro_torch.kernels.postings_walk import ref as pw_ref

    from repro_torch.dist.shard_index import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh

    V = torch.randn((6000, 48), generator=gen, device="cuda")
    sidx = ShardedVectorIndex.build_sharded(V, seal_threshold=64,
                                            mesh=make_shard_mesh(2, 1))
    for _ in range(3):
        sidx = sidx.add_documents(torch.randn(
            (64, sidx.n_features), generator=gen, device="cuda"))
    sidx = sidx.add_documents(sidx.vectors[0, :5] * 2).delete(
        [7, 3001, 6010, 6100])
    assert sidx.n_segments >= 3 and sidx.n_active > 0
    q = trerank.normalize(torch.cat([sidx.vectors[0, :4], sidx.vectors[1, :4],
                                     torch.randn((24, sidx.n_features),
                                                 generator=gen,
                                                 device="cuda")]))
    for page in (33, 320):
        before = pw_ops.launches
        got = sidx.search(q, k=10, page=page, engine="postings",
                          max_postings=max_postings)
        assert pw_ops.launches - before == \
            sidx.n_shards * pw_kernel.KERNELS_PER_CALL
        with monkeypatch.context() as m:
            m.setattr(tpost, "walk_ops", types.SimpleNamespace(
                postings_walk=pw_ref.postings_walk_ref))
            want = sidx.search(q, k=10, page=page, engine="postings",
                               max_postings=max_postings)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


# ---------------------------------------- ShardedVectorIndex on the card
SHARD_ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
                 "fused_int8")


def _sharded_pair(gen, n_docs=3000, n=48):
    from repro_torch.dist.shard_index import ShardedVectorIndex

    V = torch.randn((n_docs, n), generator=gen, device="cuda")
    return (ShardedVectorIndex.build_sharded(V, seal_threshold=64,
                                             device="cuda"),
            ShardedVectorIndex.build_sharded(V, seal_threshold=None,
                                             device="cuda"), V)


def _same_results(a, b, Q, ctx, engine, pages=(33, 320, None)):
    assert a.n_ids == b.n_ids, ctx
    for k in (1, 10):
        for page in pages:
            p = 2 * a.n_ids if page is None else page
            i1, s1 = a.search(Q, k=k, page=p, engine=engine)
            i2, s2 = b.search(Q, k=k, page=p, engine=engine)
            assert torch.equal(i1, i2), (ctx, engine, k, p)
            assert torch.equal(s1, s2), (ctx, engine, k, p)


@pytest.mark.parametrize("engine", SHARD_ENGINES)
def test_sharded_lifecycle_segmented_vs_flat_on_card(gen, engine):
    """The same history on a segmented index (generations of 64 rows) and
    a flat one (one buffer grown to 2,048 slots, 32x wider) gives
    bit-identical ids and scores on the card after every stage: every
    generation is scored by a kernel whose per-row bits do not depend on
    the table's width."""
    seg, flat, V = _sharded_pair(gen)
    Q = torch.cat([V[:8], torch.randn((8, V.shape[1]), generator=gen,
                                      device="cuda")])
    _same_results(seg, flat, Q, "built", engine)
    for step in range(20):
        W = torch.randn((64, V.shape[1]), generator=gen, device="cuda")
        seg, flat = seg.add_documents(W), flat.add_documents(W)
        if step in (0, 19):
            _same_results(seg, flat, Q, ("ingest", step), engine)
    W = torch.randn((40, V.shape[1]), generator=gen, device="cuda")
    seg, flat = seg.add_documents(W), flat.add_documents(W)
    assert seg.n_segments == 20 and seg.n_active == 40
    assert flat.seg_capacity == 2048 and flat.n_segments == 0
    Q = torch.cat([Q, W[:4], seg.segments[3].vectors[0, :4]])
    _same_results(seg, flat, Q, "ingested", engine)
    victims = list(range(0, 3000, 97)) + list(range(3000, 4280, 31)) \
        + [4281, 4300, 4319]
    seg, flat = seg.delete(victims), flat.delete(victims)
    _same_results(seg, flat, Q, "deleted", engine)
    merged = seg.merge_segments(2, 15)
    _same_results(merged, flat, Q, "merged", engine)
    _same_results(merged, seg, Q, "merge is invisible", engine)
    seg, flat = merged.compact(), flat.compact()
    _same_results(seg, flat, Q, "compacted", engine)


def test_sharded_generations_scored_by_code_match_on_card(gen):
    """On the card a generation's code-match scores come from the
    code_match kernel, bit-equal to ref.match_scores, once per generation
    per ``codes_pallas`` search beside the base's; a page kernel scores
    the base and each generation with its own kernel (``fused``:
    fused_phase1, no code_match; ``fused_int8``: fused_phase1_quant)."""
    from repro_torch.dist import shard_index as si

    seg, _, V = _sharded_pair(gen)
    for _ in range(3):
        seg = seg.add_documents(torch.randn((64, V.shape[1]), generator=gen,
                                            device="cuda"))
    seg = seg.add_documents(V[:5] * 2).delete([3001, 3070])
    q = trerank.normalize(V[:6])
    qcodes = seg.encoder.encode(q)
    w = torch.rand(qcodes.shape, generator=gen, device="cuda")
    for s in seg.segments:
        got = si._generation_scores(s.codes[0], s.live[0], qcodes, w)
        want = tref.match_scores(s.codes[0], qcodes, w).masked_fill(
            ~s.live[0][None, :], float("-inf"))
        assert torch.equal(got, want)
    n_gens = seg.n_segments + 1
    before_cm = cm_ops.launches
    seg.search(q, k=10, page=320, engine="codes_pallas")
    assert cm_ops.launches - before_cm == \
        (1 + n_gens) * cm_kernel.KERNELS_PER_CALL
    before_cm, before_fp = cm_ops.launches, tops.launches
    seg.search(q, k=10, page=320, engine="fused")
    assert cm_ops.launches == before_cm
    assert tops.launches - before_fp == (1 + n_gens) * tkernel.KERNELS_PER_CALL
    before_q = tops.quant_launches
    seg.search(q, k=10, page=320, engine="fused_int8")
    assert tops.quant_launches - before_q == \
        (1 + n_gens) * tkernel.KERNELS_PER_CALL


def test_fused_int8_generation_scores_independent_of_width(gen):
    """fused_phase1_quant gives a row the same score bits in a 64-row
    generation and inside a 2,048-row one, at another offset, dead rows
    around it: the int8 sums are exact and the combine is fixed."""
    n = 48
    rows = torch.randn((64, n), generator=gen, device="cuda")
    wide = torch.randn((2048, n), generator=gen, device="cuda")
    wide[1000:1064] = rows
    q = trerank.normalize(torch.randn((16, n), generator=gen, device="cuda"))

    def scores(table, live):
        t = tquant.quantize_table(table)
        s, i = tops.fused_phase1_quant(t.codes, t.scale, t.zero, q,
                                       page=table.shape[0], live=live)
        out = torch.full_like(s, float("nan"))
        fin = torch.isfinite(s)
        out[fin.nonzero(as_tuple=True)[0], i[fin].long()] = s[fin]
        return out

    live = torch.rand(2048, generator=gen, device="cuda") < 0.5
    live[1000:1064] = True
    narrow = scores(rows, torch.ones(64, dtype=torch.bool, device="cuda"))
    assert torch.equal(scores(wide, live)[:, 1000:1064], narrow)
    t = tquant.quantize_table(rows)
    assert torch.equal(narrow, tref.quant_split_scores(
        t.codes, t.scale, t.zero, q, q.sum(dim=-1)))


def test_donated_ingest_allocates_nothing_on_card(gen):
    """A donated batch that fits the active buffer allocates no device
    memory and answers what a copying ingest of the same batch answers."""
    from repro_torch.dist.shard_index import ShardedVectorIndex

    V = torch.randn((3000, 48), generator=gen, device="cuda")
    a = ShardedVectorIndex.build_sharded(V, seal_threshold=None,
                                         device="cuda")
    a = a.add_documents(torch.randn((100, 48), generator=gen, device="cuda"))
    assert a.seg_capacity == 100
    a = a.add_documents(torch.randn((10, 48), generator=gen, device="cuda"))
    assert a.seg_capacity == 200
    W = torch.randn((50, 48), generator=gen, device="cuda")
    copied = a.add_documents(W)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    donated = a.add_documents(W, donate=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert donated.seg_vectors.data_ptr() == a.seg_vectors.data_ptr()
    Q = torch.cat([W[:8], V[:8]])
    for engine in SHARD_ENGINES:
        for page in (33, 320):
            x = donated.search(Q, k=10, page=page, engine=engine)
            y = copied.search(Q, k=10, page=page, engine=engine)
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]), \
                (engine, page)


# ------------------------------------------------- the obs plane on the card
@pytest.mark.parametrize("engine", ["fused", "fused_int8"])
def test_full_plane_bit_parity_on_card(gen, engine):
    """Metrics, tracer, slow log, build watch and ``profile=True`` give
    the bare engine's answers bit for bit, on a flat index and on a
    segmented one with tombstones; every tree tiles its root and names
    the kernel, and the segmented phase1 node's counts add up."""
    from repro_torch.core import VectorIndex
    from repro_torch.dist.shard_index import ShardedVectorIndex
    from repro_torch.obs import (CompileWatch, MetricsRegistry, SlowLog,
                                 Tracer)
    from repro_torch.serve import BatchedSearchEngine

    V = torch.randn((20000, 48), generator=gen, device="cuda")
    flat = VectorIndex.build(V, device="cuda")
    seg = ShardedVectorIndex.build_sharded(V, seal_threshold=256,
                                           device="cuda")
    for rows in (300, 300, 50):              # gen0, gen1, active
        seg = seg.add_documents(torch.randn((rows, 48), generator=gen,
                                            device="cuda"))
    seg = seg.delete(np.array([5, 20001, 20640]))
    Q = (V[:64] + 0.01 * torch.randn((64, 48), generator=gen,
                                     device="cuda")).cpu().numpy()
    kw = dict(batch_size=16, k=10, page=320, engine=engine)
    for index, gens in ((flat, None), (seg, ["gen0", "gen1"])):
        reg = MetricsRegistry()
        off = MetricsRegistry(enabled=False)
        bare = BatchedSearchEngine(index, metrics=off,
                                   compile_watch=CompileWatch(metrics=off),
                                   **kw)
        full = BatchedSearchEngine(
            index, metrics=reg, tracer=Tracer(sample=1.0, annotate=True),
            slowlog=SlowLog(threshold_s=0.0, metrics=reg),
            compile_watch=CompileWatch(metrics=reg), **kw)
        try:
            want = [f.result(timeout=120) for f in
                    [bare.submit(q) for q in Q]]
            got = [f.result(timeout=120) for f in
                   [full.submit(q, profile=True) for q in Q]]
        finally:
            bare.close()
            full.close()
        for (wi, ws), (gi, gs, tree) in zip(want, got):
            assert np.array_equal(wi, gi) and np.array_equal(ws, gs)
            kids = {c["name"]: c for c in tree["children"]}
            assert abs(sum(c["duration_s"] for c in kids.values())
                       - tree["duration_s"]) < 1e-6
            phase1 = [c for c in kids["dispatch"]["children"]
                      if c["name"] == "phase1"][0]
            assert phase1["attrs"]["kernel"] == engine
            if gens is not None:
                parts = {c["name"]: c["attrs"]["candidates"]
                         for c in phase1["children"] if c["name"] != "group0"}
                assert list(parts) == ["base", *gens, "active"]
                assert sum(parts.values()) == phase1["attrs"]["candidates"]
        assert reg.value("engine.requests.completed") == len(Q)
        assert reg.value("slowlog.captured") == len(Q)


# ---------------------------------------------------- the store on the card
_STORE_LEAVES = ("vectors", "codes", "post_docs", "post_codes", "offsets",
                 "live", "seg_vectors", "seg_codes", "seg_gids", "seg_live")


def _assert_same_index(a, b, ctx):
    """Leaves, segments and counters equal, moved to the CPU first."""
    for name in _STORE_LEAVES:
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), \
            (ctx, name)
    assert len(a.segments) == len(b.segments), ctx
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.n_rows, sa.tombstones) == (sb.n_rows, sb.tombstones), ctx
        for name in ("vectors", "codes", "gids", "live", "post_docs",
                     "post_codes"):
            assert torch.equal(getattr(sa, name).cpu(),
                               getattr(sb, name).cpu()), (ctx, name)
    for name in ("n_docs", "n_appended", "seg_base", "active_tombstones",
                 "shard_tombstones", "seal_threshold"):
        assert getattr(a, name) == getattr(b, name), (ctx, name)


def test_store_recovers_card_index_bit_identical(gen, tmp_path):
    """A store written from a card index (card batches logged as their
    host rows, a commit mid-stream, a merge and its commit) recovers on
    the card with every leaf and every engine's answers bit-identical to
    the never-crashed index."""
    from repro_torch.dist.shard_index import ShardedVectorIndex
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.store import Store, recover

    V = torch.randn((5000, 48), generator=gen, device="cuda")
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    live = store.open_index(ShardedVectorIndex.build_sharded(
        V, seal_threshold=256, device="cuda"))
    for i, rows in enumerate((300, 300, 300, 50)):
        live = live.add_documents(torch.randn((rows, 48), generator=gen,
                                              device="cuda"))
        if i == 1:
            store.commit(live)
    live = live.delete(torch.tensor([5, 5001, 5310, 5940]))
    Q = torch.cat([V[:16], live.seg_vectors[0, :4]])
    for stage in ("ingested", "merged"):
        rec, seq = recover(str(tmp_path), device="cuda")
        assert seq == live.translog_seq and rec.device.type == "cuda"
        _assert_same_index(live.inner, rec, stage)
        for engine in SHARD_ENGINES:
            for page in (33, 320):
                x = live.search(Q, k=10, page=page, engine=engine)
                y = rec.search(Q, k=10, page=page, engine=engine)
                assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]), \
                    (stage, engine, page)
        live = live.merge_segments(0, live.n_segments)
        store.commit(live)
    store.close()


def test_cpu_commit_restores_on_card(gen, tmp_path):
    """A commit written from a CPU index restores on the card with every
    leaf equal to a CPU restore of the same commit."""
    from repro_torch.dist.shard_index import ShardedVectorIndex
    from repro_torch.store import latest_commit, restore, write_commit

    V = torch.randn((3000, 40), generator=gen, device="cuda").cpu()
    idx = ShardedVectorIndex.build_sharded(V, seal_threshold=128,
                                           device="cpu")
    idx = idx.add_documents(torch.randn((300, 40), generator=gen,
                                        device="cuda").cpu())
    idx = idx.delete([3, 3001, 3290])
    write_commit(str(tmp_path), idx, 2)
    commit = latest_commit(str(tmp_path))
    on_card = restore(commit, device="cuda")
    assert on_card.device.type == "cuda"
    _assert_same_index(on_card, restore(commit, device="cpu"), "card vs cpu")
    _assert_same_index(on_card, idx, "card vs source")


# ------------------------------------- S shards x R replica groups on the card
def _shard_mesh_index(gen, n_docs, layout, n=48):
    from repro_torch.core import VectorIndex
    from repro_torch.launch import make_shard_mesh

    V = torch.randn((n_docs, n), generator=gen, device="cuda")
    flat = VectorIndex.build(V, device="cuda")
    return flat, flat.shard(make_shard_mesh(*layout))


@pytest.mark.parametrize("engine", ["codes_pallas", "fused", "fused_int8"])
@pytest.mark.parametrize("n_docs", [4096, 4099])
def test_sharded_four_by_two_equals_one_shard_on_card(gen, engine, n_docs):
    """4 shards x 2 groups at page >= n_docs, both transports, any single
    live group, on the card: the one-shard index's answer bit for bit, each
    kernel launched once per shard and batch row-block."""
    flat, sidx = _shard_mesh_index(gen, n_docs, (4, 2))
    one = flat.shard()
    Q = torch.cat([flat.vectors[:5], torch.randn(
        (6, flat.n_features), generator=gen, device="cuda")])
    want = one.search(Q, k=10, page=2 * n_docs, engine=engine)
    assert sidx.vectors.data_ptr() == flat.vectors.data_ptr() \
        or n_docs % 4
    for merge in ("gather", "stream"):
        for groups in (None, (0,), (1,)):
            before = (tops.launches, tops.quant_launches, cm_ops.launches)
            got = sidx.search(Q, k=10, page=2 * n_docs, engine=engine,
                              merge=merge, live_groups=groups)
            assert torch.equal(got[0], want[0]), (merge, groups)
            assert torch.equal(got[1], want[1]), (merge, groups)
            blocks = 2 if groups is None else 1
            n = {"fused": tops.launches - before[0],
                 "fused_int8": tops.quant_launches - before[1],
                 "codes_pallas": cm_ops.launches - before[2]}[engine]
            per = (cm_kernel.KERNELS_PER_CALL if engine == "codes_pallas"
                   else tkernel.KERNELS_PER_CALL)
            assert n == 4 * blocks * per, (engine, n)
    assert torch.equal(got[0][:5, 0].long(), torch.arange(5, device="cuda"))


def test_sharded_kernels_vs_plain_on_a_shard(gen):
    """Each kernel of the sharded path held to its plain version on shard
    1's slice of a 4-shard index, with the tombstones of a delete:
    fused_phase1 bit-equal to its reference (ids where finite),
    fused_phase1_quant to the split reference's stable top page, and
    code_match to ref.match_scores."""
    from repro_torch.core.postings import idf_weights

    _, sidx = _shard_mesh_index(gen, 8192, (4, 1))
    sidx = sidx.delete(list(range(2048, 4096, 7)))
    # shard 1's rows 1..6: ids 2049..2054, none of them deleted
    q = trerank.normalize(sidx.vectors[1, 1:7] + 0.01 * torch.randn(
        (6, sidx.n_features), generator=gen, device="cuda"))
    qcodes = sidx.encoder.encode(q)
    w = idf_weights(sidx.token_df(q), sidx.n_ids)
    codes, live = sidx.codes[1], sidx.live[1]
    assert not bool(live.all())
    s, i = tops.fused_phase1(codes, qcodes, w, 320, live=live)
    ws, wi = tref.fused_phase1_ref(codes, qcodes, w, 320, live=live)
    fin = torch.isfinite(ws)
    assert torch.equal(s, ws) and torch.equal(i[fin], wi[fin])
    got = cm_ops.code_match(codes, qcodes, w)
    assert torch.equal(got, tref.match_scores(codes, qcodes, w))
    c8, sc, zp = (t[1] for t in sidx._quant_base())
    s, i = tops.fused_phase1_quant(c8, sc, zp, q, 320, live=live)
    split = tref.quant_split_scores(c8, sc, zp, q, q.sum(dim=-1))
    top_s, top_i = trerank.stable_topk(
        split.masked_fill(~live[None, :], float("-inf")), 320)
    fin = torch.isfinite(top_s)
    assert torch.equal(s, top_s)
    assert torch.equal(i.long()[fin], top_i[fin])
    # the shard's page goes global by its offset
    ids, _ = sidx.search(q, k=1, page=320, engine="fused")
    assert ids[:, 0].tolist() == list(range(2049, 2055))


# ------------------------------------------------- the obs plane's device side
def test_device_bytes_on_card_reconcile_with_allocator(gen):
    """Storage bytes on ``cuda:0``, at most what the allocator holds;
    4 x 2 shards of a flat index view its vectors and codes."""
    from repro_torch.core import VectorIndex
    from repro_torch.dist.shard_index import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh
    from repro_torch.obs import device_bytes

    V = torch.randn((4096, 64), generator=gen, device="cuda")
    idx = VectorIndex.build(V)
    dev = device_bytes(idx)
    rec = dev["reconciliation"]
    assert set(dev["per_device"]) == {"cuda:0"}
    assert rec["accounted_bytes"] == dev["per_device"]["cuda:0"] \
        == dev["total_bytes"]
    assert rec["accounted_bytes"] <= rec["process_live_bytes"] \
        == torch.cuda.memory_allocated()
    assert rec["live_leaves"] == dev["n_leaves"] == 4
    s42 = ShardedVectorIndex.from_index(idx, mesh=make_shard_mesh(4, 2))
    sdev = device_bytes(s42)
    shared = {"vectors": "[<flat index 0>]", "codes": "[<flat index 1>]"}
    flat = {l["path"]: l["nbytes"] for l in dev["leaves"]}
    sharded = {l["path"]: l["nbytes"] for l in sdev["leaves"]}
    for path, flat_path in shared.items():
        assert sharded[path] == flat[flat_path]
    assert sdev["reconciliation"]["accounted_bytes"] <= \
        torch.cuda.memory_allocated()


@pytest.mark.parametrize("kernel", ["fused_phase1", "fused_phase1_quant",
                                    "code_match", "bucketize",
                                    "rerank_topk"])
def test_cost_row_same_on_kernel_and_plain_path(gen, kernel):
    """A wrapper files the same operations and bytes whether the card's
    kernel or the CPU's plain version runs the call."""
    from repro_torch.core import RoundingEncoder
    from repro_torch.core.quantize import quantize_table
    from repro_torch.obs import CompileWatch, MetricsRegistry

    D = torch.randint(-8, 8, (3000, 40), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (4, 40), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((4, 40), generator=gen, device="cuda")
    V = trerank.normalize(torch.randn((3000, 40), generator=gen,
                                      device="cuda"))
    ids = torch.randint(0, 3000, (4, 64), generator=gen, device="cuda",
                        dtype=torch.int32)
    qt = quantize_table(V)
    call = {
        "fused_phase1": lambda d: tops.fused_phase1(
            D.to(d), Qc.to(d), W.to(d), 64),
        "fused_phase1_quant": lambda d: tops.fused_phase1_quant(
            qt.codes.to(d), qt.scale.to(d), qt.zero.to(d), V[:4].to(d), 64),
        "code_match": lambda d: cm_ops.code_match(D.to(d), Qc.to(d),
                                                  W.to(d)),
        "bucketize": lambda d: bk_ops.encode(V.to(d), RoundingEncoder(2)),
        "rerank_topk": lambda d: rk_ops.rerank_topk(V.to(d), ids.to(d),
                                                    V[:4].to(d), 10),
    }[kernel]
    watch = CompileWatch(metrics=MetricsRegistry())
    for d in ("cuda", "cpu"):
        with watch.region(d):
            call(d)
    rows = {r["region"]: r for r in watch.costs.rows()}
    assert set(rows) == {"cuda", "cpu"}
    for key in ("program", "flops", "bytes_accessed", "op_kind",
                "launches"):
        assert rows["cuda"][key] == rows["cpu"][key], key
    assert rows["cuda"]["program"] == kernel


def test_node_stats_and_bundle_on_card(gen):
    from repro_torch.core import VectorIndex
    from repro_torch.obs import (BUNDLE_SECTIONS, MetricsRegistry,
                                 diagnostics_bundle)
    from repro_torch.serve.engine import BatchedSearchEngine

    idx = VectorIndex.build(torch.randn((4096, 64), generator=gen,
                                        device="cuda"))
    eng = BatchedSearchEngine(idx, batch_size=4, k=5, page=64,
                              engine="fused", metrics=MetricsRegistry())
    try:
        for q in torch.randn((4, 64), generator=gen,
                             device="cuda").cpu().numpy():
            eng.search(q, timeout=120)
        ns = eng.node_stats()
        bundle = diagnostics_bundle(eng, reason="test")
    finally:
        eng.close()
    assert set(ns["nodes"]) == {f"cuda:{i}"
                                for i in range(torch.cuda.device_count())}
    node = ns["nodes"]["cuda:0"]
    assert node["platform"] == "cuda"
    assert node["memory_stats"]["allocated_bytes.all.current"] > 0
    assert node["index_bytes"] == eng.device_stats()["per_device"]["cuda:0"]
    assert tuple(bundle) == BUNDLE_SECTIONS
    assert bundle["meta"]["backend"] == "cuda"
    assert bundle["meta"]["n_devices"] == torch.cuda.device_count()
    assert bundle["stats"]["requests"]["completed"] == 4


def test_launcher_on_card(gen, tmp_path):
    """``python -m repro_torch.launch.serve`` on the card: a 2 x 2 cluster
    serving ``fused``, its failover bit-identical, its bundles valid, its
    kernel launched."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "3000",
         "--features", "64", "--queries", "32", "--engine", "fused",
         "--shards", "2", "--replicas", "2", "--cluster", "--fail-shard",
         "1", "--diagnostics-on-exit", str(tmp_path)],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "results bit-identical to the healthy cluster" in run.stdout
    launches = json.loads(run.stdout.splitlines()[-1].split(": ", 1)[1])
    assert launches["fused_phase1"] > 0
    val = subprocess.run(
        [sys.executable, os.path.join(repo, "tools",
                                      "validate_diag_bundle_torch.py"),
         str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert val.returncode == 0, val.stdout + val.stderr


# ------------------------------------------------- the dense LM (phase L)
def _lm_batch(seed, batch, seq, vocab, device):
    from repro_torch.data import lm_batch

    b = lm_batch(np.random.default_rng(seed), batch, seq, vocab)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def test_lm_card_matches_cpu(gen):
    """chip_smoke's L0 at a smaller size: one layer at qwen2-0.5b's widths,
    vocab 8,192, seq 128: logits, loss, gradients and one AdamW step fed
    the CPU's gradients on the card against the CPU, with the CPU parity
    tests' bounds."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch("qwen2-0.5b").cfg, n_layers=1, vocab=8192)
    cpu = lm.init_params(cfg, device="cpu", seed=1)
    card = lm.LM(cfg, device="cuda").load_tree(cpu.tree())
    b = {"cpu": _lm_batch(0, 2, 128, cfg.vocab, "cpu")}
    b["cuda"] = {k: v.cuda() for k, v in b["cpu"].items()}
    models = {"cpu": cpu, "cuda": card}
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.no_grad():
            lg = {n: m(b[n]["tokens"])[0].float().cpu() for n, m in models.items()}
        loss, grads = {}, {}
        for n, m in models.items():
            l = lm.lm_loss(m, b[n])
            l.backward()
            loss[n] = float(l.detach())
            grads[n] = m.tree(grads=True)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    assert float((lg["cuda"] - lg["cpu"]).abs().max()) <= 2e-2 * float(lg["cpu"].abs().max())
    assert abs(loss["cuda"] - loss["cpu"]) <= 2e-3 * abs(loss["cpu"])
    ga, gb = (torch.cat([g.double().reshape(-1).cpu() for g in tree_leaves(grads[n])])
              for n in ("cpu", "cuda"))
    assert abs(float(ga.norm()) - float(gb.norm())) <= 1e-2 * float(ga.norm())
    assert float(ga @ gb) / float(ga.norm() * gb.norm()) >= 0.999
    new = {}
    for n, m in models.items():
        d = "cuda" if n == "cuda" else "cpu"
        tree = m.tree()
        new[n] = adamw_update(tree_map(lambda t: t.to(d), grads["cpu"]),
                              adamw_init(tree), tree, AdamWConfig(), 0.5)
    for x, y in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"])):
        x = x.float().cpu()
        y = y.float()
        assert float((x - y).abs().max()) <= 1e-6 * max(float(y.abs().max()), 1e-30)


def test_lm_resume_bit_exact_on_card(gen, tmp_path):
    """The reference's ``test_resume_is_bit_exact`` at its tiny config on
    the card: 12 steps straight against 6, a checkpoint and a resume."""
    from repro_torch.models.transformer.model import LMConfig, init_params, lm_loss
    from repro_torch.train import (AdamWConfig, TrainLoopConfig, adamw_init,
                                   make_train_step, run_train_loop)
    from repro_torch.train.tree import tree_leaves

    cfg = LMConfig("tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                   d_head=16, d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
    step = make_train_step(lambda m, b: lm_loss(m, b), AdamWConfig(lr=1e-2),
                           accum=2)

    def fresh():
        m = init_params(cfg, device="cuda", seed=0)
        return m, adamw_init(m)

    def batch(i):
        return _lm_batch(i, 8, 16, 64, "cuda")

    pa, *_ = run_train_loop(step, *fresh(), batch,
                            TrainLoopConfig(12, str(tmp_path / "a"), ckpt_every=12))
    run_train_loop(step, *fresh(), batch,
                   TrainLoopConfig(6, str(tmp_path / "b"), ckpt_every=6))
    pb, ob, _ = run_train_loop(step, *fresh(), batch,
                               TrainLoopConfig(12, str(tmp_path / "b"), ckpt_every=6))
    assert int(ob.step) == 12
    for x, y in zip(tree_leaves(pa.tree()), tree_leaves(pb.tree())):
        assert torch.equal(x, y)


# ------------------------------------------- recsys and GIN (phase M)
def _fp32_products():
    """TF32 off for the f32 models' products -> the previous setting."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    return was


def test_recsys_card_matches_cpu(gen):
    """chip_smoke's M0 for BST at its smoke config: logits, loss, user
    embedding and gradients on the card against the CPU (float32, TF32
    off), one AdamW step fed the CPU's gradients, and two identical
    training steps on the card bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.models.recsys.models import bce_loss
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves, tree_map

    arch = get_arch("bst")
    cfg = arch.smoke_cfg
    cpu = arch.init_fn(cfg, device="cpu", seed=1)
    card = arch.init_fn(cfg, device="cuda", seed=1).load_tree(cpu.tree())
    nb = recsys_batch(np.random.default_rng(0), 64, 1, [cfg.item_vocab],
                      seq_len=cfg.seq_len)
    b = {d: {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
         for d in ("cpu", "cuda")}
    models = {"cpu": cpu, "cuda": card}
    was = _fp32_products()
    try:
        with torch.no_grad():
            lg = {d: arch.forward_fn(m, b[d], cfg).cpu() for d, m in models.items()}
            us = {d: arch.user_fn(m, b[d], cfg).cpu() for d, m in models.items()}
        loss, grads = {}, {}
        for d, m in models.items():
            l = bce_loss(arch.forward_fn, m, b[d], cfg)
            l.backward()
            loss[d] = float(l.detach())
            grads[d] = m.tree(grads=True)
            m.zero_grad(set_to_none=True)
        assert float((lg["cuda"] - lg["cpu"]).abs().max()) <= 1e-5 * float(lg["cpu"].abs().max())
        assert float((us["cuda"] - us["cpu"]).abs().max()) <= 1e-5 * float(us["cpu"].abs().max())
        assert abs(loss["cuda"] - loss["cpu"]) <= 1e-6 * abs(loss["cpu"])
        ga, gb = (torch.cat([g.double().reshape(-1).cpu() for g in tree_leaves(grads[d])])
                  for d in ("cpu", "cuda"))
        assert abs(float(ga.norm()) - float(gb.norm())) <= 1e-5 * float(ga.norm())
        assert float(ga @ gb) / float(ga.norm() * gb.norm()) >= 0.99999
        new = {}
        for d, m in models.items():
            tree = m.tree()
            new[d] = adamw_update(tree_map(lambda t: t.to(d), grads["cpu"]),
                                  adamw_init(tree), tree, AdamWConfig(), 0.5)
        for x, y in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"])):
            assert float((x.cpu() - y).abs().max()) <= 1e-6 * max(float(y.abs().max()), 1e-30)
        runs = []
        for _ in range(2):
            m = arch.init_fn(cfg, device="cuda", seed=1)
            step = make_train_step(lambda mm, bb: bce_loss(arch.forward_fn, mm, bb, cfg),
                                   AdamWConfig(lr=1e-2))
            o = adamw_init(m)
            for _ in range(2):
                m, o, _ = step(m, o, b["cuda"])
            runs.append(tree_leaves({"p": m.tree(), "o": o}))
        assert all(torch.equal(x, y) for x, y in zip(*runs))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_gin_aggregate_bit_equal_on_card(gen):
    """GIN's neighbour sum on the card: two runs of the forward and the
    backward to ``h`` bit-equal (sorted bags, no atomics), and within
    1e-5 of the CPU's; two identical training steps bit-equal."""
    from repro_torch.models.gnn import gin
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.tree import tree_leaves

    n, e, d = 20_000, 400_000, 64
    src = torch.randint(-1, n, (e,), generator=gen, device="cuda")
    dst = torch.randint(-1, n, (e,), generator=gen, device="cuda")
    h0 = torch.randn((n, d), generator=gen, device="cuda")
    g = torch.randn((n, d), generator=gen, device="cuda")
    outs = []
    for _ in range(2):
        h = h0.clone().requires_grad_()
        agg = gin._aggregate(h, gin.edge_plan(src, dst, n), n)
        (agg * g).sum().backward()
        outs.append((agg.detach(), h.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    want = gin._aggregate(h0.cpu(), gin.edge_plan(src.cpu(), dst.cpu(), n), n)
    assert float((outs[0][0].cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    cfg = gin.GINConfig(n_layers=2, d_in=d, n_classes=5)
    batch = {"x": h0, "edge_src": src.int(), "edge_dst": dst.int(),
             "labels": torch.randint(0, 5, (n,), generator=gen, device="cuda"),
             "label_mask": torch.ones(n, device="cuda")}
    was = _fp32_products()
    try:
        runs = []
        for _ in range(2):
            m = gin.init_params(cfg, device="cuda", seed=3)
            step = make_train_step(lambda mm, bb: gin.node_loss(mm, bb, cfg),
                                   AdamWConfig(lr=1e-2))
            o = adamw_init(m)
            for _ in range(2):
                m, o, _ = step(m, o, batch)
            runs.append(tree_leaves({"p": m.tree(), "o": o}))
        assert all(torch.equal(x, y) for x, y in zip(*runs))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ------------------------------------------------ the MoE LMs (phase N)
def test_moe_ffn_card_matches_cpu(gen):
    """chip_smoke's N0 moe_ffn at a smaller size (D 1,024, F 2,048, 8
    experts, top-2, 512 bf16 tokens, cf 1.25 so tokens drop): routing and
    kept slots equal wherever the top-2 gap exceeds 1e-5, y on the tokens
    routed alike within 1e-2 of the largest (a bf16 ulp), aux within
    1e-4 where no first choice differs."""
    from repro_torch.models.transformer import moe

    p = moe.moe_init(1024, 2048, 8, 1, gen, device="cuda")
    x = torch.randn((512, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    pc = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
              else v.cpu()) for k, v in p.items()}
    y, aux = moe.moe_ffn(p, x, 2, 1.25)
    yc, auxc = moe.moe_ffn(pc, x.cpu(), 2, 1.25)
    probs, idx, _ = moe.route(p, x, 2)
    probs_c, idx_c, _ = moe.route(pc, x.cpu(), 2)
    s = torch.sort(probs_c, dim=-1, descending=True).values
    clear = (s[:, 1] - s[:, 2]) > 1e-5
    same = (idx.cpu() == idx_c).all(-1)
    assert bool(same[clear].all())
    C = math.ceil(512 * 2 / 8 * 1.25)
    plan = moe.dispatch_plan(idx, 8, C)
    plan_c = moe.dispatch_plan(idx_c, 8, C)
    if bool(same.all()):
        assert torch.equal(plan[3].cpu(), plan_c[3])
        assert abs(float(aux) - float(auxc)) <= 1e-4 * abs(float(auxc))
    assert float((y.cpu()[same].float() - yc[same].float()).abs().max()) <= \
        1e-2 * float(yc.float().abs().max())


def test_moe_lm_steps_bit_equal_on_card(gen):
    """Two training steps of mixtral-smoke (AdamW) and llama4-smoke
    (Adafactor), twice on the card under torch.use_deterministic_algorithms:
    every parameter and optimizer leaf bit-equal (no op of the MoE path
    adds by atomics, and none raises in deterministic mode)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, adafactor_init, adamw_init,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves

    torch.use_deterministic_algorithms(True)
    try:
        for arch_id in ("mixtral-8x22b", "llama4-maverick-400b-a17b"):
            arch = get_arch(arch_id)
            init = adamw_init if arch.optimizer == "adamw" else adafactor_init
            runs = []
            for _ in range(2):
                m = lm.init_params(arch.smoke(), device="cuda", seed=3)
                step = make_train_step(lambda mm, b: lm.lm_loss(mm, b),
                                       AdamWConfig(lr=1e-2), accum=2,
                                       optimizer=arch.optimizer, donate=True)
                o = init(m)
                for i in range(2):
                    m, o, _ = step(m, o, _lm_batch(30 + i, 8, 64,
                                                   arch.smoke().vocab, "cuda"))
                runs.append(tree_leaves({"p": m.tree(), "o": o}))
            assert all(torch.equal(a, b) for a, b in zip(*runs)), arch_id
    finally:
        torch.use_deterministic_algorithms(False)


# --------------------------------------------- the dry-run slice (phase O)
def test_encode_4m_kernel_vs_plain_odd_rows(gen):
    """vectordb-wiki's ``_encode`` on the card at an odd row count: one
    bucketize launch; bit-equal to the plain version on rows whose sums
    of squares are exact in any order (every entry a multiple of 1/8 below
    2, so both norms round the same), and under the bucketize contract on
    Gaussian rows, where the two sum in different orders."""
    from repro_torch.configs import vectordb_wiki as wiki

    B, n = 40_001, wiki.N_FEATURES
    exact = torch.randint(-15, 16, (B, n), generator=gen, device="cuda")
    exact = exact.float() / 8
    gauss = torch.randn((B, n), generator=gen, device="cuda")
    for x, bit_equal in ((exact, True), (gauss, False)):
        before = bk_ops.launches
        got = wiki._encode(x)
        assert bk_ops.launches == before + bk_kernel.KERNELS_PER_CALL
        want = bk_ref.bucketize_ref(x, "round", 100.0, torch.int8)
        assert got.dtype == torch.int8 and got.shape == (B, n)
        if bit_equal:
            assert torch.equal(got, want)
        else:
            _assert_codes(got, want)


def test_reshard_card_to_cpu_and_back_bit_equal(gen):
    """``train/elastic.py``: a tree with an AdamW state (bf16 and f32
    leaves, an int32 step) to a (1, 1) mesh on the CPU and back to the
    card: every leaf on the mesh's device, its dtype and bits unchanged,
    the NamedTuple kept."""
    from repro_torch.dist import P
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.elastic import reshard_tree, resize_data_axis
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.tree import tree_leaves

    params = {"w": torch.randn((64, 96), generator=gen, device="cuda")
              .to(torch.bfloat16),
              "b": [torch.randn((96,), generator=gen, device="cuda")]}
    tree = {"params": params, "opt": AdamWState(
        step=torch.tensor(3, dtype=torch.int32, device="cuda"),
        mu=params, nu=params)}
    card, host = make_local_mesh(1, 1), make_local_mesh(1, 1, device="cpu")
    rule = lambda path, leaf: P()
    on_host = reshard_tree(tree, host, rule)
    back = resize_data_axis(on_host, host, card, rule)
    assert isinstance(back["opt"], AdamWState)
    for a, h, b in zip(tree_leaves(tree), tree_leaves(on_host),
                       tree_leaves(back)):
        assert h.device.type == "cpu" and b.device.type == "cuda"
        assert a.dtype == h.dtype == b.dtype
        assert torch.equal(a, b) and torch.equal(a.cpu(), h)
