"""repro_torch's dry run against the JAX package's, on the CPU.

* every cell of all 11 archs on both production meshes (``FakeMesh``, the
  reference suite's shape-only stand-in): its ``in_specs`` tree has its
  arguments' structure (a model's as its ``tree()``), its in and out
  specs equal the reference cell's leaf by leaf, its arguments the
  reference's shapes and dtypes, and ``input_bytes_per_device`` equals
  the reference's ``_analytic_arg_bytes`` on the reference's own cell;
* ``launch/op_analysis.py``'s dot FLOPs equal ``analyze_hlo``'s on the
  three functions of ``tests/test_dist.py``'s ``TestHloAnalysis`` (the
  scans as Python loops: every iteration runs), and a hand-written
  kernel's call counts as one op of its analytic work on any device;
* ``vectordb-wiki``: ``_encode`` and ``_search`` against the reference's,
  jitted on the CPU, at 8,192 docs x 400, Q 4, page 320, k 10: codes
  bit-equal, the phase-1 page's ids equal (ties included), the final ids
  equal and the scores within the reference suite's rerank tolerance;
* ``run_cell`` on qwen2's smoke config's train, prefill and decode cells
  on ``meta``: the reference's record keys, ``dot_flops`` equal to the
  analytic count of the port's products stated below, the same census
  on the CPU on arguments of zeros, the command line's records written
  and skipped on a rerun.
"""

import ast
import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_IDS as JAX_ALL_IDS
from repro.configs import arch_shapes as jax_arch_shapes
from repro.configs import get_arch as jax_arch
from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs import ALL_IDS, ARCH_IDS, arch_shapes, get_arch
from repro_torch.configs.base import LMArch
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpAnalysis, analyze
from repro_torch.train.tree import as_tree, tree_leaves, tree_map_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_arg_bytes():
    """The reference's ``_analytic_arg_bytes``.  Its module sets
    ``XLA_FLAGS`` for 512 devices on import; the flag is put back at once,
    so this process's JAX keeps the devices it has."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import _analytic_arg_bytes
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return _analytic_arg_bytes


ref_arg_bytes = _ref_arg_bytes()


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
CELLS = [(a, s) for a in ALL_IDS for s in arch_shapes(a)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree) -> list:
    out = []
    tree_map_with_path(lambda path, leaf: out.append(path), tree)
    return out


def _jflat(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def test_registry_holds_all_eleven():
    assert ALL_IDS == JAX_ALL_IDS and len(ALL_IDS) == 11
    assert len(ARCH_IDS) == 10 and "vectordb-wiki" not in ARCH_IDS
    assert len(CELLS) == 42
    for a in ALL_IDS:
        assert arch_shapes(a) == jax_arch_shapes(a)


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_cell_specs_and_bytes_equal_the_references(arch_id, shape):
    for mesh in MESHES:
        cell = get_arch(arch_id).cell(shape, mesh)
        ref = jax_arch(arch_id).cell(shape, mesh)
        assert (cell.arch, cell.shape, cell.kind, cell.note) == (
            ref.arch, ref.shape, ref.kind, ref.note)
        assert len(cell.args) == len(cell.in_specs) == len(ref.args)
        for a, s in zip(cell.args, cell.in_specs):     # the args' trees
            assert _paths(as_tree(a)) == _paths(s), (arch_id, shape)
        args = [t for a in cell.args for t in tree_leaves(as_tree(a))]
        assert all(t.device.type == "meta" for t in args)
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in args] == [
            (tuple(t.shape), str(t.dtype))
            for t in jax.tree_util.tree_leaves(ref.args)]
        assert [tuple(s) for s in tree_leaves(cell.in_specs)] == _jflat(ref.in_specs)
        assert [tuple(s) for s in tree_leaves(cell.out_specs)] == _jflat(ref.out_specs)
        assert dryrun._analytic_arg_bytes(cell.args, cell.in_specs, mesh) == \
            ref_arg_bytes(ref.args, ref.in_specs, mesh)


def test_skipped_shapes_return_no_cell():
    mesh = MESHES[0]
    assert get_arch("qwen2-0.5b").cell("long_500k", mesh) is None
    assert jax_arch("qwen2-0.5b").cell("long_500k", mesh) is None


# ------------------------------------------------------------- op census
def _hlo_dot_flops(fn, *shapes):
    comp = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                               for s in shapes)).compile()
    return analyze_hlo(comp.as_text())["dot_flops"]


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_dot_flops_exact():
    want = _hlo_dot_flops(lambda a, b: a @ b, (32, 64), (64, 16))
    _, got = analyze(lambda a, b: a @ b, _meta(32, 64), _meta(64, 16))
    assert got["dot_flops"] == want == 2 * 32 * 64 * 16
    assert got["ops"] == 1 and got["bytes"] == (32 * 64 + 64 * 16 + 32 * 16) * 4


def test_scan_multiplier():
    def jf(w, xs):
        def body(c, x):
            return c, x @ w
        _, ys = jax.lax.scan(body, 0.0, xs)
        return ys.sum()

    def tf(w, xs):
        return torch.stack([x @ w for x in xs]).sum()

    want = _hlo_dot_flops(jf, (16, 16), (7, 8, 16))
    _, got = analyze(tf, _meta(16, 16), _meta(7, 8, 16))
    assert got["dot_flops"] == want == 7 * 2 * 8 * 16 * 16


def test_nested_scan_multiplier():
    def jf(w, xs):
        def outer(c, x):
            def inner(ci, xi):
                return ci, xi @ w
            _, ys = jax.lax.scan(inner, 0.0, x)
            return c, ys.sum()
        _, out = jax.lax.scan(outer, 0.0, xs)
        return out.sum()

    def tf(w, xs):
        return torch.stack([torch.stack([xi @ w for xi in x]).sum()
                            for x in xs]).sum()

    want = _hlo_dot_flops(jf, (16, 16), (3, 5, 8, 16))
    _, got = analyze(tf, _meta(16, 16), _meta(3, 5, 8, 16))
    assert got["dot_flops"] == want == 3 * 5 * 2 * 8 * 16 * 16


def test_census_decomposes_composites_under_inference_mode():
    a, b = _meta(2, 8, 16), _meta(16, 4)
    _, plain = analyze(lambda x, y: torch.einsum("bij,jk->bik", x, y) @ y.T, a, b)
    with torch.inference_mode():
        _, inf = analyze(lambda x, y: torch.einsum("bij,jk->bik", x, y) @ y.T,
                         a, b)
    assert inf["dot_flops"] == plain["dot_flops"] == 2 * 2 * (2 * 8 * 16 * 4)


def test_census_counts_elementwise_backward_and_kernels():
    x = torch.randn(8, 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)
    with OpAnalysis() as oa:
        y = torch.tanh(x @ w)                   # 1 mm, 24 elements
        y.sum().backward()                      # 2 mm, tanh_backward
    got = oa.result()
    assert got["dot_flops"] == 3 * 2 * 8 * 4 * 3
    assert got["elementwise_flops"] >= 2 * 24
    assert got["flops"] == got["dot_flops"] + got["elementwise_flops"]
    # a kernel wrapper's call: one op of its analytic work, on any device
    from repro_torch.kernels.bucketize import ops
    from repro_torch.obs import cost
    work = cost.bucketize_work(10, 4, 1)
    for dev in ("cpu", "meta"):
        _, got = analyze(ops.bucketize, torch.zeros(10, 4, device=dev),
                         "round", 100.0)
        assert (got["flops"], got["kernel_flops"], got["bytes"], got["ops"],
                got["kernels"]) == (work.ops, work.ops, work.nbytes, 1,
                                    {"bucketize": 1})


def test_census_leaves_views_and_allocations_out_of_bytes():
    x = _meta(4, 6)
    _, got = analyze(lambda t: t.view(6, 4).t().unsqueeze(0)[0, 1:], x)
    assert got["bytes"] == 0 and got["flops"] == 0 and got["ops"] >= 2
    _, got = analyze(lambda t: torch.empty_like(t).to(torch.int32), x)
    assert got["bytes"] == 4 * 6 * 8 and got["elementwise_flops"] == 24


# ---------------------------------------------------------- vectordb-wiki
def _wiki_inputs(d=8192, n=400, Q=4, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(d, n)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    src = rng.choice(d, Q, replace=False)
    qs = (V[src] + 0.01 * rng.normal(size=(Q, n))).astype(np.float32)
    return V, qs, src


def test_vectordb_wiki_matches_the_reference():
    from repro.configs import vectordb_wiki as J
    from repro.core.codes import score_codes as jscore
    from repro.core.filtering import TrimFilter as JTrim
    from repro.core.filtering import expand_mask as jexpand
    from repro.core.filtering import feature_mask as jmask
    from repro.core.rerank import normalize as jnormalize
    from repro_torch.configs import vectordb_wiki as T

    V, qs, src = _wiki_inputs()
    jcodes = np.asarray(jax.jit(J._encode)(jnp.asarray(V)))
    tcodes = T._encode(torch.from_numpy(V))
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)

    @jax.jit
    def jpage(codes, queries):                  # the reference's phase 1
        q = jnormalize(queries)
        qc = J.ENCODER.encode(q)
        w = jnp.where(jexpand(jmask(q, trim=JTrim(0.05)), qc.shape[-1]),
                      1.0, 0.0)
        return jax.lax.top_k(jscore(codes, qc, w, block=131072), 320)

    jvals, jids = jpage(jnp.asarray(jcodes), jnp.asarray(qs))
    _, tids = T._page(tcodes, torch.from_numpy(qs), 320, 0.05)
    jvals = np.asarray(jvals)
    assert (jvals[:, :-1] == jvals[:, 1:]).any()        # ties at stake
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))

    ji, js = jax.jit(lambda a, b, c: J._search(a, b, c, 320, 10, 0.05))(
        jnp.asarray(V), jnp.asarray(jcodes), jnp.asarray(qs))
    ti, ts = T._search(torch.from_numpy(V), tcodes, torch.from_numpy(qs),
                       320, 10, 0.05)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=5e-5)
    assert (ti[:, 0].numpy() == src).all()


def test_vectordb_wiki_arch_is_the_references():
    from repro.configs import vectordb_wiki as J
    from repro_torch.configs import vectordb_wiki as T
    arch, ref = get_arch("vectordb-wiki"), jax_arch("vectordb-wiki")
    assert type(arch).SHAPES == type(ref).SHAPES
    assert (arch.family, arch.skip_shapes) == (ref.family, ref.skip_shapes)
    assert (T.N_DOCS, T.N_FEATURES) == (J.N_DOCS, J.N_FEATURES) == (4_181_504, 400)
    assert T.ENCODER.precision == J.ENCODER.precision == 2


# --------------------------------------------------------------- run_cell
def _ref_record_keys() -> set:
    """The keys of the reference's record, read from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in the reference's dryrun.py")


SMOKE_SHAPES = {
    "train_4k": dict(kind="train", seq=32, batch=4, accum=2),
    "prefill_32k": dict(kind="prefill", seq=32, batch=2),
    "decode_32k": dict(kind="decode", seq=32, batch=2),
}


def _smoke_arch():
    full = get_arch("qwen2-0.5b")
    arch = LMArch(full.smoke(), optimizer=full.optimizer)
    arch.SHAPES = SMOKE_SHAPES
    return arch


def _qwen_smoke_dot_flops(kind: str) -> int:
    """The port's products, counted by hand: per layer and token the QKV
    projection 2 D (H + 2 KV) dh, the output projection 2 H dh D and the
    gated FFN 3 * 2 D F; chunked causal attention visits n (n + 1) / 2
    (query chunk, key chunk) pairs of c x c (n = S / c), each two
    products of 2 H c c dh a row; the tied unembed 2 D V a token.  A
    training step runs each super-block's products four times (forward,
    the checkpoint's recompute, two backward products each), but for the
    last, the FFN's down-projection: the recompute stops once it holds
    every tensor the backward saved (``torch.utils.checkpoint``'s early
    stop), so that product runs three times; the unembed runs three
    times; prefill unembeds the last position only; decode reads all S
    cache slots with two products of 2 H S dh a row."""
    cfg = get_arch("qwen2-0.5b").smoke()
    D, H, KV, dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_layers)
    info = SMOKE_SHAPES[kind]
    B, S = info["batch"], info["seq"]
    per_token = 2 * D * (H + 2 * KV) * dh + 2 * H * dh * D + 6 * D * F
    c = min(cfg.q_chunk, S)
    n = S // c
    attn_row = n * (n + 1) // 2 * 2 * (2 * H * c * c * dh)
    layer = B * S * per_token + B * attn_row
    if kind == "train_4k":
        return L * (4 * layer - B * S * 2 * F * D) + 3 * B * S * 2 * D * V
    if kind == "prefill_32k":
        return L * layer + B * 2 * D * V
    return L * (B * per_token + B * 2 * (2 * H * S * dh)) + B * 2 * D * V


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
def test_run_cell_smoke_lm(shape, tmp_path):
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    arch = _smoke_arch()
    mesh = make_production_mesh()
    census = {}
    rec = dryrun.run_cell(arch.cell(shape, mesh), mesh, "single_16x16",
                          str(tmp_path), census=census)
    assert census["dot_flops"] == rec["dot_flops_per_device"]
    assert _ref_record_keys() <= set(rec)
    assert rec["dot_flops_per_device"] == _qwen_smoke_dot_flops(shape)
    assert rec["flops_per_device"] > rec["dot_flops_per_device"]
    assert rec["collective_bytes_per_device"] is None
    assert rec["memory_analysis"]["temp_size_in_bytes"] is None
    assert rec["device"] == "meta" and rec["trace_s"] >= 0
    saved = json.loads((tmp_path / "single_16x16" /
                        f"qwen2-smoke__{shape}.json").read_text())
    assert saved == rec
    # the same step on the CPU, on arguments of zeros: the same FLOPs; the
    # bytes apart only by what a meta tensor cannot show (no address, so
    # load_tree's same-storage test skips its write-back; Python constants
    # made tensors another way), under 1%
    cpu = dryrun.trace_cell(arch.cell(shape, mesh), "cpu")
    for key in ("flops", "dot_flops", "elementwise_flops"):
        assert cpu[key] == census[key], key
    assert abs(cpu["bytes"] - census["bytes"]) < 0.01 * census["bytes"]
    assert cpu["argument_size_in_bytes"] == census["argument_size_in_bytes"]
    # a local mesh of one cell holds every argument whole
    local = make_local_mesh(1, 1, device="cpu")
    cell = arch.cell(shape, local)
    assert dryrun._analytic_arg_bytes(cell.args, cell.in_specs, local) == \
        census["argument_size_in_bytes"]


def test_dryrun_command_writes_and_skips(tmp_path, capsys):
    out = str(tmp_path / "dr")
    argv = ["--arch", "vectordb-wiki", "--mesh", "both", "--out", out]
    dryrun.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("OK", "FAIL", "SKIP"))]
    assert len(lines) == 6 and all(ln.startswith("OK") for ln in lines)
    names = sorted(p.relative_to(out).as_posix()
                   for p in pathlib.Path(out).rglob("*.json"))
    assert names == sorted(f"{m}/vectordb-wiki__{s}.json"
                           for m in ("single_16x16", "multi_2x16x16")
                           for s in ("search_b128", "search_b1", "encode_4m"))
    want = {("single_16x16", "search_b128"): 522_892_800,
            ("single_16x16", "search_b1"): 522_689_600,
            ("single_16x16", "encode_4m"): 418_150_400,
            ("multi_2x16x16", "search_b128"): 261_548_800,
            ("multi_2x16x16", "search_b1"): 261_345_600,
            ("multi_2x16x16", "encode_4m"): 209_075_200}
    recs = {}
    for (m, s), b in want.items():
        recs[m, s] = json.loads((pathlib.Path(out) / m /
                                 f"vectordb-wiki__{s}.json").read_text())
        assert recs[m, s]["input_bytes_per_device"] == b
    for s in ("search_b128", "search_b1", "encode_4m"):      # one trace
        a, b = recs["single_16x16", s], recs["multi_2x16x16", s]
        assert (a["flops_per_device"], a["bytes_per_device"]) == (
            b["flops_per_device"], b["bytes_per_device"])
    enc = recs["single_16x16", "encode_4m"]
    assert enc["kernels"] == {"bucketize": 1}
    assert enc["memory_analysis"] == {
        "argument_size_in_bytes": 6_690_406_400,
        "output_size_in_bytes": 1_672_601_600,
        "temp_size_in_bytes": None, "generated_code_size_in_bytes": None}
    # a rerun reads the records back
    path = pathlib.Path(out) / "single_16x16" / "vectordb-wiki__search_b1.json"
    rec = json.loads(path.read_text())
    rec["note"] = "kept"
    path.write_text(json.dumps(rec))
    dryrun.main(argv)
    assert json.loads(path.read_text())["note"] == "kept"
