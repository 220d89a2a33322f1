"""repro_torch's MoE layers and the two MoE LMs against the JAX package's,
on the CPU.

Parameters are drawn by JAX and carried across (``interop`` for the
LMs), inputs come from numpy seeds.  Routing is discontinuous: where a
token's k-th and (k+1)-th probabilities lie within rounding of each
other the two packages may pick different experts.  So:

* ``moe_ffn`` / ``_moe_ffn_chunk`` / ``moe_ffn_local`` on the same
  inputs: every input here has top-k gaps above ``GAP`` (checked), and
  the choices and the kept (token, choice) slots equal the reference's
  exactly (its plan, ``_ref_plan``, is moe.py's own lines); y, aux and
  the gradients with respect to x and every leaf within the bounds
  below;
* the smoke LMs: hidden states differ by bf16 rounding before each MoE
  layer, so the port is run on the reference's routing (recorded from
  the JAX forward by a debug callback, forced through ``moe.route``) for
  the value checks, and the routing it picks on its own is counted
  against the reference's: a token may differ only where its gap is
  under ``FLIP_GAP`` (the counts are printed).

Each bound stands beside its constant with the value measured here.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import common as jcommon
from repro.models.transformer import model as jlm
from repro.models.transformer import moe as jmoe
from repro.models.transformer import moe_local as jlocal
from repro.train import grad as jgrad
from repro.train import optimizer as jopt
from repro.train.checkpoint import restore_checkpoint as jrestore
from repro.train.checkpoint import save_checkpoint as jsave
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models.transformer import model as tlm
from repro_torch.models.transformer import moe as tmoe
from repro_torch.models.transformer.moe_local import moe_ffn_local
from repro_torch.train import (AdamWConfig, adafactor_init, adafactor_update,
                               adamw_init, adamw_update, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train.tree import tree_leaves, tree_map

GAP = 1e-5              # routing compared exactly above this top-k gap
Y_TOL = {"float32": 1e-6,   # y, of the largest |y|: measured 3.8e-7
         "bfloat16": 1e-2}  # measured 3.4e-3 (a bf16 ulp is 3.9e-3)
AUX_TOL = 1e-6          # aux, relative: measured 2.3e-7
GRAD_TOL = {"float32": 1e-4,    # each gradient, of its largest: 4.6e-5
            "bfloat16": 2e-2}   # measured 7.7e-3
# the smoke LMs, on the reference's routing
LOGITS_TOL = 3e-2       # of the largest logit: measured 1.95e-2 (llama4)
LM_AUX_TOL = 2e-4       # relative: measured 2.1e-5
LOSS_TOL = 1e-3         # relative: measured 2.0e-4
GRAD_NORM_TOL = 3e-3    # relative: measured 1.27e-3
GRAD_COS = 0.9995       # measured >= 0.99980 (llama4: bf16 noise)
STEP_TOL = 1e-6         # one optimizer step fed the same gradients: 1.9e-7
LOSS_STEPS_TOL = 1e-2   # 5 training steps' losses, relative: 2.7e-3
SERVE_TOL = 3e-2        # prefill, serve_step logits: measured 2.27e-2
FLIP_GAP = 2e-2         # a token the port routes apart must be this close
                        # (measured: 2 tokens of llama4-smoke's first MoE
                        # layer, gaps <= 1.6e-3; none in mixtral-smoke)

IDS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _setup(seed=0, d=16, f=32, e=4, shared=1, t=24):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e, n_shared=shared)
    x = np.random.default_rng(seed + 1).normal(size=(t, d)).astype(np.float32)
    return p, x


def _x(x, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(getattr(torch, dtype))


_jax_chunk = jax.jit(lambda p, x, top_k, cf: jmoe._moe_ffn_chunk(
    p, x, top_k, cf, "silu", annotate=False), static_argnums=(2, 3))
_jax_moe = jax.jit(lambda p, x, top_k, cf, chunk=32768: jmoe.moe_ffn(
    p, x, top_k, cf, token_chunk=chunk), static_argnums=(2, 3, 4))


def _ref_plan(p, x, top_k, cf):
    """The reference's routing and kept slots (moe.py's lines, in JAX):
    -> (probs, idx (T, k), slot of each (token, choice) pair, E*C where
    dropped)."""
    return tuple(np.asarray(a) for a in _ref_plan_jit(p, x, top_k, cf)) + (
        p["router"].shape[1] * max(1, math.ceil(x.shape[0] * top_k
                                                / p["router"].shape[1] * cf)),)


def _ref_plan_core(p, x, top_k, cf):
    T = x.shape[0]
    E = p["router"].shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, top_k)
    C = max(1, math.ceil(T * top_k / E * cf))
    e_flat = idx.reshape(-1)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    start = jnp.searchsorted(e_sorted, jnp.arange(E), side="left")
    rank = jnp.arange(T * top_k) - start[e_sorted]
    slot = jnp.where(rank < C, e_sorted * C + rank, E * C)
    pair_slot = jnp.zeros_like(slot).at[order].set(slot)
    return probs, idx, pair_slot


_ref_plan_jit = jax.jit(_ref_plan_core, static_argnums=(2, 3))


def _port_plan(p, x, top_k, cf):
    T = x.shape[0]
    E = p["router"].shape[1]
    probs, idx, _ = tmoe.route(p, x, top_k)
    C = max(1, math.ceil(T * top_k / E * cf))
    _, _, pair_slot, kept = tmoe.dispatch_plan(idx, E, C)
    return idx.numpy(), torch.where(kept, pair_slot, E * C).numpy()


def _gaps(probs, k):
    s = -np.sort(-np.asarray(probs, np.float32), -1)
    return s[:, k - 1] - s[:, k]


def _hold_routing(p, tp, x, tx, top_k, cf):
    probs, idx, slot, _ = _ref_plan(p, x, top_k, cf)
    assert _gaps(probs, top_k).min() > GAP
    got_idx, got_slot = _port_plan(tp, tx, top_k, cf)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_slot, slot)
    return slot


# --------------------------------------------- the reference's test_moe.py
def test_chunked_matches_unchunked():
    p, x = _setup()
    tp, tx = _torch(p), torch.from_numpy(x)
    y1, a1 = tmoe.moe_ffn(tp, tx, top_k=2, capacity_factor=8.0, token_chunk=10**9)
    y2, a2 = tmoe.moe_ffn(tp, tx, top_k=2, capacity_factor=8.0, token_chunk=8)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)
    for chunk, y, a in ((10**9, y1, a1), (8, y2, a2)):
        jy, ja = _jax_moe(p, jnp.asarray(x), 2, 8.0, chunk)
        assert _rel(y, jy) <= Y_TOL["float32"]
        assert abs(float(a) - float(ja)) <= AUX_TOL * abs(float(ja))


def test_local_fallback_matches_global():
    """groups=1 is the reference's no-mesh fallback: _moe_ffn_chunk, bit
    for bit, and the reference's moe_ffn_local without a mesh."""
    p, x = _setup()
    tp, tx = _torch(p), torch.from_numpy(x)
    y1, a1 = tmoe._moe_ffn_chunk(tp, tx, 2, 8.0, "silu")
    y2, a2 = moe_ffn_local(tp, tx, 2, capacity_factor=8.0)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    jy, ja = jlocal.moe_ffn_local(p, jnp.asarray(x), 2, capacity_factor=8.0)
    assert _rel(y2, jy) <= Y_TOL["float32"]
    assert abs(float(a2) - float(ja)) <= AUX_TOL * abs(float(ja))


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_local_groups_are_the_references_shards(cf):
    """The reference's test_local_dispatch_under_mesh_matches_global runs
    moe_ffn_local under an 8-device mesh (4 data shards), which this JAX
    cannot (``jnp.repeat`` under the mesh raises).  Its shards' work,
    composed from the reference's own _moe_ffn_chunk: 4 contiguous row
    blocks, params and block in f32, each its own capacity, y cast back,
    aux meaned.  At cf 1.0 the groups drop what the global dispatch
    keeps."""
    p, x = _setup(t=32)
    tp = _torch(p)
    jx, tx = _x(x, "bfloat16")
    y, aux = moe_ffn_local(tp, tx, 2, capacity_factor=cf, groups=4)
    pf = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    ys, auxes = [], []
    for b in range(4):
        xb = jx[8 * b:8 * (b + 1)].astype(jnp.float32)
        yb, ab = _jax_chunk(pf, xb, 2, cf)
        ys.append(yb.astype(jx.dtype))
        auxes.append(ab)
        _hold_routing(pf, _torch(pf), xb, tx[8 * b:8 * (b + 1)].float(), 2, cf)
    assert y.dtype == torch.bfloat16
    assert _rel(y, jnp.concatenate(ys)) <= Y_TOL["bfloat16"]
    want = float(jnp.stack(auxes).mean())
    assert abs(float(aux) - want) <= AUX_TOL * abs(want)
    kept_groups = sum(int((_ref_plan(pf, jx[8 * b:8 * (b + 1)].astype(jnp.float32),
                                     2, cf)[2] < 4 * math.ceil(8 * 2 / 4 * cf)).sum())
                      for b in range(4))
    kept_global = int((_ref_plan(pf, jx.astype(jnp.float32), 2, cf)[2]
                       < 4 * math.ceil(32 * 2 / 4 * cf)).sum())
    assert (kept_groups == kept_global == 64) if cf == 8.0 else (
        kept_groups < kept_global)


def test_capacity_drops_are_bounded():
    """With cf=1.0 at most C pairs an expert keep slots; outputs stay
    finite; the kept slots are the reference's."""
    p, x = _setup()
    tp, tx = _torch(p), torch.from_numpy(x)
    y, aux = tmoe.moe_ffn(tp, tx, top_k=2, capacity_factor=1.0)
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    slot = _hold_routing(p, tp, jnp.asarray(x), tx, 2, 1.0)
    C = math.ceil(24 * 2 / 4 * 1.0)
    kept = slot[slot < 4 * C]
    assert len(kept) < 48 and len(set(kept.tolist())) == len(kept)
    assert np.bincount(kept // C, minlength=4).max() <= C


def test_aux_loss_balanced_vs_collapsed():
    """The Switch aux loss must penalise router collapse."""
    p = jmoe.moe_init(jax.random.PRNGKey(0), 8, 16, 4)
    x = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    tp, tx = _torch(p), torch.from_numpy(x)
    _, aux_balanced = tmoe.moe_ffn(tp, tx, top_k=1)
    collapsed = dict(tp, router=tp["router"] + torch.tensor([[100.0, 0, 0, 0]] * 8))
    _, aux_collapsed = tmoe.moe_ffn(collapsed, tx, top_k=1)
    assert float(aux_collapsed) > float(aux_balanced)
    jc = dict(p, router=p["router"] + jnp.asarray([[100.0, 0, 0, 0]] * 8))
    for got, pp in ((aux_balanced, p), (aux_collapsed, jc)):
        want = float(_jax_moe(pp, jnp.asarray(x), 1, 1.25)[1])
        assert abs(float(got) - want) <= AUX_TOL * want


# ------------------------------------------- moe_ffn against the reference
@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_parity(top_k, shared, dtype, cf):
    """y, aux, the choices and kept slots (exactly), and the gradients of
    sum(y * w) + 3 aux with respect to x and every leaf (autograd against
    jax.grad)."""
    p, x = _setup(seed=top_k + 2 * shared, shared=shared)
    jx, tx = _x(x, dtype)
    tp = _torch(p)
    w = np.random.default_rng(7).normal(size=(24, 16)).astype(np.float32)

    def reference(p, x):
        def loss(p, x):
            y, a = jmoe.moe_ffn(p, x, top_k, cf)
            return jnp.sum(y.astype(jnp.float32) * w) + 3 * a, (y, a)

        (_, (y, a)), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
        return y, a, g, _ref_plan_core(p, x, top_k, cf)

    jy, ja, (jgp, jgx), (probs, idx, slot) = jax.jit(reference)(p, jx)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx.requires_grad_(True)
    y, a = tmoe.moe_ffn(tp, tx, top_k, cf)
    assert y.dtype == tx.dtype and a.dtype == torch.float32
    ((y.float() * torch.from_numpy(w)).sum() + 3 * a).backward()
    assert _rel(y, jy) <= Y_TOL[dtype]
    assert abs(float(a.detach()) - float(ja)) <= AUX_TOL * abs(float(ja))
    assert _gaps(probs, top_k).min() > GAP
    got_idx, got_slot = _port_plan(tp, tx.detach(), top_k, cf)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_slot, slot)
    assert tx.grad.dtype == tx.dtype
    assert _rel(tx.grad, jgx) <= GRAD_TOL[dtype]
    for got, want in zip(leaves, jax.tree.leaves(jgp)):
        assert got.grad.shape == want.shape
        assert _rel(got.grad, want) <= GRAD_TOL[dtype]


def test_tie_order():
    """Two equal router columns: every tie goes to the lower expert (as
    jax.lax.top_k), and tokens of one expert keep slots in (token, choice)
    order, dropping as the reference's do."""
    p, x = _setup(shared=0, t=32)
    router = np.array(p["router"])
    router[:, 1] = router[:, 0]
    p = dict(p, router=jnp.asarray(router))
    tp, tx = _torch(p), torch.from_numpy(x)
    for top_k, cf in ((1, 1.0), (2, 1.0), (2, 0.5)):
        probs, idx, slot, _ = _ref_plan(p, jnp.asarray(x), top_k, cf)
        got_idx, got_slot = _port_plan(tp, tx, top_k, cf)
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_array_equal(got_slot, slot)
        tied = np.isclose(probs[:, 0], probs[:, 1], rtol=0, atol=0)
        assert tied.all()
        assert not (got_idx[:, 0] == 1).any()     # 1 never beats its twin 0
        if top_k == 2:
            both = (got_idx[:, 0] == 0)
            assert (got_idx[both, 1] == 1).all()  # then 1 as the second
        assert (slot == 4 * max(1, math.ceil(32 * top_k / 4 * cf))).any()
        y, _ = tmoe.moe_ffn(tp, tx, top_k, cf)
        jy, _ = _jax_moe(p, jnp.asarray(x), top_k, cf)
        assert _rel(y, jy) <= Y_TOL["float32"]


# ----------------------------------------------------------- the smoke LMs
@contextlib.contextmanager
def _port_routes(model, force=None):
    """The port's own routing by MoE layer (first call each), with
    ``force`` ({layer: choices}) replacing it: each layer then sees the
    reference's routing upstream, so its own choices may part from the
    reference's only at near ties."""
    layer = {id(l.moe["router"]): i for i, l in enumerate(model.layers) if l.kind.moe}
    seen = {}
    real = tmoe.route

    def route(p, x, top_k):
        probs, idx, gates = real(p, x, top_k)
        i = layer[id(p["router"])]
        seen.setdefault(i, (probs.detach(), idx))
        if force is not None:
            idx = force[i]
            gates = tmoe.gate_values(probs, idx)
        return probs, idx, gates

    tmoe.route = route
    try:
        yield seen
    finally:
        tmoe.route = real


@contextlib.contextmanager
def _jax_routes(monkeypatch):
    """The reference's choices, by MoE call in layer order, recorded from
    its jitted programs by an ordered debug callback."""
    rec = []
    real = jlm.moe_ffn

    def moe_ffn(p, x, top_k, capacity_factor=1.25, act="silu", token_chunk=32768):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, top_k)
        jax.debug.callback(lambda i: rec.append(np.asarray(i)), idx, ordered=True)
        return real(p, x, top_k, capacity_factor, act, token_chunk=token_chunk)

    monkeypatch.setattr(jlm, "moe_ffn", moe_ffn)
    yield rec


def _by_layer(model, rec):
    moe_layers = [i for i, l in enumerate(model.layers) if l.kind.moe]
    assert len(rec) == len(moe_layers), (len(rec), moe_layers)
    return {i: torch.from_numpy(r.astype(np.int64)) for i, r in zip(moe_layers, rec)}


def _flips(got, want, k) -> list:
    """(layer, tokens routed apart, their largest gap in the port)."""
    out = []
    for i, w in want.items():
        probs, idx = got[i]
        diff = (idx != w).any(-1).numpy()
        gaps = _gaps(probs.numpy(), k)[diff]
        out.append((i, int(diff.sum()), float(gaps.max()) if diff.any() else 0.0))
    return out


def _n_moe(cfg) -> int:
    return sum(k.moe for k in cfg.sub_kinds()) * cfg.n_super


def _lm_batch(seed, vocab):
    t = np.random.default_rng(seed).integers(0, vocab, size=(2, 32)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, 1)}


@pytest.fixture(scope="module", params=IDS)
def pair(request):
    """(arch id, JAX cfg, JAX params, port cfg, port model, batch, the
    reference's results and routing, its jitted gradient).  The
    reference's forward, lm_loss with its gradients, and prefill with
    serve_step (at capacity 8.0, the reference's decode test's) record
    the choices of each MoE call in order (the gradient's: forward, then
    recompute)."""
    arch_id = request.param
    jcfg, tcfg = jax_arch(arch_id).smoke(), get_arch(arch_id).smoke()
    jcfg8 = dataclasses.replace(jcfg, capacity_factor=8.0)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_numpy(_np(params), tcfg, device="cpu")
    batch = _lm_batch(3, jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    n = _n_moe(jcfg)

    def loss(p, b):         # model.py's lm_loss, keeping its logits and aux
        logits, aux, _ = jlm.forward(p, b["tokens"], jcfg)
        mask = jnp.ones_like(b["labels"], jnp.float32).at[:, -1].set(0.0)
        return jcommon.softmax_xent(logits, b["labels"], mask) + 0.01 * aux, (logits, aux)

    grad = jax.value_and_grad(loss, has_aux=True)

    def reference(p, b):
        (l, (logits, aux)), g = grad(p, b)
        plog, cache = jlm.prefill(p, b["tokens"], jcfg8, max_seq=32)
        slog, _ = jlm.serve_step(p, cache, b["tokens"][:, -1:], jnp.int32(31), jcfg8)
        return dict(loss=l, logits=logits, aux=aux, grads=g, prefill=plog,
                    pos={k: c["pos"] for k, c in cache.items()}, serve=slog)

    run = jax.jit(reference)
    with pytest.MonkeyPatch.context() as mp, _jax_routes(mp) as rec:
        want = run(params, jb)     # the trace holds the callback into rec
        jax.effects_barrier()
    assert len(rec) == 4 * n, len(rec)
    want["routes"] = {"forward": _by_layer(model, rec[:n]),
                      "prefill": _by_layer(model, rec[2 * n:3 * n]),
                      "serve": _by_layer(model, rec[3 * n:])}
    return arch_id, jcfg, params, tcfg, model, batch, want, (run, rec)


def test_lm_forward_loss_grads_parity(pair):
    """Logits, aux, lm_loss and gradients on the reference's routing, and
    one step of the arch's optimizer fed the reference's gradients; the
    port's own choices apart from the reference's only at near ties."""
    arch_id, jcfg, params, tcfg, model, batch, want, _ = pair
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    routes = want["routes"]["forward"]
    with _port_routes(model, force=routes) as own:
        with torch.no_grad():
            logits, aux, _ = tlm.forward(model, tb["tokens"])
        loss = tlm.lm_loss(model, tb)
        loss.backward()
    flips = _flips(own, routes, tcfg.moe_top_k)
    print(f"{arch_id}: tokens the port routes apart, by layer {flips}")
    assert all(n == 0 or gap < FLIP_GAP for _, n, gap in flips)
    assert _rel(logits, want["logits"]) <= LOGITS_TOL
    assert abs(float(aux) - float(want["aux"])) <= LM_AUX_TOL * abs(float(want["aux"]))
    assert abs(float(loss.detach()) - float(want["loss"])) <= LOSS_TOL * float(want["loss"])
    got = np.concatenate([_f32(g).ravel() for g in tree_leaves(model.tree(grads=True))])
    ref = np.concatenate([_f32(g).ravel() for g in jax.tree.leaves(want["grads"])])
    model.zero_grad(set_to_none=True)
    na, nb = np.linalg.norm(ref), np.linalg.norm(got)
    assert abs(na - nb) / na <= GRAD_NORM_TOL
    assert got @ ref / (na * nb) >= GRAD_COS
    arch = get_arch(arch_id)
    jinit, jupd = {"adamw": (jopt.adamw_init, jopt.adamw_update),
                   "adafactor": (jopt.adafactor_init, jopt.adafactor_update)}[arch.optimizer]
    tinit, tupd = {"adamw": (adamw_init, adamw_update),
                   "adafactor": (adafactor_init, adafactor_update)}[arch.optimizer]
    jp, _ = jax.jit(lambda g, p: jupd(g, jinit(p), p, jopt.AdamWConfig(), 0.5))(
        want["grads"], params)
    tree = model.tree()
    tp, _ = tupd(tree_map(lambda g: torch.from_numpy(np.array(g)), _np(want["grads"])),
                 tinit(tree), tree, AdamWConfig(), 0.5)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert _rel(a, b) <= STEP_TOL


def test_lm_prefill_serve_step_parity(pair):
    """prefill and serve_step on the reference's routing; decode against
    forward in the port (the reference's test at capacity 8.0, < 0.05)."""
    arch_id, jcfg, params, tcfg, model, batch, want, _ = pair
    m8 = tlm.LM(dataclasses.replace(tcfg, capacity_factor=8.0),
                device="cpu").load_tree(model.tree())
    tt = torch.from_numpy(batch["tokens"])
    with _port_routes(m8, force=want["routes"]["prefill"]):
        pl, cache = tlm.prefill(m8, tt, 32)
    assert _rel(pl, want["prefill"]) <= SERVE_TOL
    for sub, pos in want["pos"].items():
        np.testing.assert_array_equal(cache[sub]["pos"].numpy(), np.asarray(pos))
    with _port_routes(m8, force=want["routes"]["serve"]):
        sl, _ = tlm.serve_step(m8, cache, tt[:, -1:], 31)
    assert _rel(sl, want["serve"]) <= SERVE_TOL
    with torch.no_grad():
        logits, _, _ = tlm.forward(m8, tt)
    _, cache = tlm.prefill(m8, tt, 32)
    step, _ = tlm.serve_step(m8, cache, tt[:, -1:], 31)
    ref = logits[:, 31].float()
    assert float((step[:, 0].float() - ref).abs().max() / (ref.abs().max() + 1e-9)) < 0.05


def test_lm_train_steps_parity(pair):
    """5 steps of make_train_step with the arch's optimizer against the
    reference's step at accum 1 (its gradient of lm_loss, then its
    update), the port on the reference's routing of each step: the
    losses."""
    arch_id, jcfg, params, tcfg, model, _, _, (run, rec) = pair
    arch = get_arch(arch_id)
    jinit, jupd = {"adamw": (jopt.adamw_init, jopt.adamw_update),
                   "adafactor": (jopt.adafactor_init, jopt.adafactor_update)}[arch.optimizer]
    tinit = {"adamw": adamw_init, "adafactor": adafactor_init}[arch.optimizer]
    cfg = jopt.AdamWConfig(lr=1e-2)
    jupd = jax.jit(lambda g, o, p, f=jupd: f(g, o, p, cfg))
    tstep = make_train_step(lambda m, b: tlm.lm_loss(m, b), AdamWConfig(lr=1e-2),
                            optimizer=arch.optimizer)
    m = tlm.LM(tcfg, device="cpu").load_tree(model.tree())
    jp, jo, to = params, jinit(params), tinit(m)
    n = _n_moe(jcfg)
    losses = []
    for i in range(5):
        b = _lm_batch(20 + i, jcfg.vocab)
        rec.clear()
        got = run(jp, {k: jnp.asarray(v) for k, v in b.items()})
        jax.effects_barrier()
        jp, jo = jupd(got["grads"], jo, jp)
        with _port_routes(m, force=_by_layer(m, rec[:n])):
            m, to, tm = tstep(m, to, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append((float(tm["loss"]), float(got["loss"])))
    for got, want in losses:
        assert abs(got - want) <= LOSS_STEPS_TOL * want, losses


# ------------------------------------------------- trees, counts, training
@pytest.mark.parametrize("arch_id,param_dtype", [
    ("mixtral-8x22b", "float32"), ("llama4-maverick-400b-a17b", "float32"),
    ("llama4-maverick-400b-a17b", "bfloat16")])
def test_trees_and_checkpoints_cross_both_ways(tmp_path, arch_id, param_dtype):
    """MoE parameter trees and optimizer states through interop, and
    checkpoints written by either package restored by the other, leaf
    for leaf."""
    jcfg = dataclasses.replace(jax_arch(arch_id).smoke(), param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_arch(arch_id).smoke(), param_dtype=param_dtype)
    arch = get_arch(arch_id)
    params = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    model = interop.lm_params_from_numpy(_np(params), tcfg, device="cpu")
    assert next(model.parameters()).dtype == getattr(torch, param_dtype)
    back = interop.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(_np(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    jinit = {"adamw": jopt.adamw_init, "adafactor": jopt.adafactor_init}[arch.optimizer]
    tinit = {"adamw": adamw_init, "adafactor": adafactor_init}[arch.optimizer]
    jstate = jinit(params)
    tstate = interop.lm_params_from_numpy(_np(jstate), tcfg, device="cpu")
    assert type(tstate).__name__ == type(jstate).__name__
    for a, b in zip(tree_leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_f32(a), np.asarray(b, np.float32))
    # the reference writes, the port restores
    jsave(str(tmp_path / "j"), 3, {"params": params, "opt": jstate})
    like = {"params": model.tree(), "opt": tinit(model)}
    got, step = restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 3
    for a, b in zip(tree_leaves(got), jax.tree.leaves({"params": params, "opt": jstate})):
        assert str(a.dtype) == "torch." + str(np.asarray(b).dtype)
        np.testing.assert_array_equal(_f32(a), np.asarray(b, np.float32))
    # the port writes, the reference restores
    save_checkpoint(str(tmp_path / "t"), 5, {"params": model.tree(), "opt": tstate})
    out, step = jrestore(str(tmp_path / "t"), {"params": params, "opt": jstate})
    assert step == 5
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves({"params": params, "opt": jstate})):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("arch_id", IDS)
def test_module_holds_the_counted_parameters(arch_id):
    """The reference's param_count leaves out ln_f only (no QKV biases
    here); the full configs' counts, as the JAX package's give them."""
    cfg = get_arch(arch_id).smoke()
    model = tlm.LM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + cfg.d_model
    full = get_arch(arch_id).cfg
    assert full.param_count() == jax_arch(arch_id).cfg.param_count() == {
        "mixtral-8x22b": 140_630_065_152,
        "llama4-maverick-400b-a17b": 397_691_944_960}[arch_id]


def test_bf16_params_sum_gradients_in_f32_and_donate_is_the_same():
    """With bf16 parameters and accum 2 the microbatches' gradients are
    summed in f32 (the reference's accumulator): the step equals the
    arch's update applied to (g1.float() + g2.float()) / 2; a donated step
    gives the same bits and writes them into the given state."""
    cfg = dataclasses.replace(get_arch("llama4-maverick-400b-a17b").smoke(),
                              param_dtype="bfloat16")
    r = np.random.default_rng(9)
    t = r.integers(0, cfg.vocab, size=(4, 32))
    b = {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(np.roll(t, -1, 1))}
    loss = lambda m, mb: tlm.lm_loss(m, mb)
    m0 = tlm.init_params(cfg, device="cpu", seed=4)
    gs = []
    for i in range(2):
        loss(m0, {k: v[i::2] for k, v in b.items()}).backward()
        gs.append(tree_map(lambda g: g.float(), m0.tree(grads=True)))
        m0.zero_grad(set_to_none=True)
    grads = tree_map(lambda a, c: (a + c) / torch.tensor(2.0), *gs)
    tree = m0.tree()
    want, want_state = adafactor_update(grads, adafactor_init(tree), tree,
                                        AdamWConfig(lr=1e-2))
    runs = []
    for donate in (False, True):
        m = tlm.init_params(cfg, device="cpu", seed=4)
        o = adafactor_init(m)
        step = make_train_step(loss, AdamWConfig(lr=1e-2), accum=2,
                               optimizer="adafactor", donate=donate)
        m2, o2, _ = step(m, o, b)
        assert (tree_leaves(o2.vr)[0] is tree_leaves(o.vr)[0]) == donate
        runs.append(tree_leaves({"p": m2.tree(), "o": o2}))
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert all(torch.equal(x, y) for x, y in
               zip(runs[0], tree_leaves({"p": want, "o": want_state})))
