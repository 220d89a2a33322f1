"""repro_torch's training substrate, on the CPU: every case of
``tests/test_train.py`` but ``TestCompression`` (which waits with
``train/compression.py``) run on the port, and the port held to the JAX
package:

* one AdamW or Adafactor update fed the same f32 gradients: within
  UPDATE_TOL of each leaf's largest, and AdamW's moments bit-equal where
  the arithmetic is the same (no clipping, JAX's update run eagerly);
* 10 training steps from the same params and batches: losses within
  LOSS_STEPS_TOL relative, step by step, and the first step's gradient
  norm within GRAD_NORM_TOL;
* checkpoints cross both ways: JAX's ``restore_checkpoint`` reads the
  port's directory into its own tree with equal leaves, and the port reads
  JAX's; the leaf order is JAX's flatten order (43 leaves for the qwen2
  smoke config's params and AdamW state).

A model trains in place, so each run of the loop gets a fresh one (the
reference passes immutable arrays).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_arch as jax_arch
from repro.models.transformer import model as jlm
from repro.train import checkpoint as jckpt
from repro.train import grad as jgrad
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models.transformer.model import LMConfig, init_params, lm_loss
from repro_torch.train import (
    AdamWConfig,
    AsyncCheckpointer,
    TrainLoopConfig,
    adamw_init,
    cosine_schedule,
    latest_step,
    make_train_step,
    restore_checkpoint,
    run_train_loop,
    save_checkpoint,
)
from repro_torch.train.optimizer import (AdafactorState, AdamWState,
                                         adafactor_init, adafactor_update,
                                         adamw_update, global_norm)
from repro_torch.train.tree import tree_leaves, tree_map

CFG = LMConfig("tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
               d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
JCFG = jlm.LMConfig("tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                    d_head=16, d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
UPDATE_TOL = 1e-6       # measured <= 8.3e-7 (moments, through the clip
                        # scale's norm), params <= 1.3e-7; unclipped
                        # AdamW moments bit-equal
LOSS_STEPS_TOL = 1e-2   # measured <= 3.2e-3 over 10 steps (issue: 2e-2)
GRAD_NORM_TOL = 5e-3    # measured 2.1e-3 at step 0 (issue: 1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_batch(i, batch=8, seq=16):
    r = np.random.default_rng(i)
    t = r.integers(0, 64, size=(batch, seq)).astype(np.int32)
    t[:, 1::2] = t[:, ::2]  # deterministic intra-sequence structure
    return {"tokens": t, "labels": np.roll(t, -1, 1)}


def _mk_batch(i, batch=8, seq=16):
    return {k: torch.from_numpy(v) for k, v in _np_batch(i, batch, seq).items()}


def _loss(p, b):
    return lm_loss(p, b)


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


class TestOptimizers:
    def test_adamw_reduces_loss(self):
        params = init_params(CFG, device="cpu")
        opt = adamw_init(params)
        step = make_train_step(_loss, AdamWConfig(lr=1e-2))
        losses = []
        for i in range(60):
            params, opt, m = step(params, opt, _mk_batch(i))
            losses.append(float(m["loss"]))
        assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5

    def test_adafactor_reduces_loss(self):
        params = init_params(CFG, device="cpu")
        opt = adafactor_init(params)
        step = make_train_step(_loss, AdamWConfig(lr=3e-2), optimizer="adafactor")
        losses = []
        for i in range(60):
            params, opt, m = step(params, opt, _mk_batch(i))
            losses.append(float(m["loss"]))
        assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3

    def test_adafactor_state_is_factored(self):
        params = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,))}
        st = adafactor_init(params)
        assert st.vr["w"].shape == (64,)
        assert st.vc["w"].shape == (32,)
        assert st.v["b"].shape == (32,)

    def test_grad_clipping(self):
        params = {"w": torch.ones((4,))}
        opt = adamw_init(params)
        huge = {"w": torch.full((4,), 1e9)}
        new_p, _ = adamw_update(huge, opt, params, AdamWConfig(lr=1.0, clip_norm=1.0,
                                                               weight_decay=0.0))
        # clipped update magnitude bounded by lr
        assert float((new_p["w"] - params["w"]).abs().max()) < 1.1

    def test_cosine_schedule(self):
        sched = cosine_schedule(warmup=10, total=100)
        i32 = lambda n: torch.tensor(n, dtype=torch.int32)
        assert float(sched(i32(0))) == 0.0
        assert abs(float(sched(i32(10))) - 1.0) < 1e-6
        assert float(sched(i32(100))) <= 0.11


class TestAccumulation:
    def test_accum_matches_full_batch(self):
        """accum=4 must produce the same gradients as the full batch."""
        batch = _mk_batch(0, batch=8)
        m1 = init_params(CFG, device="cpu")
        m2 = init_params(CFG, device="cpu")
        opt = adamw_init(m1)
        p1, _, r1 = make_train_step(_loss, AdamWConfig())(m1, opt, batch)
        p2, _, r2 = make_train_step(_loss, AdamWConfig(), accum=4)(m2, opt, batch)
        assert_allclose(float(r1["loss"]), float(r2["loss"]), rtol=2e-3)
        assert _max_diff(p1.tree(), p2.tree()) < 2e-2  # bf16 accumulation noise

    def test_microbatches_are_the_references(self):
        """Microbatch i holds rows i, i + accum, ... (the reference's
        reshape-then-swap), so accum=4 sees what JAX's accum=4 sees."""
        from repro_torch.train.grad import _split_batch
        b = {"tokens": torch.arange(8)[:, None]}
        got = [mb["tokens"][:, 0].tolist() for mb in _split_batch(b, 4)]
        want = np.asarray(jgrad._split_batch({"tokens": jnp.arange(8)[:, None]},
                                             4)["tokens"])[..., 0].tolist()
        assert got == want == [[0, 4], [1, 5], [2, 6], [3, 7]]
        with pytest.raises(ValueError):
            _split_batch(b, 3)


class TestCheckpoint:
    def test_roundtrip(self):
        tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 7, tree)
            assert latest_step(d) == 7
            out, step = restore_checkpoint(d, tree_map(torch.zeros_like, tree))
            assert step == 7
            assert (out["a"].numpy() == np.arange(5.0)).all()
            assert out["b"]["c"].dtype == torch.bfloat16

    def test_incomplete_checkpoint_ignored(self):
        tree = {"a": torch.ones(3)}
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 1, tree)
            # simulate a crash mid-write: dir exists, no manifest
            os.makedirs(os.path.join(d, "step_00000002"))
            assert latest_step(d) == 1

    def test_async_checkpointer_gc(self):
        tree = {"a": torch.ones(3)}
        with tempfile.TemporaryDirectory() as d:
            ck = AsyncCheckpointer(d, keep=2)
            for s in [1, 2, 3, 4]:
                ck.save(s, tree)
            ck.wait()
            assert latest_step(d) == 4
            steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
            assert len(steps) == 2

    def test_resume_is_bit_exact(self):
        step = make_train_step(_loss, AdamWConfig(lr=1e-2))

        def fresh():
            p = init_params(CFG, device="cpu")
            return p, adamw_init(p)

        with tempfile.TemporaryDirectory() as d:
            pA, *_ = run_train_loop(step, *fresh(), _mk_batch,
                                    TrainLoopConfig(12, d + "/a", ckpt_every=12))
            run_train_loop(step, *fresh(), _mk_batch,
                           TrainLoopConfig(6, d + "/b", ckpt_every=6))
            pB, *_ = run_train_loop(step, *fresh(), _mk_batch,
                                    TrainLoopConfig(12, d + "/b", ckpt_every=6))
            assert _max_diff(pA.tree(), pB.tree()) == 0.0

    def test_straggler_hook_fires(self):
        import time
        params = init_params(CFG, device="cpu")
        opt = adamw_init(params)
        calls = []
        base = make_train_step(_loss, AdamWConfig())
        state = {"i": 0}

        def slow_step(p, o, b):
            state["i"] += 1
            if state["i"] == 15:
                time.sleep(1.0)
            return base(p, o, b)

        with tempfile.TemporaryDirectory() as d:
            run_train_loop(slow_step, params, opt, _mk_batch,
                           TrainLoopConfig(16, d, ckpt_every=100,
                                           straggler_factor=4.0),
                           on_straggler=lambda s, ratio: calls.append((s, ratio)))
        assert calls, "straggler detector never fired"


# ------------------------------------------------------ against the JAX package
@pytest.fixture(scope="module")
def jax_grads():
    """JAX's tiny-config params and gradients on one batch (numpy)."""
    params = jlm.init_params(jax.random.PRNGKey(0), JCFG)
    b = {k: jnp.asarray(v) for k, v in _np_batch(0).items()}
    grads = jax.jit(jax.grad(lambda p: jlm.lm_loss(p, b, JCFG)))(params)
    return params, grads


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rel_leaves(got, want) -> float:
    return max(float(np.abs(g.numpy() - np.asarray(w)).max()
                     / max(np.abs(np.asarray(w)).max(), 1e-30))
               for g, w in zip(tree_leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_update_parity_same_grads(jax_grads, optimizer, clip_norm):
    """One update of the reference's tree (stacked leaves: Adafactor
    factors and clips the same arrays) fed JAX's f32 gradients: the
    second step of a cosine schedule, from the state JAX's first update
    made."""
    params, grads = jax_grads
    np_params, np_grads = (jax.tree.map(np.asarray, t) for t in (params, grads))
    cfg = AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jcfg = jopt.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jinit, jupd = {"adamw": (jopt.adamw_init, jopt.adamw_update),
                   "adafactor": (jopt.adafactor_init, jopt.adafactor_update)}[optimizer]
    tinit, tupd = {"adamw": (adamw_init, adamw_update),
                   "adafactor": (adafactor_init, adafactor_update)}[optimizer]
    sched_j, sched_t = (jopt.cosine_schedule(2, 10), cosine_schedule(2, 10))
    if optimizer == "adafactor":      # 15 s eager; AdamW stays eager, as
        jupd = jax.jit(jupd, static_argnums=3)   # written, for its bits
    jp, js = jupd(grads, jinit(params), params, jcfg, 1.0)
    tp, ts = _to_torch(jax.tree.map(np.asarray, jp)), _to_torch(
        jax.tree.map(np.asarray, js))
    ts = (AdamWState if optimizer == "adamw" else AdafactorState)(*ts)
    g = _to_torch(np_grads)
    jp, js = jupd(grads, js, jp, jcfg, sched_j(js.step))
    tp, ts = tupd(g, ts, tp, cfg, sched_t(ts.step))
    assert int(ts.step) == int(js.step) == 2
    assert _rel_leaves(tp, jp) <= UPDATE_TOL
    for got, want in zip(ts[1:], js[1:]):
        if clip_norm > 1.0 and optimizer == "adamw":
            # no clip: mu and nu are the same f32 arithmetic, bit for bit
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert _rel_leaves(got, want) <= UPDATE_TOL
    gn = float(global_norm(g))
    assert abs(gn - float(jopt.global_norm(grads))) / gn <= 1e-6


def test_ten_step_loss_parity():
    """10 AdamW steps (accum 2, cosine schedule) from one seeded tree."""
    params = jlm.init_params(jax.random.PRNGKey(0), JCFG)
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), CFG,
                                         device="cpu")
    jstep = jax.jit(jgrad.make_train_step(
        lambda p, b: jlm.lm_loss(p, b, JCFG), jopt.AdamWConfig(lr=1e-2), accum=2,
        lr_schedule=jopt.cosine_schedule(2, 10)))
    tstep = make_train_step(_loss, AdamWConfig(lr=1e-2), accum=2,
                            lr_schedule=cosine_schedule(2, 10))
    jo, to = jopt.adamw_init(params), adamw_init(model)
    for i in range(10):
        b = _np_batch(i)
        params, jo, jm = jstep(params, jo, {k: jnp.asarray(v) for k, v in b.items()})
        model, to, tm = tstep(model, to, {k: torch.from_numpy(v) for k, v in b.items()})
        w = float(jm["loss"])
        assert abs(float(tm["loss"]) - w) / abs(w) <= LOSS_STEPS_TOL, i
        if i == 0:                       # the same params: the gradient bound
            w = float(jm["grad_norm"])
            assert abs(float(tm["grad_norm"]) - w) / w <= GRAD_NORM_TOL
        assert float(tm["lr_scale"]) == pytest.approx(float(jm["lr_scale"]), rel=1e-6)


def test_checkpoints_cross_both_ways():
    jcfg = jax_arch("qwen2-0.5b").smoke()
    cfg = get_arch("qwen2-0.5b").smoke()
    params = jlm.init_params(jax.random.PRNGKey(2), jcfg)
    jstate = {"params": params, "opt": jopt.adamw_init(params)}
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                         device="cpu")
    opt = adamw_init(model)
    opt = opt._replace(step=opt.step + 5,
                       mu=tree_map(lambda m: m + 0.25, opt.mu),
                       nu=tree_map(lambda v: v + 0.5, opt.nu))
    tstate = {"params": model.tree(), "opt": opt}
    leaves = tree_leaves(tstate)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert len(leaves) == len(paths) == 43
    assert paths[:2] == ["['opt'].step", "['opt'].mu['blocks']['sub0']['bk']"]
    assert [tuple(t.shape) for t in leaves] == [
        tuple(np.shape(x)) for x in jax.tree.leaves(jstate)]
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d + "/port", 3, tstate)
        got, step = jckpt.restore_checkpoint(d + "/port", jstate)
        assert step == 3
        for a, b in zip(jax.tree.leaves(got), leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert isinstance(got["opt"], jopt.AdamWState) and int(got["opt"].step) == 5
        # and back: JAX writes, the port reads into its own tree
        jckpt.save_checkpoint(d + "/jax", 4, got)
        back, step = restore_checkpoint(d + "/jax", tstate)
        assert step == 4 and isinstance(back["opt"], AdamWState)
        for a, b in zip(tree_leaves(back), leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)
        m2 = interop.lm_params_from_numpy(
            interop.lm_params_to_numpy(back["params"]), cfg, device="cpu")
        assert _max_diff(m2.tree(), model.tree()) == 0.0


def test_state_interop_covers_both_optimizers():
    jcfg = jax_arch("qwen2-0.5b").smoke()
    cfg = get_arch("qwen2-0.5b").smoke()
    params = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    for init in (jopt.adamw_init, jopt.adafactor_init):
        st = jax.tree.map(np.asarray, init(params))
        port = interop.lm_params_from_numpy(st, cfg, device="cpu")
        assert type(port).__name__ == type(st).__name__
        assert isinstance(port, (AdamWState, AdafactorState))
        assert port.step.dtype == torch.int32
        back = interop.lm_params_to_numpy(port)
        for a, b in zip(jax.tree.leaves(st), tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
