"""repro_torch's recsys models against the JAX package's, on the CPU.

The same seeded batches (``recsys_batch``, byte-equal in both packages)
go through ``repro.models.recsys`` and ``repro_torch.models.recsys`` at
each model's smoke config; parameters are drawn by the port and carried
across by ``repro_torch.interop`` (``recsys_params_to_numpy``), so both
packages run one model.  Both compute in float32, so the bounds hold
closeness to float32 rounding, not bits; each is set above what these
inputs measure (the measured value beside it):

* logits and ``user_embedding``: max |diff| <= FWD_TOL * max |ref|;
* ``bce_loss`` relative <= LOSS_TOL;
* gradients: global norm within GRAD_NORM_TOL relative, cosine >= GRAD_COS;
* one AdamW step of ``make_train_step``: every weight within STEP_TOL x lr
  of the reference's, and within STEP_TIGHT_TOL x lr where the clipped
  gradient is at least STEP_G_FLOOR; 5 steps' losses within LOSS_STEPS_TOL relative, step by step;
* ``embedding_bag`` (sum and mean) and ``embedding_bag_segment`` (with
  and without weights), pads included, within BAG_TOL.

Then the port's own ``tests/test_archs.py::test_recsys_smoke`` checks,
``recsys_batch`` byte-equal, ``interop``'s refusal of a tree of other
shapes, and checkpoints read both ways.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import recsys_batch as jax_recsys_batch
from repro.models.recsys import embedding as jemb
from repro.models.recsys.models import bce_loss as jbce
from repro.train import checkpoint as jckpt
from repro.train import grad as jgrad
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import recsys_batch
from repro_torch.models.recsys import embedding as temb
from repro_torch.models.recsys.models import bce_loss
from repro_torch.train import (AdamWConfig, AdamWState, adamw_init,
                               make_train_step, restore_checkpoint,
                               save_checkpoint)
from repro_torch.train.tree import tree_leaves, tree_map

RS_IDS = ["xdeepfm", "autoint", "din", "bst"]
FWD_TOL = 2e-6          # measured <= 3.4e-7
LOSS_TOL = 1e-6         # measured <= 1.8e-7
GRAD_NORM_TOL = 1e-6    # measured <= 1.2e-7
GRAD_COS = 0.99999      # measured >= 0.99999994
STEP_TOL = 2e-3         # x lr, every weight; measured <= 3.5e-4: AdamW's first
                        # step moves a weight by about lr * sign(g), so where
                        # a clipped gradient is near AdamW's eps (1e-8) its
                        # float32 rounding moves the step
STEP_G_FLOOR = 1e-6     # clipped |g| >= 100 x eps: there the step moves by
                        # under 1% of g's relative error, so
STEP_TIGHT_TOL = 5e-5   # x lr bounds it (measured <= 6.0e-6: an ulp of the
                        # weight; a dropped weight-decay term is 0.1 x |w|)
LOSS_STEPS_TOL = 2e-5   # measured <= 3.0e-6 over 5 steps
LR = 1e-2
BAG_TOL = 1e-6          # measured: passes at 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_batch(arch, seed, batch=16):
    cfg = arch.smoke_cfg
    rng = np.random.default_rng(seed)
    if arch.seq:
        return recsys_batch(rng, batch, 1, [cfg.item_vocab], seq_len=cfg.seq_len)
    return recsys_batch(rng, batch, cfg.n_sparse, cfg.vocab_sizes)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _carried(arch, seed=0):
    """A seeded port model on the CPU and the same weights as the JAX
    package's tree (drawn by the port: JAX's eager init costs seconds a
    model here)."""
    model = arch.init_fn(arch.smoke_cfg, device="cpu", seed=seed)
    return model, jax.tree.map(jnp.asarray, interop.recsys_params_to_numpy(model))


@pytest.fixture(scope="module", params=RS_IDS)
def pair(request):
    """(arch id, port arch, JAX params, port model, numpy batch, the JAX
    package's results on them)."""
    jarch, arch = jax_arch(request.param), get_arch(request.param)
    jcfg = jarch.smoke_cfg
    model, params = _carried(arch)
    batch = _np_batch(arch, 3)

    def reference(params, jb):
        loss, grads = jax.value_and_grad(
            lambda p: jbce(jarch.forward_fn, p, jb, jcfg))(params)
        return dict(logits=jarch.forward_fn(params, jb, jcfg), loss=loss,
                    grads=grads, user=jarch.user_fn(params, jb, jcfg))

    want = jax.jit(reference)(params, _j(batch))
    return request.param, arch, params, model, batch, want


def test_forward_loss_grads_user_parity(pair):
    _, arch, _, model, batch, want = pair
    cfg = arch.smoke_cfg
    tb = _t(batch)
    logits = arch.forward_fn(model, tb, cfg)
    assert logits.shape == (16,) and logits.dtype == torch.float32
    assert _rel(logits, want["logits"]) <= FWD_TOL
    user = arch.user_fn(model, tb, cfg)
    assert user.shape == (16, cfg.embed_dim)
    assert _rel(user, want["user"]) <= FWD_TOL
    loss = bce_loss(arch.forward_fn, model, tb, cfg)
    w = float(want["loss"])
    assert abs(float(loss.detach()) - w) / abs(w) <= LOSS_TOL
    loss.backward()
    got = np.concatenate([g.numpy().ravel()
                          for g in tree_leaves(model.tree(grads=True))])
    ref = np.concatenate([np.asarray(g).ravel()
                          for g in jax.tree.leaves(want["grads"])])
    assert got.shape == ref.shape
    na, nb = np.linalg.norm(ref), np.linalg.norm(got)
    assert abs(na - nb) / na <= GRAD_NORM_TOL
    assert got @ ref / (na * nb) >= GRAD_COS
    model.zero_grad(set_to_none=True)


def test_recsys_smoke(pair):
    """``tests/test_archs.py::test_recsys_smoke`` on the port: logits of
    shape (16,) without NaN, every gradient finite, the user tower's
    (16, embed_dim)."""
    _, arch, _, model, batch, _ = pair
    cfg = arch.smoke_cfg
    tb = _t(batch)
    logits = arch.forward_fn(model, tb, cfg)
    assert logits.shape == (16,) and not torch.isnan(logits).any()
    bce_loss(arch.forward_fn, model, tb, cfg).backward()
    assert all(bool(torch.isfinite(g).all())
               for g in tree_leaves(model.tree(grads=True)))
    model.zero_grad(set_to_none=True)
    assert arch.user_fn(model, tb, cfg).shape == (16, cfg.embed_dim)


def _check_first_step(model, params, jo):
    """Every weight within STEP_TOL x lr of the reference's after one
    AdamW step, and within STEP_TIGHT_TOL x lr where the clipped gradient
    (the reference's first moment over 1 - b1) is at least STEP_G_FLOOR."""
    b1 = jopt.AdamWConfig().b1
    for a, b, mu in zip(tree_leaves(model.tree()), jax.tree.leaves(params),
                        jax.tree.leaves(jo.mu)):
        d = np.abs(a.numpy() - np.asarray(b))
        assert d.max() <= STEP_TOL * LR
        far = np.abs(np.asarray(mu)) / (1 - b1) >= STEP_G_FLOOR
        assert d[far].max(initial=0.0) <= STEP_TIGHT_TOL * LR


def test_adamw_step_and_five_losses(pair):
    """One AdamW step of each package's ``make_train_step`` from the same
    params and batch, then four more: losses step by step."""
    arch_id, arch, params, _, _, _ = pair
    jarch, cfg = jax_arch(arch_id), arch.smoke_cfg
    model = interop.recsys_params_from_numpy(jax.tree.map(np.asarray, params),
                                             cfg, device="cpu")      # a fresh copy
    jstep = jax.jit(jgrad.make_train_step(
        lambda p, b: jbce(jarch.forward_fn, p, b, jarch.smoke_cfg),
        jopt.AdamWConfig(lr=LR)))
    tstep = make_train_step(lambda m, b: bce_loss(arch.forward_fn, m, b, cfg),
                            AdamWConfig(lr=LR))
    jo, to = jopt.adamw_init(params), adamw_init(model)
    for i in range(5):
        b = _np_batch(arch, 10 + i)
        params, jo, jm = jstep(params, jo, _j(b))
        model, to, tm = tstep(model, to, _t(b))
        w = float(jm["loss"])
        assert abs(float(tm["loss"]) - w) / abs(w) <= LOSS_STEPS_TOL, i
        if i == 0:
            _check_first_step(model, params, jo)
            assert _rel(tm["grad_norm"], jm["grad_norm"]) <= GRAD_NORM_TOL
    assert int(to.step) == 5


def test_recsys_batch_byte_equal():
    for seq_len, vocabs in ((0, [7, 100, 3, 1 << 20]), (12, [256])):
        for batch in (1, 33):
            want = jax_recsys_batch(np.random.default_rng(5), batch, len(vocabs),
                                    vocabs, seq_len=seq_len)
            got = recsys_batch(np.random.default_rng(5), batch, len(vocabs),
                               vocabs, seq_len=seq_len)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_parity(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(-1, 50, size=(9, 7)).astype(np.int32)
    ids[3] = -1                                 # an all-pad bag
    w = rng.random((9, 7)).astype(np.float32)
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(w), mode=mode)
    tt = torch.from_numpy(table).requires_grad_()
    got = temb.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(w),
                             mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=BAG_TOL, atol=BAG_TOL)
    assert float(got[3].detach().abs().max()) == 0.0
    g = rng.normal(size=got.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda t: (jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(w),
                                                mode=mode) * g).sum())(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=BAG_TOL,
                               atol=BAG_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_segment_parity(weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(40, 5)).astype(np.float32)
    flat = rng.integers(-1, 40, size=60).astype(np.int32)
    seg = rng.integers(0, 9, size=60).astype(np.int32)
    seg[seg == 4] = 5                           # bag 4 empty
    w = rng.random(60).astype(np.float32) if weighted else None
    want = jemb.embedding_bag_segment(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 9,
        None if w is None else jnp.asarray(w))
    tt = torch.from_numpy(table).requires_grad_()
    got = temb.embedding_bag_segment(tt, torch.from_numpy(flat), torch.from_numpy(seg),
                                     9, None if w is None else torch.from_numpy(w))
    assert got.shape == (9, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=BAG_TOL, atol=BAG_TOL)
    assert float(got[4].detach().abs().max()) == 0.0
    got.sum().backward()
    jg = jax.grad(lambda t: jemb.embedding_bag_segment(
        t, jnp.asarray(flat), jnp.asarray(seg), 9,
        None if w is None else jnp.asarray(w)).sum())(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=BAG_TOL,
                               atol=BAG_TOL)
    # bags outside [0, n_bags) add nothing: the reference drops them
    seg2 = seg.copy()
    seg2[:5] = 9
    want2 = jemb.embedding_bag_segment(jnp.asarray(table), jnp.asarray(flat),
                                       jnp.asarray(seg2), 9)
    got2 = temb.embedding_bag_segment(torch.from_numpy(table), torch.from_numpy(flat),
                                      torch.from_numpy(seg2), 9)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=BAG_TOL,
                               atol=BAG_TOL)


def test_field_lookup_and_offsets():
    vocabs = [3, 5, 2]
    np.testing.assert_array_equal(temb.field_offsets(vocabs),
                                  jemb.field_offsets(vocabs))
    table = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    ids = np.array([[0, 4, 1], [2, 0, 0]], np.int32)
    offs = temb.field_offsets(vocabs)
    want = jemb.field_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(offs))
    got = temb.field_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lin = torch.arange(10, dtype=torch.float32)          # a 1-D table
    np.testing.assert_array_equal(
        temb.field_lookup(lin, torch.from_numpy(ids), torch.from_numpy(offs)).numpy(),
        np.asarray(jnp.take(jnp.arange(10.0), jnp.asarray(ids + offs[None]), axis=0)))


def test_interop_refuses_other_shapes():
    params = jax.tree.map(np.asarray, _carried(get_arch("din"))[1])
    with pytest.raises(ValueError, match="din"):
        interop.recsys_params_from_numpy(params, get_arch("din").cfg, device="cpu")
    model = interop.recsys_params_from_numpy(params, get_arch("din").smoke_cfg,
                                             device="cpu")
    back = interop.recsys_params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch_id", ["xdeepfm", "bst"])
def test_checkpoints_cross_both_ways(arch_id):
    arch = get_arch(arch_id)
    model, params = _carried(arch, seed=2)
    jstate = {"params": params, "opt": jopt.adamw_init(params)}
    opt = adamw_init(model)
    opt = opt._replace(step=opt.step + 5, mu=tree_map(lambda m: m + 0.25, opt.mu),
                       nu=tree_map(lambda v: v + 0.5, opt.nu))
    tstate = {"params": model.tree(), "opt": opt}
    leaves = tree_leaves(tstate)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(np.shape(x)) for x in jax.tree.leaves(jstate)]
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d + "/port", 3, tstate)
        got, step = jckpt.restore_checkpoint(d + "/port", jstate)
        assert step == 3 and int(got["opt"].step) == 5
        for a, b in zip(jax.tree.leaves(got), leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jckpt.save_checkpoint(d + "/jax", 4, got)
        back, step = restore_checkpoint(d + "/jax", tstate)
        assert step == 4 and isinstance(back["opt"], AdamWState)
        for a, b in zip(tree_leaves(back), leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)
    st = interop.recsys_params_from_numpy(jax.tree.map(np.asarray, got["opt"]),
                                          arch_id, device="cpu")
    assert isinstance(st, AdamWState) and int(st.step) == 5
