"""repro_torch's GIN and neighbour sampler against the JAX package's, on
the CPU.

* ``random_graph``, ``build_csr``, ``block_capacity`` and ``sample_block``
  give byte-identical arrays for one numpy seed;
* the neighbour sum (``_aggregate``, -1 pads included) within AGG_TOL of
  JAX's ``segment_sum``, and bit-equal across two runs;
* gin-tu in its three execution shapes -- one padded graph
  (``full_graph_sm``), B small graphs (``molecule``) and a sampled block
  (``minibatch_lg``), each cut to a few features and classes -- with
  params drawn by the port and carried across by ``interop``: logits within
  FWD_TOL of the largest, the loss within LOSS_TOL, gradients (global
  norm within GRAD_NORM_TOL, cosine >= GRAD_COS), one AdamW step of
  ``make_train_step`` (every weight within STEP_TOL x lr of the reference's,
  within STEP_TIGHT_TOL x lr where the clipped gradient is at least
  STEP_G_FLOOR) and 5 steps' losses within LOSS_STEPS_TOL, step by step;
* the port's own ``tests/test_archs.py`` GIN checks, and checkpoints read
  both ways.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import random_graph as jax_random_graph
from repro.models.gnn import gin as jgin
from repro.models.gnn import sampler as jsampler
from repro.train import checkpoint as jckpt
from repro.train import grad as jgrad
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import random_graph
from repro_torch.models.gnn import gin, sampler
from repro_torch.train import (AdamWConfig, AdamWState, adamw_init,
                               make_train_step, restore_checkpoint,
                               save_checkpoint)
from repro_torch.train.tree import tree_leaves

AGG_TOL = 1e-6          # measured: passes
FWD_TOL = 2e-6          # measured <= 3.9e-7
LOSS_TOL = 1e-6         # measured <= 2.6e-7
GRAD_NORM_TOL = 1e-6    # measured <= 1.1e-7
GRAD_COS = 0.99999      # measured 1.0
STEP_TOL = 0.05         # x lr, every weight; measured <= 0.025: AdamW's first
                        # step moves a weight by about lr * sign(g), so where
                        # a clipped gradient is near AdamW's eps (1e-8) its
                        # float32 rounding moves the step
STEP_G_FLOOR = 1e-6     # clipped |g| >= 100 x eps: there the step moves by
                        # under 1% of g's relative error, so
STEP_TIGHT_TOL = 5e-5   # x lr bounds it (measured <= 6.0e-6: an ulp of the
                        # weight; a dropped weight-decay term is 0.1 x |w|)
LOSS_STEPS_TOL = 2e-5   # measured <= 3.4e-6 over 5 steps

LR = 1e-2
MODES = ["node", "graph", "block"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(mode):
    shape = {"node": "full_graph_sm", "graph": "molecule",
             "block": "minibatch_lg"}[mode]
    kw = dict(d_in=12, n_classes=3) if mode != "block" else dict(d_in=8, n_classes=4)
    return (dataclasses.replace(jax_arch("gin-tu").cfg_for(shape), **kw),
            dataclasses.replace(get_arch("gin-tu").cfg_for(shape), **kw))


def _np_batch(mode, seed):
    """The reference test's batches: a 50-node random graph, 4 graphs of
    10 nodes with -1 pads, or a (5, 3) block sampled from a 200-node
    graph."""
    rng = np.random.default_rng(seed)
    if mode == "node":
        return random_graph(rng, 50, 200, 12, 3)
    if mode == "graph":
        return {"x": rng.normal(size=(4, 10, 12)).astype(np.float32),
                "edge_src": rng.integers(-1, 10, size=(4, 20)).astype(np.int32),
                "edge_dst": rng.integers(-1, 10, size=(4, 20)).astype(np.int32),
                "node_mask": (rng.random((4, 10)) < 0.8).astype(np.float32),
                "labels": rng.integers(0, 3, size=4).astype(np.int32)}
    g = random_graph(rng, 200, 2000, 8, 4)
    csr = sampler.build_csr(200, g["edge_src"], g["edge_dst"], g["x"], g["labels"])
    return sampler.sample_block(csr, np.arange(16), (5, 3), rng)


def _losses(mode):
    if mode == "graph":
        return jgin.graph_loss, gin.graph_loss
    return jgin.node_loss, gin.node_loss


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_random_graph_csr_and_blocks_byte_equal():
    for args in ((50, 200, 12, 3), (1000, 7000, 5, 8)):
        want = jax_random_graph(np.random.default_rng(4), *args)
        got = random_graph(np.random.default_rng(4), *args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    n = 1000
    jc = jsampler.build_csr(n, want["edge_src"], want["edge_dst"], want["x"],
                            want["labels"])
    tc = sampler.build_csr(n, got["edge_src"], got["edge_dst"], got["x"], got["labels"])
    for f in ("indptr", "indices", "feats", "labels"):
        a, b = getattr(tc, f), getattr(jc, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for seeds, fanouts in ((np.arange(16), (5, 3)), (np.arange(40, 47), (4,)),
                           (np.array([3, 900, 77]), (15, 10))):
        assert (sampler.block_capacity(len(seeds), fanouts)
                == jsampler.block_capacity(len(seeds), fanouts))
        want = jsampler.sample_block(jc, seeds, fanouts, np.random.default_rng(9))
        got = sampler.sample_block(tc, seeds, fanouts, np.random.default_rng(9))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_aggregate_parity_and_repeatable():
    rng = np.random.default_rng(2)
    h = rng.normal(size=(30, 6)).astype(np.float32)
    src = rng.integers(-1, 30, size=120).astype(np.int32)
    dst = rng.integers(-1, 30, size=120).astype(np.int32)
    dst[dst == 7] = 8                              # node 7 gets no edge
    want = np.asarray(jgin._aggregate(jnp.asarray(h), jnp.asarray(src),
                                      jnp.asarray(dst), 30))
    th, ts, td = (torch.from_numpy(a) for a in (h, src, dst))
    runs = [gin._aggregate(th, gin.edge_plan(ts, td, 30), 30) for _ in range(2)]
    assert runs[0].shape == (30, 6) and torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].numpy(), want, rtol=AGG_TOL, atol=AGG_TOL)
    assert float(runs[0][7].abs().max()) == 0.0


def _carried(cfg, seed=0):
    """A seeded port model on the CPU and the same weights as the JAX
    package's tree (drawn by the port: JAX's eager init costs seconds
    here)."""
    model = gin.init_params(cfg, device="cpu", seed=seed)
    return model, jax.tree.map(jnp.asarray, interop.gin_params_to_numpy(model))


@pytest.fixture(scope="module", params=MODES)
def pair(request):
    mode = request.param
    jcfg, cfg = _cfgs(mode)
    model, params = _carried(cfg, seed=1)
    batch = _np_batch(mode, 3)
    jloss, _ = _losses(mode)

    def reference(params, jb):
        if mode == "graph":
            logits = jgin.graph_forward(params, jb["x"], jb["edge_src"], jb["edge_dst"],
                                        jb["node_mask"], jcfg)
        else:
            logits = jgin.node_forward(params, jb["x"], jb["edge_src"], jb["edge_dst"],
                                       jcfg)
        loss, grads = jax.value_and_grad(lambda p: jloss(p, jb, jcfg))(params)
        return dict(logits=logits, loss=loss, grads=grads)

    want = jax.jit(reference)(params, _j(batch))
    return mode, jcfg, cfg, params, model, batch, want


def test_forward_loss_grads_parity(pair):
    mode, _, cfg, _, model, batch, want = pair
    tb = _t(batch)
    if mode == "graph":
        logits = gin.graph_forward(model, tb["x"], tb["edge_src"], tb["edge_dst"],
                                   tb["node_mask"], cfg)
        assert logits.shape == (4, cfg.n_classes)
    else:
        logits = gin.node_forward(model, tb["x"], tb["edge_src"], tb["edge_dst"], cfg)
        assert logits.shape == (tb["x"].shape[0], cfg.n_classes)
    assert _rel(logits, want["logits"]) <= FWD_TOL
    loss = _losses(mode)[1](model, tb, cfg)
    w = float(want["loss"])
    assert abs(float(loss.detach()) - w) / abs(w) <= LOSS_TOL
    loss.backward()
    got = np.concatenate([g.numpy().ravel()
                          for g in tree_leaves(model.tree(grads=True))])
    ref = np.concatenate([np.asarray(g).ravel()
                          for g in jax.tree.leaves(want["grads"])])
    na, nb = np.linalg.norm(ref), np.linalg.norm(got)
    assert abs(na - nb) / na <= GRAD_NORM_TOL
    assert got @ ref / (na * nb) >= GRAD_COS
    model.zero_grad(set_to_none=True)


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
    mode, jcfg, cfg, params, _, _, _ = pair
    model = interop.gin_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                          device="cpu")
    jloss, tloss = _losses(mode)
    jstep = jax.jit(jgrad.make_train_step(lambda p, b: jloss(p, b, jcfg),
                                          jopt.AdamWConfig(lr=LR)))
    tstep = make_train_step(lambda m, b: tloss(m, b, cfg), AdamWConfig(lr=LR))
    jo, to = jopt.adamw_init(params), adamw_init(model)
    for i in range(5):
        b = _np_batch(mode, 10 + i)
        params, jo, jm = jstep(params, jo, _j(b))
        model, to, tm = tstep(model, to, _t(b))
        w = float(jm["loss"])
        assert abs(float(tm["loss"]) - w) / abs(w) <= LOSS_STEPS_TOL, i
        if i == 0:
            _check_first_step(model, params, jo)
    assert int(to.step) == 5


def test_gin_smoke_all_modes():
    """``tests/test_archs.py::test_gin_smoke_all_modes`` on the port."""
    rng = np.random.default_rng(0)
    for mode in ("node", "graph"):
        _, cfg = _cfgs(mode)
        model = gin.init_params(cfg, device="cpu", seed=0)
        if mode == "graph":
            batch = {"x": torch.from_numpy(rng.normal(size=(4, 10, 12)).astype(np.float32)),
                     "edge_src": torch.from_numpy(rng.integers(-1, 10, size=(4, 20)).astype(np.int32)),
                     "edge_dst": torch.from_numpy(rng.integers(-1, 10, size=(4, 20)).astype(np.int32)),
                     "node_mask": torch.ones((4, 10)),
                     "labels": torch.from_numpy(rng.integers(0, 3, size=4))}
            loss = gin.graph_loss(model, batch, cfg)
        else:
            batch = _t(random_graph(rng, 50, 200, 12, 3))
            loss = gin.node_loss(model, batch, cfg)
        assert torch.isfinite(loss), mode


def test_gin_neighbor_sampler_block_trains():
    """``tests/test_archs.py::test_gin_neighbor_sampler_block_trains`` on
    the port, plus a training step."""
    rng = np.random.default_rng(0)
    _, cfg = _cfgs("block")
    g = random_graph(rng, 200, 2000, 8, 4)
    csr = sampler.build_csr(200, g["edge_src"], g["edge_dst"], g["x"], g["labels"])
    blk = sampler.sample_block(csr, np.arange(16), (5, 3), rng)
    assert blk["x"].shape[0] == 16 + 16 * 5 + 16 * 15
    model = gin.init_params(cfg, device="cpu", seed=1)
    loss = gin.node_loss(model, _t(blk), cfg)
    assert torch.isfinite(loss)
    step = make_train_step(lambda m, b: gin.node_loss(m, b, cfg), AdamWConfig())
    model, _, m = step(model, adamw_init(model), _t(blk))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


def test_checkpoints_cross_both_ways():
    _, cfg = _cfgs("node")
    model, params = _carried(cfg, seed=2)
    jstate = {"params": params, "opt": jopt.adamw_init(params)}
    opt = adamw_init(model)
    opt = opt._replace(step=opt.step + 2)
    tstate = {"params": model.tree(), "opt": opt}
    leaves = tree_leaves(tstate)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(np.shape(x)) for x in jax.tree.leaves(jstate)]
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d + "/port", 3, tstate)
        got, step = jckpt.restore_checkpoint(d + "/port", jstate)
        assert step == 3 and int(got["opt"].step) == 2
        for a, b in zip(jax.tree.leaves(got), leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jckpt.save_checkpoint(d + "/jax", 4, got)
        back, step = restore_checkpoint(d + "/jax", tstate)
        assert step == 4 and isinstance(back["opt"], AdamWState)
        for a, b in zip(tree_leaves(back), leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)
    back = interop.gin_params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError):
        interop.gin_params_from_numpy(jax.tree.map(np.asarray, params),
                                      _cfgs("block")[1], device="cpu")
