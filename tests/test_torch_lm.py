"""repro_torch's dense transformer LM against the JAX package's, on the CPU.

The same seeded inputs go through ``repro.models.transformer`` and
``repro_torch.models.transformer``; parameters are drawn by JAX and
carried across by ``repro_torch.interop`` (``lm_params_from_numpy``), so
both packages run one model.  Both compute in bf16, so the bounds hold
closeness, not bits; each is set just above what these inputs measure
(the measured value beside it):

* attention and decode attention, each kind, with and without softcap:
  max |diff| <= ATTN_TOL (DECODE_TOL) * max |ref|;
* forward logits <= LOGITS_TOL * max |ref| (issue bound 2e-2);
* ``lm_loss`` relative <= LOSS_TOL (the reference's accumulation rtol
  2e-3);
* gradients: global norm within GRAD_NORM_TOL relative and cosine >=
  GRAD_COS;
* prefill and ``serve_step`` (slice and masked cache writes) logits <=
  SERVE_TOL * max |ref|, caches' positions equal.

Then the port's own checks of ``tests/test_archs.py``: decode against
forward (< 0.05, the reference's bound) and the masked ring write
against the slice write.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import common as jcommon
from repro.models.transformer import attention as jattn
from repro.models.transformer import model as jlm
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import attention as tattn
from repro_torch.models.transformer import model as tlm
from repro_torch.train.tree import tree_leaves

ATTN_TOL = 3e-3         # measured <= 1.32e-3
DECODE_TOL = 1e-3       # measured 0: the same f32 arithmetic here
LOGITS_TOL = 2e-2       # measured <= 1.27e-2 (tiny)
LOSS_TOL = 1e-3         # measured <= 3.4e-4 (tiny)
GRAD_NORM_TOL = 3e-3    # measured <= 1.29e-3 (starcoder2 smoke)
GRAD_COS = 0.9998       # measured >= 0.99989
SERVE_TOL = 2e-2        # measured <= 1.34e-2 (starcoder2 prefill)

TINY = jlm.LMConfig("tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                    d_head=16, d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
CONFIGS = ["qwen2-0.5b", "starcoder2-3b", "gemma2-27b", "tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32), np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# ------------------------------------------------------------- primitives
def test_rope_rms_norm_gelu_parity():
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng, (2, 12, 4, 16))
    pos = np.arange(12)[None, :]
    got = tattn.rope(xt, torch.from_numpy(pos), 1e6)
    want = jattn.rope(xj, jnp.asarray(pos), 1e6)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 8e-3            # one bf16 ulp: measured 3.9e-3
    hj, ht = _bf16(rng, (3, 5, 64))
    g = rng.normal(size=(64,)).astype(np.float32) * 0.1
    assert _rel(tcommon.rms_norm(ht, _t(g)),
                jcommon.rms_norm(hj, jnp.asarray(g))) <= 8e-3
    x = rng.normal(size=(1000,)).astype(np.float32) * 3
    for name in ("gelu", "silu", "relu", "tanh"):
        got = tcommon.act_fn(name)(_t(x)).numpy()
        want = np.asarray(jcommon.act_fn(name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6,
                                   err_msg=name)
    # gelu is the tanh approximation: the erf form is 1e-4 away here
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


def test_losses_layer_norm_and_mlp_parity():
    """The rest of ``models/common.py``: ``softmax_xent`` (masked and not;
    a gather where the reference contracts a one-hot), ``sigmoid_bce``,
    ``layer_norm`` and ``mlp_apply`` on carried weights."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        got = tcommon.softmax_xent(_t(logits), _t(labels),
                                   None if m is None else _t(m))
        want = jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    y = (rng.random(40) < 0.5).astype(np.float32)
    x = rng.normal(size=40).astype(np.float32) * 5
    np.testing.assert_allclose(float(tcommon.sigmoid_bce(_t(x), _t(y))),
                               float(jcommon.sigmoid_bce(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6)
    h = rng.normal(size=(4, 32)).astype(np.float32)
    g, b = (rng.normal(size=32).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tcommon.layer_norm(_t(h), _t(g), _t(b)).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(h), jnp.asarray(g), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    layers = jcommon.mlp_init(jax.random.PRNGKey(0), [32, 16, 8])
    tlayers = [{k: _t(v) for k, v in layer.items()} for layer in layers]
    for act, final in (("relu", False), ("gelu", True)):
        np.testing.assert_allclose(
            tcommon.mlp_apply(tlayers, _t(h), act, final).numpy(),
            np.asarray(jcommon.mlp_apply(layers, jnp.asarray(h), act, final)),
            rtol=1e-5, atol=1e-5)
    shapes = [[tuple(t.shape) for t in layer.values()]
              for layer in tcommon.mlp_init([32, 16, 8], device="cpu")]
    assert shapes == [[tuple(np.shape(v)) for v in layer.values()] for layer in layers]


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("chunks", [(16, 16), (16, 32), (32, 16)])
def test_attention_parity(kind, softcap, chunks):
    rng = np.random.default_rng(1)
    B, S, H, KV, dh = 2, 64, 4, 2, 16
    qj, qt = _bf16(rng, (B, S, H, dh))
    kj, kt = _bf16(rng, (B, S, KV, dh))
    vj, vt = _bf16(rng, (B, S, KV, dh))
    kw = dict(kind=kind, window=24, softcap=softcap, q_chunk=chunks[0],
              kv_chunk=chunks[1])
    got = tattn.attention(qt, kt, vt, **kw)
    want = jattn.attention(qj, kj, vj, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, dh)
    assert _rel(got, want) <= ATTN_TOL


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_decode_attention_parity(kind, softcap):
    rng = np.random.default_rng(2)
    B, L, H, KV, dh = 3, 40, 4, 2, 16
    qj, qt = _bf16(rng, (B, 1, H, dh))
    kj, kt = _bf16(rng, (B, L, KV, dh))
    vj, vt = _bf16(rng, (B, L, KV, dh))
    pos = np.arange(L, dtype=np.int32) + 5
    pos[[3, 17, 30]] = -1                        # empty slots
    for cur in (20, 44):
        kw = dict(kind=kind, window=16, softcap=softcap)
        got = tattn.decode_attention(qt, kt, vt, torch.from_numpy(pos), cur, **kw)
        want = jattn.decode_attention(qj, kj, vj, jnp.asarray(pos),
                                      jnp.int32(cur), **kw)
        assert _rel(got, want) <= DECODE_TOL, cur


# ------------------------------------------------------------- the model
def _cfgs(name):
    if name == "tiny":
        return TINY, tlm.LMConfig(**dataclasses.asdict(TINY))
    return jax_arch(name).smoke(), get_arch(name).smoke()


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    """(jax cfg, jax params, port cfg, port model, tokens, the JAX
    package's results on them)."""
    jcfg, tcfg = _cfgs(request.param)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, size=(2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}

    def reference(params, jb):          # one jit: a quarter of eager's time
        logits, _, _ = jlm.forward(params, jb["tokens"], jcfg)
        loss, grads = jax.value_and_grad(jlm.lm_loss)(params, jb, jcfg)
        plog, cache = jlm.prefill(params, jb["tokens"], jcfg, max_seq=32)
        steps = {mode: jlm.serve_step(
            params, cache, jb["tokens"][:, -1:], jnp.int32(31),
            dataclasses.replace(jcfg, cache_update=mode))
            for mode in ("slice", "masked")}
        return dict(logits=logits, loss=loss, grads=grads, prefill=plog,
                    cache=cache, steps=steps)

    want = jax.jit(reference)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    want["loss"] = float(want["loss"])
    want["grads"] = [np.asarray(g, np.float32).ravel()
                     for g in jax.tree.leaves(want["grads"])]
    return jcfg, params, tcfg, model, batch, want


def test_forward_loss_grads_parity(pair):
    _, _, tcfg, model, batch, want = pair
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux, caches = tlm.forward(model, tb["tokens"])
    assert caches is None and float(aux) == 0.0
    assert logits.shape == (2, 32, tcfg.vocab) and logits.dtype == torch.bfloat16
    assert _rel(logits, want["logits"]) <= LOGITS_TOL
    loss = tlm.lm_loss(model, tb)
    assert abs(float(loss.detach()) - want["loss"]) / abs(want["loss"]) <= LOSS_TOL
    loss.backward()
    got = np.concatenate([g.float().numpy().ravel()
                          for g in tree_leaves(model.tree(grads=True))])
    ref = np.concatenate(want["grads"])
    assert got.shape == ref.shape
    na, nb = np.linalg.norm(ref), np.linalg.norm(got)
    assert abs(na - nb) / na <= GRAD_NORM_TOL
    assert got @ ref / (na * nb) >= GRAD_COS
    model.zero_grad(set_to_none=True)


def test_prefill_serve_step_parity(pair):
    jcfg, _, tcfg, model, batch, want = pair
    toks = torch.from_numpy(batch["tokens"])
    plog, cache = tlm.prefill(model, toks, 32)
    assert plog.shape == (2, 1, tcfg.vocab)
    assert _rel(plog, want["prefill"]) <= SERVE_TOL
    for sub, c in want["cache"].items():
        np.testing.assert_array_equal(cache[sub]["pos"].numpy(), np.asarray(c["pos"]))
        assert _rel(cache[sub]["k"], c["k"]) <= SERVE_TOL
    for mode in ("slice", "masked"):
        m = tlm.LM(dataclasses.replace(tcfg, cache_update=mode), device="cpu")
        m.load_tree(model.tree())
        c = {s: {k: v.clone() for k, v in d.items()} for s, d in cache.items()}
        logits, out = tlm.serve_step(m, c, toks[:, -1:], 31)
        assert out is c and out["sub0"]["k"] is c["sub0"]["k"]   # in place
        jlog, jcache = want["steps"][mode]
        assert _rel(logits, jlog) <= SERVE_TOL, mode
        for sub in c:
            np.testing.assert_array_equal(c[sub]["pos"].numpy(),
                                          np.asarray(jcache[sub]["pos"]))


def test_decode_matches_forward_and_masked_equals_slice(pair):
    """The port's own ``tests/test_archs.py`` checks."""
    _, _, tcfg, model, batch, _ = pair
    toks = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        logits, _, _ = tlm.forward(model, toks)
    _, cache = tlm.prefill(model, toks, 32)
    got = {}
    for mode in ("slice", "masked"):
        m = tlm.LM(dataclasses.replace(tcfg, cache_update=mode), device="cpu")
        m.load_tree(model.tree())
        c = {s: {k: v.clone() for k, v in d.items()} for s, d in cache.items()}
        got[mode] = (tlm.serve_step(m, c, toks[:, -1:], 31)[0], c)
    ref = logits[:, 31].float()
    step = got["slice"][0][:, 0].float()
    assert float((step - ref).abs().max() / (ref.abs().max() + 1e-9)) < 0.05
    np.testing.assert_allclose(got["slice"][0].float().numpy(),
                               got["masked"][0].float().numpy(), rtol=2e-2,
                               atol=1e-2)
    for sub in cache:
        for key in ("k", "v", "pos"):
            assert torch.equal(got["slice"][1][sub][key],
                               got["masked"][1][sub][key]), (sub, key)


def test_decode_ring_wraps_past_the_window():
    """SWA caches are rings of ``window`` slots: decoding past the window
    overwrites the oldest slot, as the reference's ``serve_step``."""
    jcfg, tcfg = _cfgs("starcoder2-3b")          # window 16
    params = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 36)).astype(np.int32)
    _, jcache = jlm.prefill(params, jnp.asarray(toks[:, :32]), jcfg, max_seq=32)
    _, cache = tlm.prefill(model, torch.from_numpy(toks[:, :32]), 32)
    assert cache["sub0"]["k"].shape[2] == 16
    step = jax.jit(lambda c, t, pos: jlm.serve_step(params, c, t, pos, jcfg))
    for pos in range(32, 36):
        jl, jcache = step(jcache, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
        tl, cache = tlm.serve_step(model, cache, torch.from_numpy(toks[:, pos:pos + 1]),
                                   pos)
        assert _rel(tl, jl) <= SERVE_TOL, pos
        np.testing.assert_array_equal(cache["sub0"]["pos"].numpy(),
                                      np.asarray(jcache["sub0"]["pos"]))
