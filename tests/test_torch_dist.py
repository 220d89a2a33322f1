"""repro_torch's sharding rules, meshes and elastic re-placement against
the JAX package's, on the CPU.

* every case of ``tests/test_dist.py``'s ``TestLMSpecs``,
  ``TestGenericSpecs`` and ``TestElastic`` on the port (paths built from
  the port's ``DictKey``, leaves ``meta`` tensors), each also held to the
  reference's rule on the same path and shape;
* ``tree_specs(..., lm_param_spec)`` over the port's stacked tree (a
  ``meta`` model's ``tree()``) equal to the reference's over its
  ``eval_shape`` tree, leaf by leaf, for all five LMs on both meshes,
  the inference rule and the optimizer-state trees (AdamW, Adafactor)
  too; ``generic_param_spec`` equal for gin-tu's four configs and the
  four recsys models;
* the meshes: the production meshes' names and sizes, abstract (their
  ``device`` raises), the local mesh one cell on one device;
* ``train/elastic.py``: leaves placed bit for bit with their dtypes, a
  NamedTuple state keeping its type, specs refused as ``NamedSharding``
  refuses them, and a smoke LM with its AdamW state re-placed between
  two steps continuing exactly as an uninterrupted run.

``FakeMesh`` is the reference suite's shape-only stand-in: the rules read
only ``mesh.shape`` and ``mesh.axis_names``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_arch
from repro.dist import sharding as jsh
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.train.elastic import reshard_tree as jax_reshard_tree
from repro_torch.configs import get_arch
from repro_torch.dist import (P, batch_axes, generic_param_spec, lm_param_spec,
                              lm_param_spec_inference, opt_state_spec,
                              tree_specs)
from repro_torch.launch import (DeviceMesh, make_local_mesh,
                                make_production_mesh)
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train.elastic import check_spec, reshard_tree, resize_data_axis
from repro_torch.train.optimizer import AdafactorState, AdamWConfig, AdamWState
from repro_torch.train.tree import (DictKey, GetAttrKey, SequenceKey,
                                    as_tree, tree_leaves, tree_map_with_path)

LM_IDS = ["llama4-maverick-400b-a17b", "mixtral-8x22b", "gemma2-27b",
          "starcoder2-3b", "qwen2-0.5b"]
GENERIC_IDS = ["gin-tu", "xdeepfm", "autoint", "din", "bst"]


class FakeMesh:
    """Shape-only stand-in so spec rules are testable without 512 devices."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH1, "2x16x16": MESH2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(shape):
    return torch.empty(tuple(shape), device="meta")


def _both(rule, jrule, name, shape, mesh):
    """The port's spec, held to the reference's on the same path."""
    got = rule((DictKey(name),), _leaf(shape), mesh)
    want = jrule((jax.tree_util.DictKey(name),),
                 jax.ShapeDtypeStruct(tuple(shape), jnp.float32), mesh)
    assert tuple(got) == tuple(want), (got, want)
    return got


def _lm(name, shape, mesh=MESH1):
    return _both(lm_param_spec, jsh.lm_param_spec, name, shape, mesh)


def _flat_specs(jtree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        jtree, is_leaf=lambda x: isinstance(x, JP))]


class TestLMSpecs:
    def test_divisible_heads_get_model_axis(self):
        assert _lm("wq", (23, 4608, 32, 128)) == P(None, "data", "model", None)

    def test_indivisible_heads_fall_back_to_fsdp_only(self):
        assert _lm("wq", (24, 896, 14, 64)) == P(None, "data", None, None)

    def test_moe_expert_parallel_when_divisible(self):
        assert _lm("wg", (12, 128, 5120, 8192)) == P(None, "model", None, "data")

    def test_moe_tp_fallback_mixtral(self):
        assert _lm("wg", (56, 8, 6144, 16384)) == P(None, None, "data", "model")

    def test_embed_never_vocab_sharded(self):
        assert _lm("embed", (256000, 4608))[0] is None

    @pytest.mark.parametrize("arch_id", LM_IDS)
    def test_every_arch_leaf_divides_both_meshes(self, arch_id):
        """No spec may request an indivisible shard on either mesh."""
        arch = get_arch(arch_id)
        tree = as_tree(arch.params_abstract())
        for mesh in (MESH1, MESH2):
            specs = tree_specs(tree, mesh, lm_param_spec)
            for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
                parts = list(spec) + [None] * (leaf.ndim - len(spec))
                for dim, axes in enumerate(parts):
                    if axes is None:
                        continue
                    axes = axes if isinstance(axes, tuple) else (axes,)
                    n = int(np.prod([mesh.shape[a] for a in axes]))
                    assert leaf.shape[dim] % n == 0, (arch_id, leaf.shape, spec)

    def test_opt_state_spec_drops_dims(self):
        spec = P(None, "model", None, "data")
        assert opt_state_spec(spec, 4, "vr") == P(None, "model", None)
        assert opt_state_spec(spec, 4, "vc") == P(None, "model", "data")
        jspec = JP(None, "model", None, "data")
        for which in ("vr", "vc"):
            assert tuple(opt_state_spec(spec, 4, which)) == tuple(
                jsh.opt_state_spec(jspec, 4, which))
        with pytest.raises(ValueError, match="unknown"):
            opt_state_spec(spec, 4, "vx")

    def test_inference_rule_keeps_model_axis_only(self):
        got = _both(lm_param_spec_inference, jsh.lm_param_spec_inference,
                    "wg", (12, 128, 5120, 8192), MESH1)
        assert got == P(None, "model", None, None)


class TestGenericSpecs:
    def test_embedding_table_row_sharded(self):
        got = _both(generic_param_spec, jsh.generic_param_spec, "table",
                    (1048576 * 39, 10), MESH1)
        assert got == P("model", None)

    def test_small_leaves_replicate(self):
        got = _both(generic_param_spec, jsh.generic_param_spec, "w",
                    (64, 128), MESH1)
        assert got == P()


def test_spec_type():
    assert P(None, "data") == P(None, "data") and P() != P(None)
    assert hash(P("a", ("b", "c"))) == hash(P("a", ("b", "c")))
    assert list(P(None, ("pod", "data"))) == [None, ("pod", "data")]
    assert tree_leaves({"a": P(), "b": [P("x"), P(None, "y")]}) == [
        P(), P("x"), P(None, "y")]          # a leaf, never a container
    with pytest.raises(AttributeError):
        P()._parts = ()
    with pytest.raises(TypeError):
        P(3)
    assert batch_axes(MESH1) == jsh.batch_axes(MESH1) == ("data",)
    assert batch_axes(MESH2) == jsh.batch_axes(MESH2) == ("pod", "data")


def test_tree_paths_are_jax_key_paths():
    """The port's paths are JAX's key paths entry for entry (dict keys,
    sequence positions, NamedTuple fields), so ``_leaf_name`` finds the
    same key in both."""
    from repro.train.optimizer import AdamWState as JAdamWState
    from repro_torch.dist.sharding import _leaf_name

    def entries(path):
        return [(type(e).__name__, getattr(e, "key", getattr(
            e, "idx", getattr(e, "name", None)))) for e in path]

    tree = lambda leaf, st: st(step=leaf, mu={"b": [leaf], "a": leaf},
                               nu={"c": {"d": leaf}})
    paths = []
    tree_map_with_path(lambda path, leaf: paths.append(path),
                       tree(torch.zeros(()), AdamWState))
    jpaths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        tree(jnp.zeros(()), JAdamWState))[0]]
    assert [entries(p) for p in paths] == [entries(p) for p in jpaths]
    assert [_leaf_name(p) for p in paths] == [jsh._leaf_name(p) for p in jpaths]
    assert [_leaf_name(p) for p in paths] == ["step", "a", "b", "d"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_tree_specs_equal_the_references(arch_id, mesh_name):
    """Parameter, inference and optimizer-state spec trees, leaf by leaf
    (the port's ``meta`` model's stacked tree against the reference's
    ``eval_shape`` tree), with the leaves' shapes and dtypes equal."""
    mesh = MESHES[mesh_name]
    arch, ref = get_arch(arch_id), jax_arch(arch_id)
    model = arch.params_abstract()
    tree, jtree = as_tree(model), ref.params_abstract()
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(tree)] == [
        (tuple(t.shape), str(t.dtype)) for t in jax.tree_util.tree_leaves(jtree)]
    for rule, jrule in ((lm_param_spec, jsh.lm_param_spec),
                        (lm_param_spec_inference, jsh.lm_param_spec_inference)):
        got = [tuple(s) for s in tree_leaves(tree_specs(tree, mesh, rule))]
        assert got == _flat_specs(jsh.tree_specs(jtree, mesh, jrule))
    ospecs, jospecs = arch.opt_specs(mesh, model), ref.opt_specs(mesh, jtree)
    assert type(ospecs).__name__ == type(jospecs).__name__
    assert ospecs._fields == jospecs._fields
    assert [tuple(s) for s in tree_leaves(ospecs)] == _flat_specs(jospecs)
    # the optimizer state's leaves line up with its specs
    state = arch.opt_abstract(model)
    assert len(tree_leaves(state)) == len(tree_leaves(ospecs))
    if arch.optimizer == "adafactor":
        assert isinstance(state, AdafactorState)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", GENERIC_IDS)
def test_generic_specs_equal_the_references(arch_id, mesh_name):
    mesh = MESHES[mesh_name]
    arch, ref = get_arch(arch_id), jax_arch(arch_id)
    if arch_id == "gin-tu":
        from repro.models.gnn import gin as jgin
        from repro_torch.models.gnn import gin
        pairs = [(gin.init_params(arch.cfg_for(s), None, device="meta"),
                  jax.eval_shape(lambda k, c=ref.cfg_for(s): jgin.init_params(k, c),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32)))
                 for s in type(arch).SHAPES]
    else:
        pairs = [(arch.init_fn(arch.cfg, None, device="meta"),
                  jax.eval_shape(lambda k: ref.init_fn(k, ref.cfg),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32)))]
    for model, jtree in pairs:
        tree = as_tree(model)
        assert [tuple(t.shape) for t in tree_leaves(tree)] == [
            tuple(t.shape) for t in jax.tree_util.tree_leaves(jtree)]
        got = [tuple(s) for s in tree_leaves(
            tree_specs(tree, mesh, generic_param_spec))]
        assert got == _flat_specs(jsh.tree_specs(jtree, mesh,
                                                 jsh.generic_param_spec))


# ------------------------------------------------------------------ meshes
def test_production_meshes_are_abstract():
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (m1.axis_names, m1.shape) == (("data", "model"),
                                         {"data": 16, "model": 16})
    assert (m2.axis_names, m2.shape) == (("pod", "data", "model"),
                                         {"pod": 2, "data": 16, "model": 16})
    for m in (m1, m2):
        with pytest.raises(ValueError, match="spans"):
            m.device
    with pytest.raises(ValueError, match="spans"):
        reshard_tree({"w": torch.ones(2)}, m1, lambda path, leaf: P())


def test_local_mesh_is_one_cell_on_one_device():
    m = make_local_mesh(1, 1, device="cpu")
    assert (m.axis_names, m.shape, m.device) == (
        ("data", "model"), {"data": 1, "model": 1}, torch.device("cpu"))
    assert make_local_mesh().device == torch.device("cuda")   # the default
    for data, model in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError):
            make_local_mesh(data, model, device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        DeviceMesh(("data",), (1, 1))
    # a spec over the local mesh places whole leaves, as the reference's
    jm = jax_local_mesh(1, 1)
    assert dict(jm.shape) == m.shape and tuple(jm.axis_names) == m.axis_names


# ----------------------------------------------------------------- elastic
class TestElastic:
    def test_reshard_between_meshes(self):
        m1 = make_local_mesh(1, 1, device="cpu")
        w = np.arange(16.0, dtype=np.float32).reshape(4, 4)
        tree = {"w": torch.from_numpy(w), "s": torch.tensor(3.0)}
        out = reshard_tree(tree, m1, lambda path, leaf: P())
        want = jax_reshard_tree({"w": jnp.asarray(w), "s": jnp.float32(3)},
                                jax_local_mesh(1, 1), lambda path, leaf: JP())
        assert (out["w"].numpy() == np.asarray(want["w"])).all()
        assert float(out["s"]) == float(want["s"])
        assert list(out) == list(want)

    def test_specs_checked_as_named_sharding(self):
        m = make_local_mesh(1, 1, device="cpu")
        leaf = torch.ones(4, 6)
        check_spec(P("data", "model"), leaf.shape, m)
        check_spec(P(("data", "model")), leaf.shape, m)
        with pytest.raises(ValueError, match="not in the mesh"):
            reshard_tree({"w": leaf}, m, lambda path, leaf: P("pod"))
        with pytest.raises(ValueError, match="entries"):
            reshard_tree({"w": leaf}, m, lambda path, leaf: P(None, None, None))
        with pytest.raises(ValueError, match="twice"):
            check_spec(P("data", "data"), leaf.shape, m)
        with pytest.raises(ValueError, match="does not divide"):
            check_spec(P(None, "model"), leaf.shape, FakeMesh({"data": 2, "model": 4}))
        with pytest.raises(TypeError):
            reshard_tree({"w": leaf}, m, lambda path, leaf: None)

    def test_states_keep_type_dtype_and_bits(self):
        m = make_local_mesh(1, 1, device="cpu")
        g = torch.Generator().manual_seed(0)
        p = {"a": torch.randn(3, 4, generator=g).to(torch.bfloat16),
             "b": [torch.randn(5, generator=g)]}
        state = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                           mu=p, nu=p)
        seen = []
        out = reshard_tree(state, m, lambda path, leaf: (
            seen.append(jsh._leaf_name(path)) or P()))
        assert isinstance(out, AdamWState)
        assert seen == ["step", "a", "b", "a", "b"]
        for a, b in zip(tree_leaves(out), tree_leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_resize_continues_training_exactly(self):
        """Two AdamW steps, the parameters and state re-placed through
        ``resize_data_axis`` (the rule: ``lm_param_spec``), two more: the
        losses, parameters and moments of four straight steps."""
        from repro_torch.models.transformer import model as lm
        cfg = get_arch("qwen2-0.5b").smoke()
        g = torch.Generator().manual_seed(1)
        batches = [{"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
                    "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
                   for _ in range(4)]
        step = make_train_step(lm.lm_loss, AdamWConfig())
        old, new = make_local_mesh(1, 1, device="cpu"), make_local_mesh(
            1, 1, device="cpu")

        def rule(path, leaf):
            return lm_param_spec(path, leaf, new)

        def run(resize: bool):
            model = lm.init_params(cfg, device="cpu", seed=3)
            state, losses = adamw_init(model), []
            for i, b in enumerate(batches):
                if resize and i == 2:
                    tree = resize_data_axis(model.tree(), old, new, rule)
                    state = resize_data_axis(state, old, new, rule)
                    model = lm.LM(cfg, None, device="cpu").load_tree(tree)
                model, state, metrics = step(model, state, b)
                losses.append(metrics["loss"])
            return losses, model.tree(), state

        l1, p1, s1 = run(False)
        l2, p2, s2 = run(True)
        assert all(torch.equal(a, b) for a, b in zip(l1, l2))
        for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
            assert torch.equal(a, b)
