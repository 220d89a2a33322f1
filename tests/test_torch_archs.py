"""repro_torch's architecture registry and training launcher, on the CPU.

* the registry holds the ten assigned ids, and ``vectordb-wiki`` (the
  paper's own system) with the reference's shapes and constants;
* the smoke and full configs equal the JAX package's field for field
  (the dense and the MoE LMs),
  and so do the ``LMArch`` records (optimizer, skipped shapes, accum,
  the ``SHAPES`` table), the ``RecsysArch`` records (config, smoke
  config, ``seq``, ``SHAPES``; the four models' full parameter counts)
  and ``GNNArch`` (base config, ``SHAPES``, ``cfg_for`` every shape);
* ``param_count`` and ``active_param_count`` equal JAX's for all five LM
  configs (pure arithmetic; the MoE ones as ``LMConfig`` values), and the
  port's module holds that many parameters plus the QKV biases and
  ``ln_f``, which the count leaves out;
* the training launcher (``repro_torch.launch.train``'s ``main``, as
  ``python -m`` runs it) with ``--smoke --device cpu`` trains 4 steps,
  then resumes to 6 from its checkpoint, for qwen2-0.5b, both MoE LMs
  (each with its optimizer: AdamW, Adafactor), din and gin-tu; it
  refuses a run without ``--smoke`` and ``vectordb-wiki``, which trains
  nothing.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import arch_shapes as jax_arch_shapes
from repro.configs import get_arch as jax_arch
from repro_torch.configs import ARCH_IDS, arch_shapes, get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer.model import LM, LMConfig

DENSE = ["gemma2-27b", "starcoder2-3b", "qwen2-0.5b"]
LM_IDS = ["llama4-maverick-400b-a17b", "mixtral-8x22b", *DENSE]
RS_IDS = ["xdeepfm", "autoint", "din", "bst"]
# the full configs' parameter counts (the issue's; the reference's trees)
RS_PARAMS = {"xdeepfm": 453_586_306, "autoint": 654_350_798,
             "din": 302_025_171, "bst": 538_242_786}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(jcfg) -> LMConfig:
    return LMConfig(**dataclasses.asdict(jcfg))


def test_registry():
    assert sorted(ARCH_IDS) == sorted(LM_IDS + ["gin-tu"] + RS_IDS)
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    for arch_id in ARCH_IDS:
        assert arch_shapes(arch_id) == jax_arch_shapes(arch_id)
    assert arch_shapes("qwen2-0.5b") == ["train_4k", "prefill_32k", "decode_32k"]
    assert arch_shapes("din") == ["train_batch", "serve_p99", "serve_bulk",
                                  "retrieval_cand"]
    from repro.configs import vectordb_wiki as jwiki
    from repro_torch.configs import vectordb_wiki as wiki
    arch, ref = get_arch("vectordb-wiki"), jax_arch("vectordb-wiki")
    assert type(arch).SHAPES == type(ref).SHAPES
    assert arch_shapes("vectordb-wiki") == jax_arch_shapes("vectordb-wiki") == [
        "search_b128", "search_b1", "encode_4m"]
    assert (wiki.N_DOCS, wiki.N_FEATURES, wiki.ENCODER.precision) == (
        jwiki.N_DOCS, jwiki.N_FEATURES, jwiki.ENCODER.precision)
    assert wiki.ENCODER.code_dtype == torch.int8


@pytest.mark.parametrize("arch_id", RS_IDS)
def test_recsys_configs_equal_the_references(arch_id):
    arch, ref = get_arch(arch_id), jax_arch(arch_id)
    for mine, theirs in ((arch.cfg, ref.cfg), (arch.smoke_cfg, ref.smoke_cfg)):
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.embed_dim == theirs.embed_dim
    assert (arch.seq, arch.family) == (ref.seq, ref.family)
    assert type(arch).SHAPES == type(ref).SHAPES
    assert [f.__name__ for f in (arch.init_fn, arch.forward_fn, arch.user_fn)] == [
        f.__name__ for f in (ref.init_fn, ref.forward_fn, ref.user_fn)]
    full = arch.init_fn(arch.cfg, device="meta")
    assert sum(p.numel() for p in full.parameters()) == RS_PARAMS[arch_id]


def test_gin_config_equals_the_reference():
    arch, ref = get_arch("gin-tu"), jax_arch("gin-tu")
    assert dataclasses.asdict(arch.base_cfg) == dataclasses.asdict(ref.base_cfg)
    assert type(arch).SHAPES == type(ref).SHAPES and arch.family == ref.family
    for shape in type(ref).SHAPES:
        assert dataclasses.asdict(arch.cfg_for(shape)) == dataclasses.asdict(
            ref.cfg_for(shape))


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_configs_equal_the_references(arch_id):
    arch, ref = get_arch(arch_id), jax_arch(arch_id)
    assert dataclasses.asdict(arch.cfg) == dataclasses.asdict(ref.cfg)
    assert dataclasses.asdict(arch.smoke()) == dataclasses.asdict(ref.smoke())
    assert (arch.optimizer, arch.skip_shapes, arch.accum, arch.family) == (
        ref.optimizer, ref.skip_shapes, ref.accum, ref.family)
    assert type(arch).SHAPES == type(ref).SHAPES


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_param_counts_equal_the_references(arch_id):
    ref = jax_arch(arch_id)
    for jcfg in (ref.cfg, ref.smoke()):
        cfg = _port_cfg(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert [tuple(k) for k in cfg.sub_kinds()] == [tuple(k) for k in jcfg.sub_kinds()]
        assert (cfg.period, cfg.n_super) == (jcfg.period, jcfg.n_super)
    if arch_id == "qwen2-0.5b":
        assert ref.cfg.param_count() == 494_004_224


@pytest.mark.parametrize("arch_id", DENSE)
def test_module_holds_the_counted_parameters(arch_id):
    cfg = get_arch(arch_id).smoke()
    model = LM(cfg, device="cpu")
    biases = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head * cfg.n_layers \
        if cfg.qkv_bias else 0
    # the reference's param_count leaves out the QKV biases and ln_f
    assert (sum(p.numel() for p in model.parameters())
            == cfg.param_count() + biases + cfg.d_model)
    full = get_arch("qwen2-0.5b").cfg
    assert full.param_count() + 24 * (14 + 2 * 2) * 64 == 494_031_872


def _train(*argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(list(argv))
    return out.getvalue()


def test_launch_train_smoke_and_resume(tmp_path):
    _smoke_and_resume(tmp_path, "qwen2-0.5b")


@pytest.mark.parametrize("arch_id", ["din", "gin-tu"])
def test_launch_train_smoke_and_resume_recsys_and_gnn(tmp_path, arch_id):
    _smoke_and_resume(tmp_path, arch_id)


@pytest.mark.parametrize("arch_id", ["mixtral-8x22b", "llama4-maverick-400b-a17b"])
def test_launch_train_smoke_and_resume_moe(tmp_path, arch_id):
    _smoke_and_resume(tmp_path, arch_id)


def _smoke_and_resume(tmp_path, arch_id):
    args = ["--arch", arch_id, "--smoke", "--batch-size", "4",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--device", "cpu"]
    first = _train(*args, "--steps", "4")
    assert "resuming" not in first and "step     0 loss" in first
    assert first.rstrip().endswith("done")
    assert sorted(os.listdir(tmp_path / f"ck_{arch_id}")) == [
        "step_00000002", "step_00000004"]
    second = _train(*args, "--steps", "6")
    assert "resuming at step 4" in second and "step     0" not in second
    assert "step_00000006" in os.listdir(tmp_path / f"ck_{arch_id}")


def test_launch_train_refuses_full_scale(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--smoke"):
        launch_train.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "vectordb-wiki", "--smoke", "--device", "cpu"])
    assert exc.value.code == 2 and "invalid choice" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "ck_qwen2-0.5b")
