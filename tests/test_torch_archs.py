"""repro_torch's architecture registry and training launcher, on the CPU.

* the registry holds the ids ported so far, and refuses the others;
* the smoke and full configs equal the JAX package's field for field,
  and so do the ``LMArch`` records (optimizer, skipped shapes, accum,
  the ``SHAPES`` table);
* ``param_count`` and ``active_param_count`` equal JAX's for all five LM
  configs (pure arithmetic; the MoE ones as ``LMConfig`` values), and the
  port's module holds that many parameters plus the QKV biases and
  ``ln_f``, which the count leaves out;
* a config with MoE layers raises, naming the slice it waits for;
* the training launcher (``repro_torch.launch.train``'s ``main``, as
  ``python -m`` runs it) with ``--smoke --device cpu`` trains 4 steps,
  then resumes to 6 from its checkpoint; it refuses a run without
  ``--smoke`` and an arch not ported yet.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import pytest
import torch

from repro.configs import arch_shapes as jax_arch_shapes
from repro.configs import get_arch as jax_arch
from repro_torch.configs import ARCH_IDS, arch_shapes, get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer.model import LM, LMConfig

DENSE = ["gemma2-27b", "starcoder2-3b", "qwen2-0.5b"]
LM_IDS = ["llama4-maverick-400b-a17b", "mixtral-8x22b", *DENSE]


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
    assert sorted(ARCH_IDS) == sorted(DENSE)
    for arch_id in DENSE:
        assert arch_shapes(arch_id) == jax_arch_shapes(arch_id)
    assert arch_shapes("qwen2-0.5b") == ["train_4k", "prefill_32k", "decode_32k"]
    with pytest.raises(KeyError, match="not ported"):
        get_arch("mixtral-8x22b")


@pytest.mark.parametrize("arch_id", DENSE)
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


@pytest.mark.parametrize("arch_id", ["mixtral-8x22b", "llama4-maverick-400b-a17b"])
def test_moe_guard_raises(arch_id):
    cfg = _port_cfg(jax_arch(arch_id).smoke())
    with pytest.raises(NotImplementedError, match="slice 14"):
        LM(cfg, device="cpu")


def _train(*argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(list(argv))
    return out.getvalue()


def test_launch_train_smoke_and_resume(tmp_path):
    args = ["--arch", "qwen2-0.5b", "--smoke", "--batch-size", "4",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--device", "cpu"]
    first = _train(*args, "--steps", "4")
    assert "resuming" not in first and "step     0 loss" in first
    assert first.rstrip().endswith("done")
    assert sorted(os.listdir(tmp_path / "ck_qwen2-0.5b")) == [
        "step_00000002", "step_00000004"]
    second = _train(*args, "--steps", "6")
    assert "resuming at step 4" in second and "step     0" not in second
    assert "step_00000006" in os.listdir(tmp_path / "ck_qwen2-0.5b")


def test_launch_train_refuses_full_scale(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--smoke"):
        launch_train.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu"])
    assert exc.value.code == 2 and "invalid choice" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "ck_qwen2-0.5b")
