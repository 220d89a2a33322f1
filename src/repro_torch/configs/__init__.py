"""Architecture registry: ``--arch <id>`` resolves here.

The ids ported so far: the three dense LMs.  The MoE LMs, GIN, the recsys
models and ``vectordb-wiki`` wait for their slices (ROADMAP Queue 1
item 9).
"""
import importlib

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-0.5b": "qwen2_0_5b",
}

ARCH_IDS = list(_MODULES)
ALL_IDS = list(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported yet (ported: {ARCH_IDS}; "
                       "ROADMAP Queue 1 item 9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def arch_shapes(arch_id: str):
    arch = get_arch(arch_id)
    return [s for s in type(arch).SHAPES if s not in getattr(arch, "skip_shapes", ())]
