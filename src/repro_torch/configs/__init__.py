"""Architecture registry: ``--arch <id>`` resolves here.

The ids ported so far: the three dense LMs, GIN (``gin-tu``) and the four
recsys models.  The two MoE LMs (``llama4-maverick-400b-a17b``,
``mixtral-8x22b``) wait for slice 14 and ``vectordb-wiki`` for slice 17
(ROADMAP Queue 1 item 9).
"""
import importlib

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gin-tu": "gin_tu",
    "xdeepfm": "xdeepfm",
    "autoint": "autoint",
    "din": "din",
    "bst": "bst",
}

ARCH_IDS = list(_MODULES)
ALL_IDS = list(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported yet (ported: {ARCH_IDS}; "
                       "the MoE LMs wait for slice 14, vectordb-wiki for "
                       "slice 17: ROADMAP Queue 1 item 9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def arch_shapes(arch_id: str):
    arch = get_arch(arch_id)
    return [s for s in type(arch).SHAPES if s not in getattr(arch, "skip_shapes", ())]
