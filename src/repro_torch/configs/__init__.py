"""Architecture registry: ``--arch <id>`` resolves here.

The ids ported so far: the five LMs (two of them MoE), GIN (``gin-tu``)
and the four recsys models, the JAX package's ten assigned ids.
``vectordb-wiki`` waits for slice 17, the dry run (ROADMAP Queue 1
item 9).
"""
import importlib

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "mixtral-8x22b": "mixtral_8x22b",
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
                       "vectordb-wiki waits for slice 17, the dry run: "
                       "ROADMAP Queue 1 item 9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def arch_shapes(arch_id: str):
    arch = get_arch(arch_id)
    return [s for s in type(arch).SHAPES if s not in getattr(arch, "skip_shapes", ())]
