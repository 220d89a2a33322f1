"""Architecture registry: ``--arch <id>`` resolves here.

``ARCH_IDS`` are the JAX package's ten assigned ids: the five LMs (two of
them MoE), GIN (``gin-tu``) and the four recsys models.  ``ALL_IDS`` adds
the paper's own system, ``vectordb-wiki``.
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
    "vectordb-wiki": "vectordb_wiki",
}

ARCH_IDS = [a for a in _MODULES if a != "vectordb-wiki"]  # the 10 assigned
ALL_IDS = list(_MODULES)


def get_arch(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def arch_shapes(arch_id: str):
    arch = get_arch(arch_id)
    return [s for s in type(arch).SHAPES if s not in getattr(arch, "skip_shapes", ())]
