"""Architecture registry (the torch counterpart of ``repro.configs``):
one module per arch, the LM, GNN and recsys families.

``get_arch(id)`` / ``list_archs()`` are the ``--arch`` surface.
"""
from repro_torch.configs.base import ArchSpec

_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "graphcast": "repro_torch.configs.graphcast",
    "autoint": "repro_torch.configs.autoint",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "wide-deep": "repro_torch.configs.wide_deep",
    "deepfm": "repro_torch.configs.deepfm",
}


def list_archs():
    return sorted(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
