"""Architecture registry (the torch counterpart of ``repro.configs``):
one module per arch.  The four recsys archs are ported; the LM and GNN
ids are known and raise ``NotImplementedError`` (ROADMAP queue 1 item
12).

``get_arch(id)`` / ``list_archs()`` are the ``--arch`` surface.
"""
from repro_torch.configs.base import ArchSpec

_MODULES = {
    "autoint": "repro_torch.configs.autoint",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "wide-deep": "repro_torch.configs.wide_deep",
    "deepfm": "repro_torch.configs.deepfm",
}
_NOT_PORTED = ("arctic-480b", "olmoe-1b-7b", "phi3-mini-3.8b", "gemma3-27b",
               "qwen1.5-4b", "graphcast")


def list_archs():
    """The ported arch ids."""
    return sorted(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    import importlib

    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} (the LM and GNN families) is not ported yet "
            f"(ROADMAP queue 1 item 12); ported: {list_archs()}"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
