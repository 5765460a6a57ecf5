"""Hand-written CUDA kernels (Hopper, sm_90a) for the hot spots.

Each subpackage ships its kernel modules (a wrapper per kernel that
launches it on CUDA tensors and runs its plain PyTorch version on CPU
ones), ``ops.py`` (the public dispatch) and ``ref.py`` (the plain
oracle); ``csrc/`` holds the CUDA sources, built by
``repro_torch.kernels.cuda`` at first use.  ``scored_topk`` and
``fm_interaction`` are not ported yet.
"""
from repro_torch.kernels.dpp_greedy import dpp_greedy

__all__ = ["dpp_greedy"]
