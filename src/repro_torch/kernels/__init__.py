"""Hand-written CUDA kernels (Hopper, sm_90a) for the hot spots.

Each subpackage ships its kernel modules (a wrapper per kernel that
launches it on CUDA tensors and runs its plain PyTorch version on CPU
ones), ``ops.py`` (the public dispatch) and ``ref.py`` (the plain
oracle); ``csrc/`` holds the CUDA sources, built by
``repro_torch.kernels.cuda`` at first use.  Three families:
``dpp_greedy`` (K1-K6, the greedy DPP MAP rerank), ``scored_topk`` (K7,
fused scoring and top-c) and ``fm_interaction`` (K8, DeepFM's FM term).
"""
from repro_torch.kernels.dpp_greedy import dpp_greedy
from repro_torch.kernels.fm_interaction import fm_interaction
from repro_torch.kernels.scored_topk import scored_topk

__all__ = ["dpp_greedy", "fm_interaction", "scored_topk"]
