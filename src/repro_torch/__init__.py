"""PyTorch/CUDA port of ``repro`` (fast greedy DPP MAP inference).

Mirrors ``repro``'s module layout (``repro/core/windowed.py`` ->
``repro_torch/core/windowed.py``).  Plain tensor code is PyTorch; the
greedy kernels under ``repro_torch.kernels`` are CUDA C++ written for
Hopper (sm_90a), built with ``nvcc`` at first use and bound through
``ctypes``.  Nothing here imports JAX or ``repro``.
"""
