"""``python -m repro_torch.kernels.autotune`` — the measured tile sweep
of the dpp_greedy CUDA kernels (K3-K6) on this card; the counterpart of
``repro.kernels.autotune``.

Thin runner over :mod:`repro_torch.kernels.dpp_greedy.autotune` (the
cache, keying and timing live there, beside the kernels they tune)::

    python -m repro_torch.kernels.autotune --smoke          # a few seconds
    python -m repro_torch.kernels.autotune --full --trials 5

then serve with ``tile_m="auto"`` (``GreedySpec(backend="kernel")`` /
``DPPRerankConfig(use_kernel=True)``) or ``DPP_TILE_M=auto``, pointed at
the same cache (``$DPP_AUTOTUNE_CACHE`` or the per-user default).
"""
from repro_torch.kernels.dpp_greedy.autotune import main

if __name__ == "__main__":
    raise SystemExit(main())
