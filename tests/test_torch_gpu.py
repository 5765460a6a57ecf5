"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips without a CUDA device (the kernels have no
CPU mode).  This module imports neither JAX nor ``repro``, so it runs on a
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Slates index for index, ``d_hist`` within rtol 3e-4 / atol 1e-5 (small,
well-separated inputs: no near-ties at these sizes).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy import dpp_greedy
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

RTOL, ATOL = 3e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _inputs(seed, B=3, D=32, M=512):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, D, M)).astype(np.float32)
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    V = F * np.exp(rng.uniform(size=(B, 1, M)) * np.log(3.0)).astype(
        np.float32)
    return torch.from_numpy(V), torch.from_numpy(rng.uniform(size=(B, M))
                                                 > 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_m", [None, 128])
@pytest.mark.parametrize("window", [None, 4])
def test_kernels_match_plain(card, window, tile_m):
    V, mask = _inputs(0)
    k = 16 if window is None else 40
    want = dpp_greedy(V, k, mask, eps=1e-6, window=window, tile_m=tile_m)
    cuda.reset_launch_counts()
    got = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, window=window,
                     tile_m=tile_m)
    torch.cuda.synchronize()
    assert sum(cuda.launch_counts().values()) == (1 if tile_m is None else k)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 5])
def test_reranker_on_card_matches_cpu(card, window):
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=(2, 3000)).astype(np.float32)
    feats = rng.standard_normal((3000, 24)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    cfg = DPPRerankConfig(use_kernel=True, shortlist=400, slate_size=20,
                          alpha=3.0, window=window)
    req = RerankRequest(scores=scores, feats=feats)
    got = Reranker(cfg, device="cuda").rerank(req)
    want = Reranker(cfg, device="cpu").rerank(req)
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
