"""DPP rerank serving: ``Reranker(cfg, device=...)`` + ``RerankRequest``
(``repro_torch.serving.api``).  The router and sessions of ``repro``'s
serving layer are not ported yet (ROADMAP queue 1 items 7 and 8).
"""
from repro_torch.obs import ObsConfig
from repro_torch.serving.api import Reranker, RerankRequest
from repro_torch.serving.reranker import DPPRerankConfig

__all__ = [
    "DPPRerankConfig",
    "ObsConfig",
    "Reranker",
    "RerankRequest",
]
