"""DPP rerank serving: ``Reranker(cfg, router_config=..., device=...)`` +
``RerankRequest`` (``repro_torch.serving.api``) and, for continuous
batching, ``RerankRouter`` (``repro_torch.serving.router``).  Sessions of
``repro``'s serving layer are not ported yet (ROADMAP queue 1 item 8).
"""
from repro_torch.obs import ObsConfig
from repro_torch.serving.api import Reranker, RerankRequest
from repro_torch.serving.reranker import DPPRerankConfig
from repro_torch.serving.router import (
    RerankRouter,
    RouterConfig,
    RouterQueueFull,
    RouterStats,
    SlateHandle,
)

__all__ = [
    "DPPRerankConfig",
    "ObsConfig",
    "Reranker",
    "RerankRequest",
    "RerankRouter",
    "RouterConfig",
    "RouterQueueFull",
    "RouterStats",
    "SlateHandle",
]
