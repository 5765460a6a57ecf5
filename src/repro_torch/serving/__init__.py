"""DPP rerank serving: ``Reranker(cfg, router_config=...,
session_config=..., device=...)`` + ``RerankRequest``
(``repro_torch.serving.api``); for continuous batching ``RerankRouter``
(``repro_torch.serving.router``); for stateful feeds ``SessionStore`` and
``RerankSession`` (``repro_torch.serving.session``).
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
from repro_torch.serving.session import (
    RerankSession,
    SessionConfig,
    SessionStore,
)

__all__ = [
    "DPPRerankConfig",
    "ObsConfig",
    "Reranker",
    "RerankRequest",
    "RerankSession",
    "RerankRouter",
    "RouterConfig",
    "RouterQueueFull",
    "RouterStats",
    "SessionConfig",
    "SessionStore",
    "SlateHandle",
]
