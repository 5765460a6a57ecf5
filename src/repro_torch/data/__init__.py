"""Synthetic data (``repro_torch.data.synthetic``): the recsys click-log
generator."""
from repro_torch.data.synthetic import recsys_batches

__all__ = ["recsys_batches"]
