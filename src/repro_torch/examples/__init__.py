"""Runnable examples of the port (the counterparts of ``repro``'s
``examples/``): ``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.serve_recsys``,
``python -m repro_torch.examples.lm_rerank`` and
``python -m repro_torch.examples.train_fault_tolerant``."""
