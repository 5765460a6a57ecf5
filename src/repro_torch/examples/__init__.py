"""Runnable examples of the port (the counterparts of ``repro``'s
``examples/``): ``python -m repro_torch.examples.quickstart``."""
