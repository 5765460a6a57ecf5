"""Seeded violations: obs-nonstatic (device work in obs hook args)."""
import torch


def emit(obs, x, n):
    with obs.span("serving.chunk", total=torch.sum(x)):  # LINE: obs-nonstatic
        pass
    obs.span("serving.flush", last=x.item())  # LINE: obs-nonstatic
    with obs.span("serving.ok", count=n, width=int(n) * 2, sid=str(n)):
        pass  # host scalars are fine
