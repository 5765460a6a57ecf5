"""Suppression semantics: a valid suppression silences its line, a typo
is itself a finding (bad-suppression) and silences nothing."""
import torch


def emit(obs, x):
    obs.span("a", v=torch.sum(x))  # repro_torch: ignore[obs-nonstatic]
    return x


def typo_does_not_silence(obs, x):
    obs.span("b", v=torch.sum(x))  # repro_torch: ignore[obs-nonstatc]
    return x
