"""Seeded violations: plan-key-tensor / plan-key-unhashable."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def tile_plan(D: int, M: int, lanes: int, V: torch.Tensor = None):  # LINE
    # V annotated as a tensor -> plan-key-tensor (the parameter's line)
    return D * M * lanes


@functools.lru_cache
def fine_plan(D: int, device):
    return D


def caller(V):
    a = tile_plan(8, 1000, 4, torch.zeros(3))  # LINE: plan-key-tensor
    w = torch.ones(2) * 3
    b = tile_plan(8, 1000, 4, w)  # LINE: plan-key-tensor (taint via w)
    c = tile_plan(8, [1000, 2000], 4)  # LINE: plan-key-unhashable
    d = tile_plan(V.shape[0], V.shape[1], 4)  # shapes are host ints: fine
    e = fine_plan(8, V.device)  # a device hashes by value: fine
    return a, b, c, d, e
