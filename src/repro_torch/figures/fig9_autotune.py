"""Measured tile choice against the on-chip budget model (beyond-paper;
the measured autotune cache end to end at serving shapes); the
counterpart of ``repro``'s ``benchmarks/fig9_autotune.py``.

Every kernel family's smoke geometry (the grid ``python -m
repro_torch.kernels.autotune --smoke`` measures: K3 / K4 whole slates,
K5 / K6 slates in chunks of 8, D = 64, M = 65,536) runs three ways
through ``greedy_map``:

* ``tile_m="auto"`` — the measured cache's tile for this card, the model
  as its fallback;
* the model default (``tile_m=None``);
* the measured tile given explicitly (``explicit_us``: what the lookup
  itself adds to a call is ``us_per_call`` less it);
* the torch core (``backend="torch"``) — the index-for-index reference.

The cache comes from ``$DPP_AUTOTUNE_CACHE`` when that file exists;
otherwise the smoke sweep runs first into a temporary file, so the
figure stands alone.  ``DPP_TILE_M`` is set aside for the run (it would
override both sides).

Gates (red on failure):

* **tolerance** — the measured tile is no slower than the model default
  beyond a noise tolerance (1.25, 2.0 at ``--smoke``: the tuner must not
  lose to the model it always measures beside its candidates).  A
  wall-clock ordering, so it is enforced on the card only; on the CPU
  the times are the plain versions' host times, reported, not asserted;
* **cache hits** — the ``"auto"`` dispatches consulted the cache
  (``autotune_cache_hits_total`` >= 1: the figure measures the measured
  path, not a silent model fallback);
* **no rebuild after warmup** — ``RebuildMonitor.since_mark() == 0``
  over a repeated ``"auto"`` call: no kernel build, library load or
  slot-state allocation (the port's counterpart of ``repro``'s jit
  cache misses);
* **parity** — every tuner-chosen slate equals the model default's bit
  for bit, ``d_hist`` included (the tiles share the kernels' per-column
  code and the exact (value, lowest index) argmax), and the torch core's
  index for index.

  python -m repro_torch.figures.fig9_autotune [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch

from repro_torch import obs
from repro_torch.core import GreedySpec, greedy_map
from repro_torch.device import resolve_device
from repro_torch.figures.common import device_line, parse, wall
from repro_torch.kernels.dpp_greedy.autotune import (
    CACHE_ENV,
    bucket_m,
    case_inputs,
    lookup_tile,
    model_tile,
    run_sweep,
    smoke_cases,
)
from repro_torch.kernels.dpp_greedy.tiled import capacity_fn
from repro_torch.obs.dispatch import RebuildMonitor

EPS = 1e-6


@contextlib.contextmanager
def _env(name, value):
    """``os.environ[name]`` set to ``value`` (unset for None) inside the
    block, restored after."""
    was = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if was is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = was


def _spec(case, tile_m, backend="kernel"):
    return GreedySpec(k=case.k, window=case.window, backend=backend, eps=EPS,
                      tile_m=tile_m,
                      chunk_size=case.chunk if case.chunked else None)


def _slate(spec, V):
    res = greedy_map(spec, V=V)
    return res.indices, res.d_hist


def _least_times(fns, trials, dev):
    """Least host wall of each of ``fns`` over ``trials`` rounds after one
    warm call each, the order rotating from round to round, so no side
    always runs first (seconds)."""
    for fn in fns:
        fn()
    out = [[] for _ in fns]
    for i in range(trials):
        for j in range(len(fns)):
            side = (i + j) % len(fns)
            out[side].append(wall(fns[side], dev))
    return [min(t) for t in out]


def _case_row(case, dev, trials, tolerance, reg, failures):
    Mb = bucket_m(case.M)
    V = case_inputs(case, dev)
    capacity = capacity_fn(case.windowed, dev) if case.chunked else None
    auto, model = _spec(case, "auto"), _spec(case, None)
    hits = reg.counter("autotune_cache_hits_total")
    h0 = hits.total()
    sel_auto, dh_auto = _slate(auto, V)
    hit = hits.total() - h0
    sel_model, dh_model = _slate(model, V)
    sel_core = _slate(GreedySpec(k=case.k, window=case.window,
                                 backend="torch", eps=EPS), V)[0]
    cached = lookup_tile(D=case.D, M=Mb, state_rows=case.state_rows,
                         windowed=case.windowed, chunked=case.chunked,
                         capacity=capacity, device=dev)
    tile_model = model_tile(case.D, Mb, case.state_rows, case.windowed,
                            case.chunked, capacity=capacity)

    same = (torch.equal(sel_auto, sel_model)
            and torch.equal(dh_auto, dh_model))
    core = torch.equal(sel_auto.cpu(), sel_core.cpu())
    parity = same and core
    if not parity:
        failures.append(
            f"{case.family}: the tile_m='auto' slate (tile {cached}) "
            f"{'differs from' if not same else 'equals'} the model "
            f"default's (tile {tile_model}) and "
            f"{'differs from' if not core else 'equals'} the torch core's "
            f"({sel_auto.tolist()} vs {sel_model.tolist()} vs "
            f"{sel_core.tolist()})")
    # warmed above: the repeated cache-hit path (the timed calls) builds,
    # loads and allocates nothing
    mon = RebuildMonitor(reg)
    mon.mark()
    # the measured tile given explicitly: what the lookup itself costs
    explicit = _spec(case, cached if cached is not None else tile_model)
    t_auto, t_model, t_explicit = _least_times(
        [lambda: greedy_map(auto, V=V), lambda: greedy_map(model, V=V),
         lambda: greedy_map(explicit, V=V)], trials, dev)
    rebuilds = int(mon.since_mark())
    if rebuilds:
        failures.append(f"{case.family}: {rebuilds} kernel builds, loads or "
                        f"state allocations on the warmed tile_m='auto' "
                        f"path (expected 0)")
    ratio = t_auto / max(t_model, 1e-12)
    if dev.type == "cuda" and ratio > tolerance:
        failures.append(
            f"{case.family}: the measured tile {cached} takes {ratio:.2f}x "
            f"the model default's {tile_model} (tolerance {tolerance}x)")
    return hit, (
        f"fig9_{case.family}", t_auto * 1e6,
        f"tile_auto={cached};tile_model={tile_model};D={case.D};M={Mb};"
        f"R={case.state_rows};model_us={t_model * 1e6:.1f};"
        f"explicit_us={t_explicit * 1e6:.1f};ratio={ratio:.2f};"
        f"rebuilds_after_warmup={rebuilds};"
        f"parity={'ok' if parity else 'FAIL'}")


def run(fast_mode, device=None):
    """Returns ``(rows, failures)``: one row a family and the cache row
    (the hits of the families' first ``"auto"`` calls), and the red gates
    (tolerance on the card only)."""
    dev = resolve_device(device)
    # the card's calls take a millisecond and its host's wall jitters by
    # a tenth between rounds: enough rounds that the least is steady
    trials = (10 if fast_mode else 20) if dev.type == "cuda" else \
        (1 if fast_mode else 3)
    tolerance = 2.0 if fast_mode else 1.25
    rows, failures = [], []
    path = os.environ.get(CACHE_ENV)
    tmp = None
    if not path or not os.path.exists(path):
        tmp = tempfile.mkdtemp(prefix="fig9_autotune_")
        path = os.path.join(tmp, "cache.json")
    try:
        with obs.session(obs.ObsConfig(enabled=True)), \
                _env(CACHE_ENV, path), _env("DPP_TILE_M", None):
            reg = obs.registry()
            built = "reused"
            if tmp is not None:
                # on the CPU the plain versions' host times choose nothing
                # that matters: the widest candidate and the model's do
                built = "swept"
                run_sweep(smoke_cases(), trials=min(trials, 3),
                          limit=(1 if dev.type != "cuda" else
                                 3 if fast_mode else None),
                          path=path, device=dev)
            misses0 = reg.counter("autotune_cache_misses_total").total()
            hits = 0
            for case in smoke_cases():
                hit, row = _case_row(case, dev, trials, tolerance, reg,
                                     failures)
                hits += hit
                rows.append(row)
            misses = (reg.counter("autotune_cache_misses_total").total()
                      - misses0)
            if hits < 1:
                failures.append(
                    "tile_m='auto' never hit the cache (autotune_cache_hits_"
                    "total unchanged): the figure measured the model "
                    "fallback")
            rows.append(("fig9_cache", float(hits),
                         f"cache={built};misses={int(misses)}"))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return rows, failures


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    rows, failures = run(fast_mode, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if failures:
        raise RuntimeError(f"fig9 autotune gate failures: {failures}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
