"""Measured tile choice for the dpp_greedy CUDA kernels (K3-K6); the
counterpart of ``repro.kernels.dpp_greedy.autotune``.

``TilePolicy``'s on-chip budget model answers "what *fits*": which tiles
keep a block within 227 KB of shared memory and, for the cooperative
chunk kernels, a grid the card keeps co-resident.  It cannot answer
"what is *fastest*": how many blocks of which width fill 132 SMs best
at a shape.  This module measures instead:

* **Sweep** (:func:`run_sweep`, ``python -m repro_torch.kernels.autotune``)
  — for each tiled family (the per-step sweeps K3 / K4 and the fused
  chunk kernels K5 / K6) over a small ``(D, M-bucket, rows, chunk,
  lanes)`` grid, time real dispatches for every candidate tile with
  CUDA events.  Candidates are the power-of-two warp multiples the
  model accepts at the case's lanes, plus the tile the model would
  choose itself, so the sweep can only persist geometries that fit; a
  candidate replaces the model's own tile only when it is faster by
  more than the timing noise (:data:`MODEL_MARGIN`).
* **Cache** (:class:`AutotuneCache`) — winners persist to a JSON
  document keyed by ``(device kind, platform, backend, D, M-bucket,
  state rows, windowed, chunked, lanes-bucket)`` with a schema version and atomic
  writes (tmp file + ``os.replace``).  ``M`` is bucketed to the next
  power of two (at least ``repro``'s 128, so both packages band an
  ``M`` alike), and so are the lanes (users) a launch carries: a tile
  timed on 4 lanes (256 blocks of K3 at 1024 columns) never answers a
  single request (64 blocks).  A one-lane key is ``repro``'s key.  The file lives outside any checkout: ``$DPP_AUTOTUNE_
  CACHE``, else ``$XDG_CACHE_HOME/repro_torch/dpp_autotune.json``,
  never ``repro``'s file.
* **Lookup ladder** (:func:`lookup_tile`, consulted by
  ``TilePolicy.decide`` for ``tile_m="auto"``) — exact key hit, then
  the nearest measured M-bucket with an otherwise identical key, then
  ``None`` (the caller keeps the model's answer).  Every rung checks the
  entry against the port's model at the queried shape: a warp multiple,
  a per-step block within ``tiled_smem_bytes``, a chunk block within
  ``chunk_smem_bytes`` whose grid of ``lanes * ceil(M / tile)`` blocks
  the card keeps co-resident.  A stale or hand-edited entry is a miss,
  never an over-budget or non-co-resident launch.  The ladder never
  raises: a missing file, another card or corrupt JSON is a recorded
  miss.

Every outcome lands in the dispatch telemetry
(``autotune_cache_hits_total{kind=exact|bucket}``,
``autotune_cache_misses_total{reason}`` and the ``autotune_tile_m``
gauge).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import tempfile
import time
import unicodedata
from typing import Callable, Iterable, Optional, Sequence

from repro_torch.kernels.dpp_greedy.tiling import (
    SMEM_BUDGET_BYTES,
    WARP,
    TilePolicy,
    chunk_smem_bytes,
    tile_count,
    tiled_smem_bytes,
)
from repro_torch.obs.dispatch import record_autotune_lookup

SCHEMA_VERSION = 1
CACHE_ENV = "DPP_AUTOTUNE_CACHE"

FAMILIES = ("step_exact", "step_windowed", "chunk_exact", "chunk_windowed")

# The smallest M-bucket: repro's 128-lane register width, so an M falls
# in the same band in both packages' caches.
BUCKET_FLOOR = 128
# The fingerprint of the plain versions on the CPU (they launch no grid,
# so a tile only decides the argmax fold's blocking there).
CPU_FINGERPRINT = ("cpu", "cpu", "plain")
EPS = 1e-6  # the sweep's eps: no case stops early
# A candidate replaces the model's own tile only when it is this much
# faster: at one lane the card's tiles of 256-1024 columns time within a
# few percent of each other and their order changes from run to run
# (PERF.md, §6), so a smaller gain is noise, not a better tile.
MODEL_MARGIN = 0.05


# ---------------------------------------------------------------------------
# Cache path, keying, bucketing
# ---------------------------------------------------------------------------


def default_cache_path() -> str:
    """``$XDG_CACHE_HOME``-respecting per-user default, outside any source
    tree so a tuned machine never dirties a checkout, and apart from
    ``repro``'s file."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "repro_torch", "dpp_autotune.json")


def active_cache_path() -> str:
    """The cache file every lookup and sweep uses: ``$DPP_AUTOTUNE_CACHE``
    when set, else :func:`default_cache_path`."""
    return os.environ.get(CACHE_ENV) or default_cache_path()


def bucket_m(M: int) -> int:
    """Smallest power of two >= ``max(M, BUCKET_FLOOR)``: monotone in
    ``M``, so one measured bucket covers every width that pads into it."""
    if M < 1:
        raise ValueError(f"M must be >= 1, got {M}")
    b = BUCKET_FLOOR
    while b < M:
        b <<= 1
    return b


def lanes_bucket(lanes: int) -> int:
    """Smallest power of two >= ``lanes``: the band of batch sizes one
    measured tile answers (1, 2, 4, 8, ...)."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    return 1 << (int(lanes) - 1).bit_length()


def _norm_field(value: object) -> str:
    """Normalise a free-text key field (device kind etc.): compatibility
    forms folded (NFKC), case folded, trimmed, whitespace runs and the
    ``|`` delimiter turned into ``-``, so no field can smuggle a delimiter
    into the key.  The case fold goes through the upper case first and
    NFKC again after it, so a field keys alike in every case: ``'µ'``
    (the micro sign) and its upper case ``'Μ'`` both fold to ``'μ'``,
    where a plain ``.lower()`` keeps them apart."""
    s = unicodedata.normalize("NFKC", str(value))
    s = unicodedata.normalize("NFKC", s.upper()).casefold()
    s = " ".join(unicodedata.normalize("NFKC", s).split())
    return s.replace("|", "-").replace(" ", "-") or "unknown"


@functools.lru_cache(maxsize=4096)
def cache_key(
    device_kind: object,
    platform: object,
    backend: object,
    D: int,
    M_bucket: int,
    state_rows: int,
    windowed: bool,
    chunked: bool,
    lanes: int = 1,
) -> str:
    """Normalised pipe-joined cache key (``repro``'s layout, one lane),
    with ``|l<lanes bucket>`` after it past one lane
    (:func:`lanes_bucket`).  The structured fields are stored on the
    entry too, and the nearest-bucket rung recomputes the key from them.
    Memoized: a dispatch under ``"auto"`` keys its lookup on every
    call."""
    fields = [
        _norm_field(device_kind),
        _norm_field(platform),
        _norm_field(backend),
        f"d{int(D)}",
        f"m{int(M_bucket)}",
        f"r{int(state_rows)}",
        "w1" if windowed else "w0",
        "c1" if chunked else "c0",
    ]
    lb = lanes_bucket(lanes)
    if lb > 1:
        fields.append(f"l{lb}")
    return "|".join(fields)


@functools.lru_cache(maxsize=64)
def device_fingerprint(device=None) -> tuple[str, str, str]:
    """``(device kind, platform, backend)`` of the device the kernels run
    on.  On a card: its name, ``"cuda"``, and its compute capability with
    the port's kernel family (``"sm_90a-cuda"``: the CUDA kernels built
    for that target); on the CPU :data:`CPU_FINGERPRINT`.  ``device``
    None is the card when there is one.  Memoized per device."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_FINGERPRINT
    index = torch.cuda.current_device() if dev.index is None else dev.index
    major, minor = torch.cuda.get_device_capability(index)
    return (torch.cuda.get_device_name(index), "cuda",
            f"sm_{major}{minor}a-cuda")


# ---------------------------------------------------------------------------
# Persisted cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutotuneCache:
    """In-memory view of one persisted autotune cache file."""

    path: str
    entries: dict[str, dict]
    corrupt: bool = False  # the file existed but did not parse/validate
    # lookup_tile's answers on these entries, by query
    answers: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @classmethod
    def load(cls, path: str) -> "AutotuneCache":
        """Load a cache file.  Never raises: a missing file is an empty
        cache, an unreadable or foreign-schema file an empty cache with
        ``corrupt=True`` (the lookup ladder records the miss reason)."""
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return cls(path, {})
        except (OSError, UnicodeDecodeError, ValueError):
            return cls(path, {}, corrupt=True)
        if (
            not isinstance(doc, dict)
            or doc.get("schema") != SCHEMA_VERSION
            or not isinstance(doc.get("entries"), dict)
        ):
            return cls(path, {}, corrupt=True)
        return cls(path, doc["entries"])

    def put(
        self,
        *,
        D: int,
        M_bucket: int,
        state_rows: int,
        windowed: bool,
        chunked: bool,
        tile_m: int,
        best_us: float,
        candidates: dict[int, float],
        plain: bool,
        lanes: int = 1,
        device: Optional[tuple[str, str, str]] = None,
    ) -> str:
        """Store one sweep winner (``plain``: timed on the plain versions
        on the CPU; ``lanes``: the lanes it was timed at, stored as their
        bucket, which the key carries); returns its key."""
        self.answers.clear()
        dk, plat, backend = device or device_fingerprint()
        key = cache_key(
            dk, plat, backend, D, M_bucket, state_rows, windowed, chunked,
            lanes,
        )
        self.entries[key] = {
            "device_kind": dk,
            "platform": plat,
            "backend": backend,
            "D": int(D),
            "M_bucket": int(M_bucket),
            "state_rows": int(state_rows),
            "windowed": bool(windowed),
            "chunked": bool(chunked),
            "tile_m": int(tile_m),
            "best_us": float(best_us),
            "candidates": {str(t): float(us) for t, us in candidates.items()},
            "plain": bool(plain),
            "lanes": lanes_bucket(lanes),
        }
        return key

    def save(self) -> None:
        """Atomic write: serialise to a tmp file in the destination
        directory, then ``os.replace`` — a concurrent reader sees the old
        document or the new one, never a torn write."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        doc = {"schema": SCHEMA_VERSION, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(prefix=".dpp_autotune.", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        finally:
            _STAMPS.pop(self.path, None)


# How long a read of the cache file's stamp is trusted: a stat is one
# syscall, and on the H100 host one stat a dispatch doubled figure 9's
# sub-millisecond calls (PERF.md, §6), so a steady serving loop reads
# it at most once a second.
STAMP_TTL_S = 1.0
# the last stamp read for each cache path, with the time it was read
_STAMPS: dict[str, tuple[float, tuple]] = {}
_clock = time.monotonic  # the stamp's clock (tests give it a fake one)


def cache_stamp(path: Optional[str] = None):
    """``(path, inode, mtime_ns, size)`` of the cache file (``None`` for
    the rest when it is missing): what a parsed cache is keyed on, so
    none outlives a rewrite of the file (every save replaces it, so the
    inode changes even within one tick of the file clock).  The file is
    stat'ed again once :data:`STAMP_TTL_S` has passed since the last
    read, so another process's rewrite is seen within that time; a save
    through :class:`AutotuneCache` in this process is seen at once."""
    path = path or active_cache_path()
    now = _clock()
    hit = _STAMPS.get(path)
    if hit is not None and now - hit[0] < STAMP_TTL_S:
        return hit[1]
    try:
        st = os.stat(path)
        stamp = (path, st.st_ino, st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = (path, None, None, None)
    _STAMPS[path] = (now, stamp)
    return stamp


# one parsed cache per stamp (cache_stamp): dispatch consults the ladder
# on every "auto" decision, so a lookup must not re-read the file
_LOAD_MEMO: dict[str, tuple[tuple, AutotuneCache]] = {}


def _load_memoized(path: str) -> AutotuneCache:
    stamp = cache_stamp(path)
    hit = _LOAD_MEMO.get(path)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    cache = AutotuneCache.load(path)
    _LOAD_MEMO[path] = (stamp, cache)
    return cache


# ---------------------------------------------------------------------------
# Lookup ladder (TilePolicy.decide's tile_m="auto" rung)
# ---------------------------------------------------------------------------


def tile_fits(tile_m: int, D: int, M: int, state_rows: int, windowed: bool,
              chunked: bool, lanes: int = 1,
              capacity: Optional[Callable[[int], int]] = None) -> bool:
    """Whether the port's model accepts ``tile_m`` at this shape: a warp
    multiple; per step (K3 / K4) a block within ``tiled_smem_bytes``;
    for the chunk kernels (K5 / K6) a block of ``min(tile_m, M)`` columns
    within ``chunk_smem_bytes`` with V streamed, whose grid of ``lanes *
    ceil(M / tile_m)`` blocks stays within ``capacity(smem)`` (the card's
    co-residency, ``tiled.chunk_capacity``; None on the CPU, where the
    plain versions launch no grid)."""
    if (not isinstance(tile_m, int) or isinstance(tile_m, bool)
            or tile_m < WARP or tile_m % WARP != 0):
        return False
    if not chunked:
        return tiled_smem_bytes(D, state_rows, windowed) <= SMEM_BUDGET_BYTES
    cols = min(tile_m, M)
    smem = chunk_smem_bytes(D, cols, state_rows, windowed)
    if smem > SMEM_BUDGET_BYTES:
        return False
    return capacity is None or lanes * tile_count(M, cols) <= capacity(smem)


def _entry_tile(entry: object, D: int, M: int, state_rows: int,
                windowed: bool, chunked: bool, lanes: int,
                capacity) -> Optional[int]:
    """The entry's tile iff :func:`tile_fits` accepts it at the queried
    shape: a stale or hand-edited entry is a miss, never a bad launch."""
    if not isinstance(entry, dict):
        return None
    tm = entry.get("tile_m")
    if not tile_fits(tm, D, M, state_rows, windowed, chunked, lanes,
                     capacity):
        return None
    return tm


def lookup_tile(
    *,
    D: int,
    M: int,
    state_rows: int,
    windowed: bool,
    chunked: bool,
    lanes: int = 1,
    capacity: Optional[Callable[[int], int]] = None,
    device=None,
    path: Optional[str] = None,
) -> Optional[int]:
    """Measured tile for this card, shape and lanes bucket, or ``None``
    (keep the model's answer).  Exact hit first, then the nearest
    measured M-bucket with an otherwise identical key (the lanes bucket
    included: a tile timed at other lanes is never served); both rungs
    re-check the entry with :func:`tile_fits` at ``lanes`` and
    ``capacity``.  Never raises.
    The answer is memoized on the parsed cache (so until the file
    changes); every call records its outcome."""
    try:
        cache = _load_memoized(path or active_cache_path())
        query = (D, M, state_rows, windowed, chunked, lanes, capacity, device)
        ans = cache.answers.get(query)
        if ans is None:
            if len(cache.answers) >= 1024:
                cache.answers.clear()
            ans = cache.answers[query] = _ladder(cache, *query)
        outcome, reason, tm = ans
        record_autotune_lookup(outcome, reason=reason, tile_m=tm)
        return tm
    except Exception:
        record_autotune_lookup("miss", reason="error")
        return None


def _ladder(cache: AutotuneCache, D, M, state_rows, windowed, chunked,
            lanes, capacity, device) -> tuple[str, str, Optional[int]]:
    """:func:`lookup_tile`'s rungs on one parsed cache: ``(outcome,
    miss reason, tile)``."""
    if cache.corrupt:
        return "miss", "corrupt", None
    if not cache.entries:
        return "miss", "empty", None
    dk, plat, backend = device_fingerprint(device)
    mb, lb = bucket_m(M), lanes_bucket(lanes)
    key = cache_key(dk, plat, backend, D, mb, state_rows, windowed, chunked,
                    lb)
    tm = _entry_tile(cache.entries.get(key), D, M, state_rows, windowed,
                     chunked, lanes, capacity)
    if tm is not None:
        return "exact", "", tm
    # nearest bucket: same card, (D, R, windowed, chunked) and lanes
    # bucket (an entry without one is repro's, one lane), another
    # M-bucket, closest in log2(M); the key recomputed from the entry's
    # own bucket must reproduce the stored key, which also screens out
    # hand-edited field/key divergence
    best: Optional[tuple[float, int, int]] = None
    for k2, e2 in cache.entries.items():
        if not isinstance(e2, dict):
            continue
        mb2 = e2.get("M_bucket")
        if (not isinstance(mb2, int) or mb2 < 1 or mb2 == mb
                or e2.get("lanes", 1) != lb):
            continue
        if k2 != cache_key(dk, plat, backend, D, mb2, state_rows, windowed,
                           chunked, lb):
            continue
        t2 = _entry_tile(e2, D, M, state_rows, windowed, chunked, lanes,
                         capacity)
        if t2 is None:
            continue
        dist = abs(math.log2(mb2) - math.log2(mb))
        if best is None or (dist, mb2) < best[:2]:
            best = (dist, mb2, t2)
    if best is not None:
        return "bucket", "", best[2]
    return "miss", "no_entry", None


# ---------------------------------------------------------------------------
# Measurement sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One tuned geometry: a kernel family at a concrete ``(D, M,
    state_rows[, chunk])`` over ``lanes`` users.  ``M`` is measured at
    its bucket; the entry answers every batch in the lanes' bucket.  Exact cases run ``k = state_rows`` steps, windowed ones
    ``window = state_rows`` and ``k = 2 * state_rows`` (the ring fills,
    then evicts), as ``repro``'s sweep does."""

    family: str
    D: int
    M: int
    state_rows: int
    chunk: int = 8
    lanes: int = 1

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown family {self.family!r}; expected one of {FAMILIES}"
            )
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")

    @property
    def windowed(self) -> bool:
        return self.family.endswith("windowed")

    @property
    def chunked(self) -> bool:
        return self.family.startswith("chunk")

    @property
    def k(self) -> int:
        return 2 * self.state_rows if self.windowed else self.state_rows

    @property
    def window(self) -> Optional[int]:
        return self.state_rows if self.windowed else None


def model_tile(D: int, M: int, state_rows: int, windowed: bool,
               chunked: bool, lanes: int = 1, capacity=None) -> Optional[int]:
    """The tile the model itself chooses at this shape: per step its
    tiled answer (``None`` where it stays resident); for the chunk
    kernels the columns of one tile (``M`` for one whole-M tile a lane,
    the V-resident split where it finds one)."""
    ans = TilePolicy().decide(D, M, state_rows, windowed, chunked, lanes,
                              capacity)
    if chunked:
        return M if ans[0] == "resident" else min(ans[1], M)
    return ans[1]


def candidate_tiles(
    D: int,
    state_rows: int,
    windowed: bool,
    chunked: bool,
    M_bucket: int,
    *,
    lanes: int = 1,
    capacity: Optional[Callable[[int], int]] = None,
    limit: Optional[int] = None,
) -> list[int]:
    """Power-of-two warp multiples up to the bucket that :func:`tile_fits`
    accepts at ``lanes`` (and the card's ``capacity``), the widest
    ``limit`` of them when given, and always the model's own tile
    (:func:`model_tile`), ascending."""
    tiles = []
    t = WARP
    while t <= M_bucket:
        if tile_fits(t, D, M_bucket, state_rows, windowed, chunked, lanes,
                     capacity):
            tiles.append(t)
        t <<= 1
    if limit is not None and limit > 0:
        tiles = tiles[-limit:]
    own = model_tile(D, M_bucket, state_rows, windowed, chunked, lanes,
                     capacity)
    if own is not None:
        tiles.append(own)
    return sorted(set(tiles))


def case_inputs(case: SweepCase, device):
    """Deterministic inputs at the case's bucketed M: ``(lanes, D, Mb)``
    float32, normalised features times a relevance in [1, 2) (one lane:
    ``repro``'s recipe, the same numbers)."""
    import numpy as np
    import torch

    Mb = bucket_m(case.M)
    rng = np.random.default_rng(0)
    F = rng.normal(size=(case.lanes, case.D, Mb)).astype(np.float32)
    F /= np.maximum(np.linalg.norm(F, axis=1, keepdims=True), 1e-12)
    rel = 1.0 + rng.uniform(size=(case.lanes, 1, Mb)).astype(np.float32)
    return torch.from_numpy(F * rel).to(device)


def event_timer(prepare: Callable[[], Callable[[], object]]) -> float:
    """Seconds of one ``prepare()()`` on the card between two CUDA events
    (``prepare`` runs before the first, outside the clock)."""
    import torch

    fn = prepare()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def wall_timer(prepare: Callable[[], Callable[[], object]]) -> float:
    """Host seconds of one ``prepare()()`` on the CPU (the plain
    versions)."""
    fn = prepare()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def case_runner(case: SweepCase, V, tile_policy: TilePolicy):
    """``prepare() -> fn``: one whole dispatch of the case's family under
    ``tile_policy`` — a whole slate of K3 / K4 steps, or one chunk of K5 /
    K6 on a fresh state (built by ``prepare``, outside the clock)."""
    from repro_torch.kernels.dpp_greedy.ops import (
        dpp_greedy,
        dpp_greedy_stream_chunk,
        dpp_greedy_stream_init,
    )

    if not case.chunked:
        return lambda: lambda: dpp_greedy(  # noqa: E731
            V, case.k, eps=EPS, window=case.window, tile_policy=tile_policy)

    def prepare():
        state = dpp_greedy_stream_init(V, case.k, window=case.window,
                                       tile_policy=tile_policy)
        return lambda: dpp_greedy_stream_chunk(
            V, state, case.chunk, eps=EPS, tile_policy=tile_policy)

    return prepare


def _time_case(case: SweepCase, V, tile: int, trials: int, timer) -> float:
    """Best-of-``trials`` seconds of one dispatch at ``TilePolicy(tile_m=
    tile)`` after one warm call (builds and loads stay outside the
    clock).  The policy object bypasses ``DPP_TILE_M`` and the cache, so
    the environment being tuned cannot steer what is measured."""
    prepare = case_runner(case, V, TilePolicy(tile_m=tile))
    prepare()()  # build, load, warm
    return min(timer(prepare) for _ in range(max(trials, 1)))


def run_sweep(
    cases: Sequence[SweepCase],
    *,
    trials: int = 3,
    limit: Optional[int] = None,
    path: Optional[str] = None,
    device="cuda",
    timer: Optional[Callable] = None,
    log=None,
) -> tuple[list[dict], str]:
    """Measure every case on ``device`` (the card by default; a sweep
    that cannot launch raises), persist the winners, merged into what
    the cache file already holds (a corrupt file is replaced), and
    return ``([{case, key, tile_m, best_us, candidates}, ...], path)``.
    The winner is the fastest candidate, or the model's own tile unless
    the fastest beats it by :data:`MODEL_MARGIN`.
    ``timer(prepare) -> seconds`` times one dispatch (default: CUDA
    events on a card, the host clock on the CPU)."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.dpp_greedy.tiled import capacity_fn

    dev = resolve_device(device)
    path = path or active_cache_path()
    cache = AutotuneCache.load(path)
    if cache.corrupt:
        cache = AutotuneCache(path, {})
    fingerprint = device_fingerprint(dev)
    timer = timer or (event_timer if dev.type == "cuda" else wall_timer)
    results: list[dict] = []
    for case in cases:
        Mb = bucket_m(case.M)
        capacity = capacity_fn(case.windowed, dev) if case.chunked else None
        tiles = candidate_tiles(
            case.D, case.state_rows, case.windowed, case.chunked, Mb,
            lanes=case.lanes, capacity=capacity, limit=limit)
        V = case_inputs(case, dev)
        cand: dict[int, float] = {}
        for t in tiles:
            cand[t] = _time_case(case, V, t, trials, timer)
            if log is not None:
                log(f"#   {case.family} D={case.D} M={Mb} "
                    f"R={case.state_rows} lanes={case.lanes} tile={t}: "
                    f"{cand[t] * 1e6:.1f} us")
        del V
        best_tile = min(cand, key=lambda t: (cand[t], t))
        own = model_tile(case.D, Mb, case.state_rows, case.windowed,
                         case.chunked, case.lanes, capacity)
        if own in cand and cand[best_tile] > cand[own] * (1 - MODEL_MARGIN):
            best_tile = own
        key = cache.put(
            D=case.D, M_bucket=Mb, state_rows=case.state_rows,
            windowed=case.windowed, chunked=case.chunked, tile_m=best_tile,
            best_us=cand[best_tile] * 1e6, candidates=cand,
            plain=dev.type != "cuda", lanes=case.lanes, device=fingerprint,
        )
        results.append({
            "case": case, "key": key, "tile_m": best_tile,
            "best_us": cand[best_tile] * 1e6,
            "candidates": {t: s * 1e6 for t, s in cand.items()},
        })
    cache.save()
    return results, path


def smoke_cases() -> list[SweepCase]:
    """One past-the-resident-budget geometry per family, ``repro``'s grid
    (D = 64, M = 65,536, 16 exact / 8 windowed rows, chunk 8): a
    ``tile_m="auto"`` dispatch at these shapes consults the cache
    (``figures.fig9_autotune --smoke`` evaluates exactly this grid)."""
    D, M = 64, 65536
    return [
        SweepCase("step_exact", D, M, state_rows=16),
        SweepCase("step_windowed", D, M, state_rows=8),
        SweepCase("chunk_exact", D, M, state_rows=16, chunk=8),
        SweepCase("chunk_windowed", D, M, state_rows=8, chunk=8),
    ]


def serving_cases() -> list[SweepCase]:
    """The port's large-pool serving shape (``chip_smoke.py`` phases 3, 4
    and 8: D = 100, C = 65,536, B = 4 users; exact k = 50, windowed w =
    10 with k = 200, chunk 16), and a single request (B = 1) of that
    pool through K3 / K4."""
    D, M, B = 100, 65536, 4
    return [
        SweepCase("step_exact", D, M, state_rows=50, lanes=B),
        SweepCase("step_windowed", D, M, state_rows=10, lanes=B),
        SweepCase("chunk_exact", D, M, state_rows=50, chunk=16, lanes=B),
        SweepCase("chunk_windowed", D, M, state_rows=10, chunk=16, lanes=B),
        SweepCase("step_exact", D, M, state_rows=50),
        SweepCase("step_windowed", D, M, state_rows=10),
    ]


def full_cases() -> list[SweepCase]:
    """The full preset: ``repro``'s (D, M-bucket, rows, chunk) grid
    around the serving shapes, plus :func:`serving_cases`."""
    cases = []
    for D in (32, 64, 128):
        for M in (65536, 131072):
            for R in (8, 16):
                cases.append(SweepCase("step_exact", D, M, state_rows=R))
                cases.append(SweepCase("step_windowed", D, M, state_rows=R))
                for chunk in (8, 16):
                    cases.append(SweepCase(
                        "chunk_exact", D, M, state_rows=R, chunk=chunk))
                    cases.append(SweepCase(
                        "chunk_windowed", D, M, state_rows=R, chunk=chunk))
    return cases + serving_cases()


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Measure the dpp_greedy kernels' tiles on this card "
                    "and persist the winners for tile_m='auto'.",
    )
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true",
                      help="one geometry per kernel family, the widest 3 "
                           "candidates and the model's own, 1 trial (the "
                           "default)")
    size.add_argument("--full", action="store_true",
                      help="the full (D, M-bucket, rows, chunk) grid and "
                           "the serving shapes, every candidate")
    ap.add_argument("--out", default=None,
                    help="cache file (default: $DPP_AUTOTUNE_CACHE or "
                         "~/.cache/repro_torch/dpp_autotune.json)")
    ap.add_argument("--trials", type=int, default=None,
                    help="timing trials per candidate (default 1 smoke, "
                         "3 full)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu times the plain versions (no card)")
    args = ap.parse_args(list(argv) if argv is not None else None)

    smoke = not args.full
    cases = smoke_cases() if smoke else full_cases()
    trials = args.trials if args.trials is not None else (1 if smoke else 3)

    print("name,us_per_call,derived")
    results, path = run_sweep(
        cases, trials=trials, limit=3 if smoke else None, path=args.out,
        device=args.device, log=print,
    )
    for r in results:
        case = r["case"]
        cand = ";".join(f"{t}:{us:.1f}us"
                        for t, us in sorted(r["candidates"].items()))
        print(
            f"autotune_{case.family}_D{case.D}_M{bucket_m(case.M)}"
            f"_R{case.state_rows}_B{case.lanes},{r['best_us']:.1f},"
            f"tile_m={r['tile_m']};candidates={cand}"
        )
    print(f"# wrote {len(results)} entr{'y' if len(results) == 1 else 'ies'}"
          f" -> {path}")
    return 0
