"""Fault-tolerance policies: heartbeat tracking, straggler detection,
restart bookkeeping (the torch counterpart of
``repro.distributed.fault_tolerance``, line for line).

The policies are pure logic over reported timings/heartbeats so they are
unit-testable on one host and drop into a real multi-host launcher
unchanged: the launcher feeds real heartbeats instead of simulated ones.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    """Declares a host dead when its heartbeat is older than ``timeout``."""

    def __init__(self, n_hosts: int, timeout: float = 60.0, clock=time.monotonic):
        self.clock = clock
        self.timeout = timeout
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, clock()) for h in range(n_hosts)
        }

    def beat(self, host_id: int):
        st = self.hosts[host_id]
        st.last_heartbeat = self.clock()
        st.alive = True

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        out = []
        for st in self.hosts.values():
            if st.alive and now - st.last_heartbeat > self.timeout:
                st.alive = False
            if not st.alive:
                out.append(st.host_id)
        return out

    def alive_hosts(self) -> List[int]:
        self.dead_hosts()
        return [h for h, st in self.hosts.items() if st.alive]


class StragglerPolicy:
    """Flags hosts whose recent step time exceeds ``factor`` x the fleet
    median over a sliding window.  Mitigation in the launcher: exclude the
    straggler from the next re-mesh (it rejoins when healthy) — the
    standard "deadline + respawn" pattern."""

    def __init__(self, factor: float = 2.0, window: int = 8, min_samples: int = 3):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.times: Dict[int, List[float]] = {}

    def report(self, host_id: int, step_time: float):
        buf = self.times.setdefault(host_id, [])
        buf.append(step_time)
        del buf[: -self.window]

    def stragglers(self) -> List[int]:
        if len(self.times) < 2:
            return []
        medians = {}
        for h, buf in self.times.items():
            if len(buf) >= self.min_samples:
                s = sorted(buf)
                medians[h] = s[len(s) // 2]
        if len(medians) < 2:
            return []
        fleet = sorted(medians.values())[len(medians) // 2]
        return [h for h, m in medians.items() if m > self.factor * fleet]


@dataclasses.dataclass
class RestartBudget:
    """Crash-loop guard: at most ``max_restarts`` within ``horizon_s``."""

    max_restarts: int = 10
    horizon_s: float = 3600.0
    events: List[float] = dataclasses.field(default_factory=list)

    def record(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self.events.append(now)
        self.events = [t for t in self.events if now - t <= self.horizon_s]
        return len(self.events) <= self.max_restarts
