"""The port's fault-tolerance policies (``repro_torch.distributed.
fault_tolerance``) against ``repro``'s on the same scripted reports: the
heartbeat, straggler and restart-budget cases of ``repro``'s
``tests/test_distributed.py``, each run through both packages, which
must decide alike (pure logic: exact equality)."""
import pytest

from repro.distributed import fault_tolerance as jax_ft
from repro_torch.distributed import fault_tolerance as ft

PACKAGES = [ft, jax_ft]


def heartbeat(mod):
    t = [0.0]
    hb = mod.HeartbeatMonitor(n_hosts=3, timeout=10.0, clock=lambda: t[0])
    out = [hb.dead_hosts()]
    t[0] = 5.0
    hb.beat(0)
    hb.beat(1)
    t[0] = 12.0  # host 2 last beat at 0 -> dead
    out += [hb.dead_hosts(), hb.alive_hosts()]
    hb.beat(2)  # a beat revives it
    out += [hb.dead_hosts(), hb.alive_hosts()]
    return out


def straggler(mod):
    sp = mod.StragglerPolicy(factor=2.0, window=8, min_samples=3)
    out = [sp.stragglers()]
    for _ in range(6):
        for h in range(4):
            sp.report(h, 1.0 if h != 3 else 3.5)  # host 3 is 3.5x median
    out.append(sp.stragglers())
    for _ in range(8):  # host 3 recovers within the window
        for h in range(4):
            sp.report(h, 1.0)
    out.append(sp.stragglers())
    return out


def straggler_one_host(mod):
    sp = mod.StragglerPolicy()
    for _ in range(5):
        sp.report(0, 9.0)
    return [sp.stragglers(), sp.times]


def restart_budget(mod):
    rb = mod.RestartBudget(max_restarts=2, horizon_s=100.0)
    return [rb.record(now=0.0), rb.record(now=10.0),
            rb.record(now=20.0),  # 3rd within horizon -> crash-loop
            rb.record(now=200.0),  # old events expired
            list(rb.events)]


CASES = {
    "heartbeat": (heartbeat, [[], [2], [0, 1], [], [0, 1, 2]]),
    "straggler": (straggler, [[], [3], []]),
    "straggler_one_host": (straggler_one_host, [[], {0: [9.0] * 5}]),
    "restart_budget": (restart_budget, [True, True, False, True, [200.0]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_matches_repro(case):
    fn, expected = CASES[case]
    assert fn(ft) == fn(jax_ft) == expected


def test_host_state_fields_match_repro():
    a, b = ft.HostState(4, 1.5), jax_ft.HostState(4, 1.5)
    assert vars(a) == vars(b) == {"host_id": 4, "last_heartbeat": 1.5,
                                  "step_times": [], "alive": True}
