"""Seeded chaos schedules + delta-debugging shrinker.

Copy of ``symbolicregression_jl_tpu/utils/chaos.py`` over the port's
``utils/faults`` (the same 18 sites and grammar): the same ``(seed,
duration_s, hosts, net)`` gives the same :func:`schedule_spec` string in
both packages, and :func:`ddmin` the same subset on the same predicate.

A chaos *schedule* is just a tuple of :class:`~.faults.FaultRule` — the
same objects ``SR_FAULT_SPEC`` parses to — extended with one pseudo-site:

- ``kill`` — SIGKILL a rig process and respawn it. Params: ``host`` (which
  process), ``at_s`` (seconds into the soak), ``down_s`` (how long it
  stays dead). The ``@N`` count is a sequence number, not a call count.

Real fault sites carry a ``host`` param naming the rig process whose
``SR_FAULT_SPEC`` they join at (re)spawn; :func:`host_env_spec` strips it
when building that env string. Because the whole schedule round-trips
through :func:`~.faults.format_fault_spec` /
:func:`~.faults.parse_fault_spec`, a shrunk repro is ONE copy-pasteable
string in the grammar every drill already speaks — and "same seed ⇒
byte-identical schedule" reduces to string equality on
:func:`schedule_spec`.

:func:`generate_schedule` draws from ``random.Random(seed)`` only — no
wall clock, no os entropy — and always includes a coverage floor of one
``kill`` plus all four degradation sites (``disk_full``, ``kv_partition``,
``clock_skew``, ``oom_compile``), so EVERY seed composes process death
with resource exhaustion and a partition; extras are sampled on top.

:func:`ddmin` is classic Zeller delta debugging over schedule entries:
given a predicate that re-runs a (short) soak on a candidate subset, it
returns a 1-minimal failing subset — the soak emits it as the
repro when an invariant breaks.
"""

from __future__ import annotations

import random
from typing import Callable, Iterable, Sequence

from .faults import FAULT_SITES, FaultRule, format_fault_spec, parse_fault_spec

__all__ = [
    "KILL_SITE",
    "NET_HOST",
    "ddmin",
    "generate_schedule",
    "host_env_spec",
    "kill_events",
    "parse_schedule",
    "schedule_spec",
]

KILL_SITE = "kill"
NET_HOST = "net"  # rig name for the NetServer front-door process

# sites the rig's POD children exercise (journal/server/ckpt/store layers);
# net wire faults only fire inside the NetServer process
_POD_SITES = (
    "disk_full", "kv_partition", "clock_skew", "oom_compile",
    "worker_crash", "job_exception", "journal_torn_write", "ckpt_crash",
)
_NET_SITES = ("torn_frame", "net_drop", "slow_client")


def schedule_spec(rules: Iterable[FaultRule]) -> str:
    """Canonical string form of a schedule (the determinism contract)."""
    return format_fault_spec(rules)


def parse_schedule(spec: str) -> tuple[FaultRule, ...]:
    return parse_fault_spec(spec, extra_sites=(KILL_SITE,))


def _p(rule_params: dict) -> tuple:
    return tuple(sorted(rule_params.items()))


def generate_schedule(
    seed: int,
    duration_s: float,
    hosts: Sequence[str] = ("h0", "h1"),
    net: bool = True,
) -> tuple[FaultRule, ...]:
    """Deterministic multi-fault schedule for one soak.

    Coverage floor (every seed): one mid-soak ``kill`` of a pod host, and
    one rule for each degradation site. Extras: 2–5 more rules drawn
    from the pod pool (+ net pool when ``net``). All randomness flows from
    ``random.Random(seed)`` in a fixed draw order, so the same
    ``(seed, duration_s, hosts, net)`` yields a byte-identical
    :func:`schedule_spec` string on every machine."""
    rng = random.Random(int(seed))
    hosts = tuple(hosts)
    rules: list[FaultRule] = []
    kill_host = rng.choice(hosts)

    # --- coverage floor: kill + all four degradation sites --------------
    rules.append(FaultRule(KILL_SITE, 0, _p({
        "host": kill_host,
        "at_s": round(rng.uniform(0.3, 0.5) * duration_s, 2),
        "down_s": round(rng.uniform(2.0, 5.0), 2),
    })))
    rules.append(FaultRule("disk_full", rng.randrange(2, 9), _p({
        "host": rng.choice(hosts),
        "path": rng.choice(["journal", "ckpt", "both"]),
        "clear": 1,
    })))
    blocked_from = rng.choice(hosts)
    other = [h for h in hosts if h != blocked_from] or [blocked_from]
    rules.append(FaultRule("kv_partition", rng.randrange(10, 41), _p({
        "host": blocked_from,
        "block": rng.choice(other),
        "ops": rng.randrange(20, 61),
    })))
    rules.append(FaultRule("clock_skew", rng.randrange(5, 31), _p({
        "host": rng.choice(hosts),
        "offset_s": rng.choice([90, 180, 300]),
    })))
    rules.append(FaultRule("oom_compile", rng.randrange(0, 3), _p({
        "host": rng.choice(hosts),
    })))

    # --- sampled extras ------------------------------------------------------
    pool = list(_POD_SITES[4:])  # worker_crash/job_exception/torn_write/ckpt
    if net:
        pool += list(_NET_SITES)
    for _ in range(rng.randrange(2, 6)):
        site = rng.choice(pool)
        params: dict = {}
        if site in _NET_SITES:
            params["host"] = NET_HOST
            at = rng.randrange(0, 5)
            if site == "slow_client":
                params["delay_ms"] = rng.choice([100, 250, 500])
        else:
            params["host"] = rng.choice(hosts)
            at = rng.randrange(0, 7)
        rules.append(FaultRule(site, at, _p(params)))
    return tuple(rules)


def host_env_spec(rules: Iterable[FaultRule], host: str) -> str:
    """The ``SR_FAULT_SPEC`` string a rig process named ``host`` boots
    with: every non-kill rule addressed to it, ``host`` routing param
    stripped (inside the process, every armed rule applies)."""
    mine = []
    for r in rules:
        params = dict(r.params)
        if r.site == KILL_SITE or params.pop("host", None) != host:
            continue
        mine.append(FaultRule(r.site, r.at, _p(params)))
    return format_fault_spec(mine)


def kill_events(rules: Iterable[FaultRule]) -> list[dict]:
    """Kill pseudo-rules as dicts sorted by fire time:
    ``{"host", "at_s", "down_s"}``."""
    out = []
    for r in rules:
        if r.site == KILL_SITE:
            p = dict(r.params)
            out.append({
                "host": str(p.get("host", "h0")),
                "at_s": float(p.get("at_s", 0.0)),
                "down_s": float(p.get("down_s", 2.0)),
            })
    return sorted(out, key=lambda e: e["at_s"])


def ddmin(
    entries: Sequence[FaultRule],
    failing: Callable[[tuple[FaultRule, ...]], bool],
) -> tuple[FaultRule, ...]:
    """Zeller ddmin over schedule entries: return a 1-minimal subset for
    which ``failing`` still returns True (removing ANY single entry makes
    it pass). ``failing(full set)`` is assumed True by the caller (the
    breach was just observed); if the predicate is flaky and the full set
    no longer fails, the full set is returned unshrunk."""
    current = list(entries)
    if not failing(tuple(current)):
        return tuple(current)
    n = 2
    while len(current) >= 2:
        chunk = max(1, len(current) // n)
        subsets = [current[i:i + chunk] for i in range(0, len(current), chunk)]
        reduced = False
        for i in range(len(subsets)):
            complement = [
                e for j, s in enumerate(subsets) for e in s if j != i
            ]
            if complement and failing(tuple(complement)):
                current = complement
                n = max(2, n - 1)
                reduced = True
                break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), n * 2)
    return tuple(current)


def _check_sites() -> None:
    # the generator must only emit sites the injector will accept
    for site in _POD_SITES + _NET_SITES:
        if site not in FAULT_SITES:
            raise AssertionError(f"chaos pool references unknown site {site!r}")


_check_sites()
