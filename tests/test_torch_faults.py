"""The port's fault injection (``utils/faults.py``) against the JAX package's.

Specs parse and format to the same rules in both packages for every one of
the 18 sites, malformed specs raise in both, an injector fires at the same
call counts, the ``SR_FAULT_SPEC`` injector follows the variable, and a
skewed clock holds each host's offset. The five sites of the exchange and
membership modules (``exchange_timeout``, ``peer_join``, ``kv_flap``,
``slow_peer``, ``kv_partition``) fire at the JAX package's points, with
the same effect, on each package's ``ExchangeGroup`` or store. Pure Python
on both sides.
"""

import time

import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.utils import faults as jf
from symbolicregression_jl_tpu_torch.utils import faults as tf

# one spec per site (with the parameters each site reads), plus compound and
# spaced forms
SPECS = [
    "exchange_timeout@0:peer=1",
    "peer_death@3:mode=raise,code=7",
    "ckpt_crash@1:mode=exit,code=44",
    "nan_flood@2:frac=0.9",
    "peer_join@1:defer_ms=500",
    "kv_flap@2",
    "slow_peer@0:delay_ms=250",
    "worker_crash@4",
    "job_exception@0",
    "journal_torn_write@1",
    "stall@0:delay_s=0.5",
    "net_drop@3",
    "slow_client@0:delay_ms=10",
    "torn_frame@2",
    "disk_full@2:clear=1,path=journal",
    "oom_compile@0:kind=fleet_aot",
    "clock_skew@3:host=h1,offset_s=120",
    "kv_partition@5:block=h0|h1,ops=40",
    "nan_flood@2:frac=0.9;ckpt_crash@1;peer_death@3:mode=raise,code=7",
    " nan_flood @ 1 : frac = 0.5 ; ; disk_full@0:path=ckpt ",
]

MALFORMED = ["gremlin@1", "nan_flood", "nan_flood@x", "nan_flood@1:frac", "nan_flood@-1",
             "@1", "nan_flood@1:=3"]


def _rules(rules):
    return [(r.site, r.at, r.params) for r in rules]


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for mod in (jf, tf):  # never leak an armed injector into other tests
        mod.install(None)
        mod.reset_env_injector()


def test_fault_sites_match_jax():
    assert tf.FAULT_SITES == jf.FAULT_SITES and len(tf.FAULT_SITES) == 18
    assert {s.split("@")[0] for s in SPECS[:18]} == set(tf.FAULT_SITES)


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_parse_and_format_match_jax(spec):
    got, want = tf.parse_fault_spec(spec), jf.parse_fault_spec(spec)
    assert _rules(got) == _rules(want) and got
    assert tf.format_fault_spec(got) == jf.format_fault_spec(want)
    assert tf.parse_fault_spec(tf.format_fault_spec(got)) == got


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        jf.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        tf.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        T.Options(device="cpu", fault_spec=bad)
    with pytest.raises(ValueError):
        J.Options(fault_spec=bad)


def test_extra_sites_admit_pseudo_sites_in_both():
    spec = "kill@0:at_s=12.5,host=h0"
    assert _rules(tf.parse_fault_spec(spec, extra_sites=("kill",))) == _rules(
        jf.parse_fault_spec(spec, extra_sites=("kill",)))
    with pytest.raises(ValueError):
        tf.parse_fault_spec(spec)


def test_options_accept_every_site():
    for spec in SPECS:
        assert T.Options(device="cpu", fault_spec=spec).fault_spec == spec


def test_injector_fires_at_the_same_counts():
    spec = "nan_flood@2:frac=0.5;nan_flood@4;peer_death@1:mode=raise;kv_flap@0"
    ti = tf.FaultInjector(tf.parse_fault_spec(spec))
    ji = jf.FaultInjector(jf.parse_fault_spec(spec))
    sites = ["nan_flood", "peer_death", "kv_flap", "ckpt_crash"]
    for site in sites:
        assert ti.armed(site) == ji.armed(site)
    calls = [sites[(k * 7) % 4] for k in range(24)]
    got = [ti.fire(s) for s in calls]
    assert got == [ji.fire(s) for s in calls]
    assert sum(h is not None for h in got) == 4
    assert tf.FaultInjector().fire("nan_flood") is None


def test_maybe_die_raises_in_raise_mode():
    inj = tf.FaultInjector(tf.parse_fault_spec("peer_death@1:mode=raise"))
    inj.maybe_die("peer_death")
    with pytest.raises(tf.FaultInjected, match="injected peer_death"):
        inj.maybe_die("peer_death")
    inj.maybe_die("peer_death")
    assert issubclass(tf.CheckpointWriteCrash, tf.FaultInjected)
    assert str(tf.ResourceExhaustedInjected("fleet_aot", 3)) == str(
        jf.ResourceExhaustedInjected("fleet_aot", 3))


def test_install_takes_precedence_and_resets_counts(monkeypatch):
    monkeypatch.setenv("SR_FAULT_SPEC", "stall@0")
    inj = tf.install("nan_flood@1")
    assert tf.active() is inj and inj.armed("nan_flood") and not inj.armed("stall")
    assert inj.fire("nan_flood") is None
    again = tf.install("nan_flood@1")
    assert again.fire("nan_flood") is None and again.fire("nan_flood") == {}
    tf.install(None)
    assert tf.active().armed("stall")


def test_env_injector_follows_sr_fault_spec(monkeypatch):
    for mod in (tf, jf):
        mod.install(None)
        monkeypatch.setenv("SR_FAULT_SPEC", "stall@0")
        assert mod.active().armed("stall")
        monkeypatch.setenv("SR_FAULT_SPEC", "nan_flood@1:frac=0.5")
        inj = mod.active()
        assert inj.armed("nan_flood") and not inj.armed("stall")
        assert inj is mod.active()  # unchanged spec: same injector, counts live
        assert inj.fire("nan_flood") is None and inj.fire("nan_flood") == {"frac": 0.5}
        monkeypatch.delenv("SR_FAULT_SPEC")
        assert not mod.active().armed("nan_flood")
        monkeypatch.setenv("SR_FAULT_SPEC", "nan_flood@1:frac=0.5")
        mod.reset_env_injector()
        assert mod.active() is not inj  # counts restart


def test_skewed_time_holds_each_hosts_offset():
    tf.install("clock_skew@1:host=h0,offset_s=500")
    assert abs(tf.skewed_time("h0") - time.time()) < 5.0  # count 0: no fire yet
    assert tf.skewed_time("h0") - time.time() > 400.0  # count 1: fires and latches
    assert tf.skewed_time("h0") - time.time() > 400.0  # latched
    tf.install("clock_skew@0:host=h0,offset_s=500")
    assert abs(tf.skewed_time("h1") - time.time()) < 5.0  # another host never skews
    assert abs(tf.skewed_time("h1") - time.time()) < 5.0
    tf.install("clock_skew@0:offset_s=-300")  # no host: every host skews
    assert tf.skewed_time("h7") - time.time() < -250.0
    tf.install(None)
    assert abs(tf.skewed_time("h0") - time.time()) < 5.0


# -- the exchange and membership sites fire at JAX's points -------------------


def _pkgs():
    from symbolicregression_jl_tpu.parallel import distributed as jd
    from symbolicregression_jl_tpu.parallel import membership as jm
    from symbolicregression_jl_tpu_torch.parallel import distributed as td
    from symbolicregression_jl_tpu_torch.parallel import membership as tm

    return {"jax": (jf, jd, jm), "torch": (tf, td, tm)}


def _group(pkg, root, my_id, world, **kw):
    faults, dist, mem = _pkgs()[pkg]
    return mem.ExchangeGroup(mem.FileCoordStore(root), "f", my_id, world,
                             start_heartbeat=False, **kw)


def test_exchange_timeout_names_the_peer_in_both(tmp_path, monkeypatch):
    """``exchange_timeout`` at the gather: the peer is missing at once, and
    the raised error is the same text in both packages."""
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "60000")
    import numpy as np

    msgs = {}
    for pkg, (faults, dist, _) in _pkgs().items():
        faults.install("exchange_timeout@0:peer=1")
        g = _group(pkg, str(tmp_path / pkg), 0, 2)
        t0 = time.monotonic()
        with pytest.raises(dist.PeerLossError) as ei:
            g.allgather((np.asarray([0]),))
        assert time.monotonic() - t0 < 30.0  # not the 60 s deadline's wait
        assert ei.value.missing == (1,) and ei.value.attempts == 1  # its own post
        msgs[pkg] = str(ei.value)
        faults.install(None)
    assert msgs["jax"] == msgs["torch"]


def test_kv_flap_costs_one_poll_attempt_in_both(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "10")
    got = {}
    for pkg, (faults, _, _) in _pkgs().items():
        g = _group(pkg, str(tmp_path / pkg), 0, 2)
        g.store.set("k", b"vv")
        faults.install("kv_flap@0;kv_flap@2")
        first = g._read_peer("k", time.monotonic() + 5.0)
        second = g._read_peer("k", time.monotonic() + 5.0)
        faults.install(None)
        got[pkg] = (first, second)
    assert got["jax"] == got["torch"] == ((b"vv", 2), (b"vv", 2))


def test_slow_peer_delays_the_post_in_both(tmp_path):
    import numpy as np

    for pkg, (faults, _, _) in _pkgs().items():
        g = _group(pkg, str(tmp_path / pkg), 0, 1)
        faults.install("slow_peer@1:delay_ms=300")
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            g.allgather((np.asarray([1]),))
            times.append(time.monotonic() - t0)
        faults.install(None)
        assert times[1] >= 0.28 and times[0] < 0.28 and times[2] < 0.28, (pkg, times)


def test_peer_join_defers_the_announcement_in_both(tmp_path):
    for pkg, (faults, _, _) in _pkgs().items():
        g = _group(pkg, str(tmp_path / pkg), 1, 2, on_peer_loss="rejoin")
        faults.install("peer_join@0:defer_ms=300")
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="not admitted"):
            g.join(timeout_ms=50)
        faults.install(None)
        assert time.monotonic() - t0 >= 0.3
        assert g.store.try_get(g._join_key(1)) is not None


def test_kv_partition_severs_and_heals_alike(tmp_path):
    """One sequence of store operations under ``kv_partition`` on each
    package's ``PartitionedCoordStore``: the same reads, refusals and
    partition stats."""
    seen = {}
    for pkg, (faults, _, mem) in _pkgs().items():
        inner = mem.FileCoordStore(str(tmp_path / pkg))
        inner.set("srpod/p/ad/h0", b"A")
        inner.set("srpod/p/ad/h1", b"B")
        store = mem.PartitionedCoordStore(inner)
        faults.install("kv_partition@0:block=h0,ops=6")
        trace = [store.try_get("srpod/p/ad/h0"), store.try_get("srpod/p/ad/h1")]
        try:
            store.get("srpod/p/ad/h0", timeout_ms=10)
            trace.append("got")
        except TimeoutError:
            trace.append("timeout")
        trace.append(store.set_if_absent("srpod/p/claim/h0/1", b"me"))
        store.set("srpod/p/ad/h0", b"dropped")
        trace.append(dict(store.partition_stats()))
        trace.append(store.list("srpod/p/ad/"))
        trace.append(store.try_get("srpod/p/ad/h0"))
        trace.append(dict(store.partition_stats()))
        faults.install(None)
        seen[pkg] = trace
    assert seen["jax"] == seen["torch"]
    assert seen["torch"][0] is None and seen["torch"][-2] == b"A"
