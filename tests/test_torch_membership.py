"""PyTorch port vs JAX package: the elastic membership runtime
(``parallel/membership.py``).

The JAX package's ``tests/test_membership.py`` cases against the port:
control rows, epoch-stamped barrier ids, flat and ring collectives,
``stop_sync``, suspicion, kill and epoch bumps, join with shard adoption,
heartbeats, the ``kv_flap``, ``slow_peer`` and ``kv_partition`` sites, the
collectives on a ``FileCoordStore`` and on a ``TorchCoordStore`` over a
TCPStore bound to port 0, one thread per member. And a mixed group: members
of both packages in one ``ExchangeGroup`` on one store, whose gathers,
control rows and epoch records must agree byte for byte.
"""

import datetime
import pickle
import threading

import numpy as np
import pytest
import torch.distributed as tdist

from symbolicregression_jl_tpu.parallel import distributed as jdist
from symbolicregression_jl_tpu.parallel import membership as jmem
from symbolicregression_jl_tpu.utils import faults as jfaults
from symbolicregression_jl_tpu_torch.parallel import distributed as dist
from symbolicregression_jl_tpu_torch.parallel import membership as mem
from symbolicregression_jl_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("SR_ELASTIC_WORLD", "SR_ELASTIC_ID", "SR_COORD_DIR", "SR_FAULT_SPEC"):
        monkeypatch.delenv(k, raising=False)
    faults.install(None)
    jfaults.install(None)
    dist.reset_peer_state()
    jdist.reset_peer_state()
    yield
    faults.install(None)
    jfaults.install(None)
    dist.reset_peer_state()
    jdist.reset_peer_state()


def _store(tmp_path, kind="file"):
    if kind == "tcp":
        return mem.TorchCoordStore(tdist.TCPStore(
            "127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=30),
            wait_for_workers=False))
    return mem.FileCoordStore(str(tmp_path / "coord"))


def _group(store, my_id, world, **kw):
    kw.setdefault("start_heartbeat", False)
    return mem.ExchangeGroup(store, "t", my_id, world, **kw)


def _run_members(fns, timeout=60.0):
    """Run one callable per member on its own thread; re-raise any failure."""
    errors = []

    def wrap(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "member thread hung"
    if errors:
        raise errors[0]


# -- control rows / digest ----------------------------------------------------


def test_control_row_roundtrip(tmp_path):
    g = _group(_store(tmp_path), 0, 5)
    g._suspects = {3, 1}
    row = g._control_row({4})
    assert row.shape == (2 + 2 * 5,)
    j, s = mem.ExchangeGroup._parse_control(row, 5)
    assert j == {4} and s == {1, 3}
    empty = _group(_store(tmp_path), 0, 5)._control_row(set())
    j, s = mem.ExchangeGroup._parse_control(empty, 5)
    assert j == set() and s == set()


def test_barrier_id_stamps_epoch_and_live(tmp_path):
    g = _group(_store(tmp_path), 0, 3)
    b0 = g._barrier_id(0)
    g.epoch = 1
    b1 = g._barrier_id(0)
    assert b0 != b1  # a stale partition can't collide with the new epoch
    g.live = [0, 1]
    assert g._barrier_id(0) != b1


# -- flat + ring collectives --------------------------------------------------


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_flat_allgather_three_members(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "10000")
    store = _store(tmp_path, kind)
    groups = [_group(store, i, 3) for i in range(3)]
    out = {}

    def member(g):
        (rows,), _, order = g.allgather((np.asarray([g.my_id * 10], np.int64),))
        out[g.my_id] = (rows, order)

    _run_members([lambda g=g: member(g) for g in groups])
    for i in range(3):
        rows, order = out[i]
        assert order == [0, 1, 2]
        assert rows[:, 0].tolist() == [0, 10, 20]


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_ring_exchange_reads_predecessor_only(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "10000")
    store = _store(tmp_path, kind)
    groups = [_group(store, i, 3, topology="ring") for i in range(3)]
    out = {}

    def member(g):
        (rows,) = g.exchange((np.asarray([g.my_id], np.int64),))
        # ring keys are reclaimed at the next admission point
        assert g._ring_keys
        code, evals, admitted = g.stop_sync(0, 1.0, iteration=1)
        assert not g._ring_keys
        out[g.my_id] = (rows, code, evals, admitted)

    _run_members([lambda g=g: member(g) for g in groups])
    # rows are [self, ring predecessor]
    assert out[0][0][:, 0].tolist() == [0, 2]
    assert out[1][0][:, 0].tolist() == [1, 0]
    assert out[2][0][:, 0].tolist() == [2, 1]
    for i in range(3):
        assert out[i][1] == 0
        assert out[i][2] == pytest.approx(3.0)  # evals sum-reduce, flat
        assert out[i][3] == []


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_stop_sync_max_code_sum_evals(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "10000")
    store = _store(tmp_path, kind)
    groups = [_group(store, i, 2) for i in range(2)]
    out = {}

    def member(g, code, evals):
        out[g.my_id] = g.stop_sync(code, evals, iteration=1)

    _run_members(
        [
            lambda: member(groups[0], 0, 100.0),
            lambda: member(groups[1], 3, 11.5),
        ]
    )
    for i in range(2):
        code, evals, admitted = out[i]
        assert code == 3
        assert evals == pytest.approx(111.5)


# -- peer loss: raise / suspect / kill ---------------------------------------


def test_allgather_raise_names_attempts(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "300")
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "20")
    g = _group(_store(tmp_path), 0, 2)  # rank 1 never posts
    with pytest.raises(dist.PeerLossError) as ei:
        g.allgather((np.asarray([0]),))
    assert ei.value.missing == (1,)
    assert ei.value.attempts is not None and ei.value.attempts >= 1
    assert "poll attempt" in str(ei.value)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_suspect_then_kill_bumps_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "500")
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "20")
    store = _store(tmp_path)
    groups = [
        _group(store, i, 3, on_peer_loss="continue") for i in range(2)
    ]  # rank 2 never shows up
    out = {}

    def member(g):
        # pytest.warns is not thread-safe; assert the suspicion directly
        (rows,), _, order = g.allgather((np.asarray([g.my_id]),))
        assert order == [0, 1]
        assert g._suspects == {2}
        code, evals, admitted = g.stop_sync(0, 1.0, iteration=1)
        out[g.my_id] = (g.epoch, list(g.live), sorted(g.dead))

    _run_members([lambda g=g: member(g) for g in groups])
    for i in range(2):
        assert out[i] == (1, [0, 1], [2])
    assert 2 in dist.dead_peers()  # mirrored for observability


def test_falsely_suspected_member_raises_voted_dead(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "10000")
    store = _store(tmp_path)
    groups = [_group(store, i, 3, on_peer_loss="continue") for i in range(3)]
    groups[0]._suspects = {1}  # rank 0 wrongly suspects a live rank 1
    out = {}

    def member(g):
        try:
            g.stop_sync(0, 1.0, iteration=1)
            out[g.my_id] = ("ok", g.epoch, list(g.live))
        except RuntimeError as e:
            out[g.my_id] = ("voted-dead", str(e))

    _run_members([lambda g=g: member(g) for g in groups])
    assert out[1][0] == "voted-dead"
    assert "rejoin" in out[1][1]
    for i in (0, 2):
        assert out[i] == ("ok", 1, [0, 2])


# -- join / rejoin ------------------------------------------------------------


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_join_admission_epoch_and_shard(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "400")
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "20")
    store = _store(tmp_path, kind)
    shard = b"format2-shard-bytes"
    survivors = [
        _group(
            store, i, 3, on_peer_loss="rejoin",
            shard_provider=(lambda: shard) if i == 0 else None,
        )
        for i in range(2)
    ]
    out = {}
    joiner_ready = threading.Event()

    def survivor(g):
        # phase A: rank 2 misses the deadline -> suspect -> killed at the
        # admission point (epoch 1)
        g.allgather((np.asarray([g.my_id]),))
        assert g._suspects == {2}
        g.stop_sync(0, 1.0, iteration=1)
        assert g.epoch == 1 and g.live == [0, 1]
        joiner_ready.set()
        # phase B: keep iterating until the joiner's announcement is admitted
        admitted = []
        for i in range(40):
            g.exchange((np.asarray([g.my_id]),))
            _, _, adm = g.stop_sync(0, 1.0, iteration=2 + i)
            if adm:
                admitted = adm
                break
        assert admitted == [2]
        # post-join collective: all three ranks, same epoch, seq 0
        (rows,), _, order = g.allgather((np.asarray([g.my_id]),))
        out[g.my_id] = (g.epoch, order, rows[:, 0].tolist())

    def joiner():
        joiner_ready.wait(30)
        g2 = _group(store, 2, 3, on_peer_loss="rejoin")
        record, got_shard = g2.join(timeout_ms=30000)
        assert record["epoch"] == g2.epoch >= 2
        assert 2 in record["live"] and record["joined"] == [2]
        assert record["iteration"] >= 2
        assert got_shard == shard
        assert g2.seq == 0
        (rows,), _, order = g2.allgather((np.asarray([2]),))
        out[2] = (g2.epoch, order, rows[:, 0].tolist())

    _run_members(
        [lambda g=g: survivor(g) for g in survivors] + [joiner], timeout=120
    )
    epochs = {out[i][0] for i in range(3)}
    assert len(epochs) == 1 and epochs.pop() >= 2
    for i in range(3):
        assert out[i][1] == [0, 1, 2]
        assert out[i][2] == [0, 1, 2]
    # the rejoined rank was un-mirrored from the dead set
    assert 2 not in dist.dead_peers()


# -- heartbeats / fault sites -------------------------------------------------


def test_heartbeats_publish_ages(tmp_path):
    store = _store(tmp_path)
    g = mem.ExchangeGroup(
        store, "hb", 0, 2, heartbeat_every=0.05, start_heartbeat=True
    )
    try:
        import time

        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            alive = g.peers_alive()
            if 0 in alive:
                break
            time.sleep(0.02)
        assert 0 in alive and alive[0] < 5.0
        assert 1 not in alive
    finally:
        g.close()
    assert store.try_get(g._hb_key(0)) is None  # close drops the beat


def test_kv_flap_forces_extra_poll_attempts(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "10")
    store = _store(tmp_path)
    store.set("k", b"v")
    g = _group(store, 0, 2)
    import time

    faults.install("kv_flap@0")
    raw, attempts = g._read_peer("k", time.monotonic() + 5.0)
    assert raw == b"v" and attempts >= 2  # first attempt flapped
    faults.install(None)
    raw, attempts = g._read_peer("k", time.monotonic() + 5.0)
    assert raw == b"v" and attempts == 1


def test_slow_peer_delays_post(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "10000")
    import time

    store = _store(tmp_path)
    groups = [_group(store, i, 2) for i in range(2)]
    faults.install(None)
    out = {}

    def member(g, spec):
        if spec:
            # per-thread determinism: only rank 0 carries the rule, via the
            # process-wide injector installed before the threads start
            pass
        t0 = time.monotonic()
        g.allgather((np.asarray([g.my_id]),))
        out[g.my_id] = time.monotonic() - t0

    faults.install("slow_peer@0:delay_ms=300")
    _run_members(
        [lambda: member(groups[0], True), lambda: member(groups[1], False)]
    )
    # exactly one post was delayed (exact-call-count rule); both members
    # still completed inside the deadline with no membership change
    assert groups[0].live == [0, 1] and groups[1].live == [0, 1]
    assert max(out.values()) >= 0.25


def test_should_use_group_and_elastic_enabled(tmp_path, monkeypatch):
    from symbolicregression_jl_tpu_torch.options import Options

    opt = Options(binary_operators=["+"], unary_operators=[], device="cpu")
    monkeypatch.delenv("SR_COORD_DIR", raising=False)
    assert not mem.elastic_enabled(opt)
    monkeypatch.setenv("SR_COORD_DIR", str(tmp_path))
    assert mem.elastic_enabled(None)
    assert isinstance(mem.coord_store(), mem.FileCoordStore)
    monkeypatch.delenv("SR_COORD_DIR", raising=False)
    opt2 = Options(binary_operators=["+"], unary_operators=[], on_peer_loss="rejoin",
                   device="cpu")
    assert mem.elastic_enabled(opt2)
    # single-process world: no group, whatever the options say
    monkeypatch.delenv("SR_ELASTIC_WORLD", raising=False)
    assert not mem.should_use_group(opt2)
    monkeypatch.setenv("SR_ELASTIC_WORLD", "4")
    monkeypatch.setenv("SR_ELASTIC_ID", "1")
    assert dist.world_shape() == (4, 1)
    assert mem.should_use_group(opt2)


# -- kv_partition fault site --------------------------------------------------


def test_partitioned_store_severs_then_heals(tmp_path):
    """The kv_partition wrapper: blocked-host keys vanish from THIS
    process's view (reads None/Timeout, writes dropped, CAS loses, list
    filters) for exactly ``ops`` store operations, then heal — and the
    inner store proves no severed write ever leaked through."""
    inner = _store(tmp_path)
    inner.set("srpod/p/ad/h0", b"A")
    inner.set("srpod/p/ad/h1", b"B")
    store = mem.PartitionedCoordStore(inner)
    faults.install("kv_partition@0:block=h0,ops=6")
    # op 1 fires the rule and is the first severed-capable operation
    assert store.try_get("srpod/p/ad/h0") is None
    assert store.try_get("srpod/p/ad/h1") == b"B"  # far side unaffected
    with pytest.raises(TimeoutError):
        store.get("srpod/p/ad/h0", timeout_ms=10)
    assert store.set_if_absent("srpod/p/claim/h0/1", b"me") is False
    assert inner.try_get("srpod/p/claim/h0/1") is None  # CAS never wrote
    store.set("srpod/p/ad/h0", b"dropped")  # write silently dropped
    st = store.partition_stats()
    assert st["active"] and st["partitions"] == 1 and st["dropped_ops"] >= 4
    # 6th op heals: full connectivity returns, nothing was forged
    assert store.list("srpod/p/ad/") == ["srpod/p/ad/h0", "srpod/p/ad/h1"]
    assert store.try_get("srpod/p/ad/h0") == b"A"  # original value intact
    assert store.set_if_absent("srpod/p/claim/h0/1", b"me") is True
    st = store.partition_stats()
    assert not st["active"] and st["healed"] == 1


def test_partitioned_store_list_filters_blocked_keys(tmp_path):
    inner = _store(tmp_path)
    inner.set("srpod/p/inbox/h0/pj-1", b"x")
    inner.set("srpod/p/inbox/h1/pj-2", b"y")
    store = mem.PartitionedCoordStore(inner)
    faults.install("kv_partition@0:block=h1,ops=50")
    store.try_get("srpod/p/ad/h0")  # fires the rule
    assert store.list("srpod/p/inbox/") == ["srpod/p/inbox/h0/pj-1"]
    # a prefix that ITSELF names the blocked host is fully unreachable
    assert store.list("srpod/p/inbox/h1/") == []


def test_coord_store_wraps_when_kv_partition_armed(tmp_path, monkeypatch):
    """coord_store() must hand every consumer the partition view when the
    site is armed — and rig plumbing that needs the file root must keep
    working through the wrapper (PodNode unwraps ``.inner``)."""
    monkeypatch.setenv("SR_COORD_DIR", str(tmp_path / "c"))
    faults.install("kv_partition@9:block=h1,ops=5")
    store = mem.coord_store()
    assert isinstance(store, mem.PartitionedCoordStore)
    assert isinstance(store.inner, mem.FileCoordStore)
    assert store.root == store.inner.root  # attribute passthrough
    faults.install(None)
    assert isinstance(mem.coord_store(), mem.FileCoordStore)  # unwrapped


# -- a mixed group: members of both packages in one ExchangeGroup ---------------


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("leader", ["jax", "torch"])
def test_mixed_group_gathers_controls_and_epoch_records(tmp_path, monkeypatch, leader):
    """Three live members of a world of 4 on one FileCoordStore, two of one
    package and one of the other (rank 0, the leader, is ``leader``'s);
    rank 3 never shows. Flat allgather, the ring exchange and stop_sync
    (which kills rank 3 and bumps the epoch) run in threads; then a flat
    gather at the new epoch. Every member's gathered arrays and control
    rows are equal byte for byte, and the epoch record the leader wrote is
    the same bytes either package writes."""
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "1500")
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "20")
    store_root = str(tmp_path / "coord")
    pkgs = {"jax": jmem, "torch": mem}
    other = "torch" if leader == "jax" else "jax"
    kinds = [leader, other, leader]
    groups = [pkgs[k].ExchangeGroup(pkgs[k].FileCoordStore(store_root), "mix", r, 4,
                                    on_peer_loss="continue", topology="ring",
                                    start_heartbeat=False)
              for r, k in enumerate(kinds)]
    out = {}

    def member(g):
        r = g.my_id
        payload = (np.arange(5, dtype=np.float32) + 100 * r,
                   np.full((2, 3), r, np.int64), np.asarray([r * 0.5], np.float64))
        rows, controls, order = g.allgather(payload)
        ring = g.exchange(payload)
        code, evals, admitted = g.stop_sync(r, 10.0 * (r + 1), iteration=1)
        rows2, controls2, order2 = g.allgather(payload)
        out[r] = dict(rows=[np.asarray(a) for a in rows], controls=[np.asarray(c) for c in
                                                                     controls],
                      order=order, ring=[np.asarray(a) for a in ring], stop=(code, evals,
                                                                             admitted),
                      epoch=g.epoch, live=list(g.live), rows2=[np.asarray(a) for a in rows2],
                      controls2=[np.asarray(c) for c in controls2], order2=order2)

    _run_members([lambda g=g: member(g) for g in groups], timeout=60)
    ref = out[0]
    assert ref["order"] == [0, 1, 2] and ref["order2"] == [0, 1, 2]
    assert ref["stop"] == (2, 60.0, []) and ref["epoch"] == 1 and ref["live"] == [0, 1, 2]
    for r in (1, 2):
        o = out[r]
        for key in ("rows", "controls", "rows2", "controls2"):
            assert len(o[key]) == len(ref[key])
            for a, b in zip(o[key], ref[key]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (r, key)
        assert (o["order"], o["stop"], o["epoch"], o["live"]) == (
            ref["order"], ref["stop"], ref["epoch"], ref["live"])
    # the ring rows are [self, ring predecessor] in both packages (the ring
    # skips the suspect rank 3)
    for r in range(3):
        for j in range(3):
            assert out[r]["ring"][j][0].tobytes() == ref["rows"][j][r].tobytes()
            assert out[r]["ring"][j][1].tobytes() == ref["rows"][j][(r - 1) % 3].tobytes()
    raw = mem.FileCoordStore(store_root).try_get("srep/mix/1")
    record = {"epoch": 1, "live": [0, 1, 2], "iteration": 1, "joined": [], "left": [3]}
    assert raw == pickle.dumps(record)
    assert pickle.loads(raw) == record
