"""PyTorch port vs JAX package: ``parallel/distributed.py`` and the
coordination stores of ``parallel/membership.py``.

The world helpers must give JAX's answers for the same inputs (island
slices, live-set digests, env overrides, ``PeerLossError``'s text). The
port's ``TorchCoordStore`` over a real TCPStore (bound to port 0) is held
to ``FileCoordStore``'s semantics, each store case run on both (the JAX
package's ``tests/test_membership.py`` store cases). An allgather payload
posted by the JAX package's ``_kv_allgather`` decodes in the port's and the
other way round, over one store.
"""

import datetime
import threading
import time

import jax
import numpy as np
import pytest
import torch.distributed as tdist

from symbolicregression_jl_tpu.parallel import distributed as jdist
from symbolicregression_jl_tpu.parallel import membership as jmem
from symbolicregression_jl_tpu_torch.parallel import distributed as dist
from symbolicregression_jl_tpu_torch.parallel import membership as mem
from symbolicregression_jl_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("SR_ELASTIC_WORLD", "SR_ELASTIC_ID", "SR_COORD_DIR", "SR_KV_TIMEOUT_MS",
              "SR_KV_BACKOFF_MS", "SR_KV_BACKOFF_MAX_MS", "SR_FAULT_SPEC"):
        monkeypatch.delenv(k, raising=False)
    faults.install(None)
    dist.reset_peer_state()
    jdist.reset_peer_state()
    yield
    faults.install(None)
    dist.reset_peer_state()
    jdist.reset_peer_state()


def _tcp_store():
    return tdist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=30),
                          wait_for_workers=False)


@pytest.fixture(params=["file", "tcp"])
def store(request, tmp_path):
    if request.param == "file":
        return mem.FileCoordStore(str(tmp_path / "coord"))
    return mem.TorchCoordStore(_tcp_store())


def _run_members(fns, timeout=60.0):
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


# -- the world helpers against JAX's ------------------------------------------


def test_initialize_noop_single_process():
    dist.initialize()
    assert not dist.is_distributed()
    assert dist.world_shape() == (1, 0) == jdist.world_shape()
    assert dist.allgather_transport() == "local"


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_island_slice_matches_jax(monkeypatch, world):
    for rank in range(world):
        monkeypatch.setenv("SR_ELASTIC_WORLD", str(world))
        monkeypatch.setenv("SR_ELASTIC_ID", str(rank))
        for n in (1, 4, 7, 15, 16, 100):
            assert dist.process_island_slice(n) == jdist.process_island_slice(n)
            lives = [list(range(world)), [rank], sorted({rank, 0}), sorted({rank, world - 1})]
            for live in lives:
                assert dist.process_island_slice(n, live=live) == jdist.process_island_slice(
                    n, live=live)
            others = [p for p in range(world) if p != rank]
            if others:
                with pytest.raises(ValueError, match="not in the live set"):
                    dist.process_island_slice(n, live=others)


def test_live_set_digest_matches_jax():
    for epoch, seq, live in [(0, 0, [0]), (3, 7, [5, 0, 2]), (1, 1, list(range(512))),
                             (12, 99, [1, 3])]:
        d = dist.live_set_digest(epoch, seq, live)
        assert d == jdist.live_set_digest(epoch, seq, live)
        assert len(d) == 12


@pytest.mark.parametrize("fn", ["kv_timeout_ms", "kv_backoff_ms", "kv_backoff_max_ms"])
def test_env_overrides_match_jax(monkeypatch, fn):
    var = {"kv_timeout_ms": "SR_KV_TIMEOUT_MS", "kv_backoff_ms": "SR_KV_BACKOFF_MS",
           "kv_backoff_max_ms": "SR_KV_BACKOFF_MAX_MS"}[fn]
    assert getattr(dist, fn)() == getattr(jdist, fn)()
    for value in ("1234", "40", "0", "-5", "zero", ""):
        monkeypatch.setenv(var, value)
        try:
            want = getattr(jdist, fn)()
        except ValueError:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                getattr(dist, fn)()
        else:
            assert getattr(dist, fn)() == want, value


def test_world_shape_env_override_matches_jax(monkeypatch):
    monkeypatch.setenv("SR_ELASTIC_WORLD", "4")
    monkeypatch.setenv("SR_ELASTIC_ID", "2")
    assert dist.world_shape() == (4, 2) == jdist.world_shape()
    assert dist.live_process_ids() == jdist.live_process_ids() == [0, 1, 2, 3]
    assert dist.allgather_transport() == "kv-store"


@pytest.mark.parametrize("kw", [
    dict(seq=7, missing=[3, 1], timeout_ms=250),
    dict(seq=2, missing=[4], timeout_ms=100, attempts=17),
    dict(seq=-1, missing=[2, 3], timeout_ms=400, phase="barrier bar/dead"),
    dict(seq=1, missing=[0], timeout_ms=50, attempts=0),
])
def test_peer_loss_error_matches_jax(kw):
    ours, theirs = dist.PeerLossError(**kw), jdist.PeerLossError(**kw)
    assert str(ours) == str(theirs)
    assert (ours.seq, ours.missing, ours.attempts, ours.phase) == (
        theirs.seq, theirs.missing, theirs.attempts, theirs.phase)
    assert isinstance(ours, RuntimeError)


def test_dead_peer_bookkeeping_resets():
    assert dist.dead_peers() == frozenset()
    dist._DEAD_PEERS.add(2)
    assert dist.dead_peers() == frozenset({2})
    dist.reset_peer_state()
    assert dist.dead_peers() == frozenset()


def test_equation_search_resets_stale_dead_peers():
    """Peer-death state is per search: a second equation_search must not
    inherit the dead set of an earlier one."""
    from symbolicregression_jl_tpu_torch import Options, equation_search

    dist._DEAD_PEERS.add(1)
    X = np.linspace(-1, 1, 32).reshape(1, -1)
    opts = Options(binary_operators=["+", "*"], populations=2, population_size=8,
                   ncycles_per_iteration=2, maxsize=8, seed=0, progress=False,
                   save_to_file=False, device="cpu")
    equation_search(X, 2.0 * X[0], niterations=1, options=opts, verbosity=0)
    assert dist.dead_peers() == frozenset()


def test_allgather_identity_single_process():
    pool = {"loss": np.arange(4.0), "kind": np.ones((4, 8), np.int32)}
    out = dist.all_gather_migration_pool(pool)
    jout = jdist.all_gather_migration_pool(pool)
    for k in pool:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]).reshape(out[k].shape))
        assert out[k].shape == (1,) + pool[k].shape


def test_double_buffered_exchange_is_one_call_stale():
    ex = dist.DoubleBufferedExchange()
    assert ex.roll((np.asarray([1.0]),)) is None
    (got,) = ex.roll((np.asarray([2.0]),))
    assert got.tolist() == [[1.0]]
    (got,) = ex.flush()
    assert got.tolist() == [[2.0]]
    assert ex.flush() is None


def test_tree_flatten_matches_jax_order():
    tree = {"b": (np.zeros(2), [np.ones(1), np.full(3, 2.0)]), "a": np.arange(4)}
    leaves, td = dist.tree_flatten(tree)
    jleaves, _ = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a, b)
    back = dist.tree_unflatten(td, leaves)
    assert sorted(back) == ["a", "b"] and isinstance(back["b"][1], list)


# -- the coordination stores (JAX tests/test_membership.py:57-210, both) -------


def test_store_set_get_delete(store):
    store.set("a/b", b"one")
    assert store.get("a/b", 100) == b"one"
    assert store.try_get("a/b") == b"one"
    store.set_mutable("a/b", b"two")
    assert store.get("a/b", 100) == b"two"
    store.delete("a/b")
    assert store.try_get("a/b") is None
    store.delete("never-written")  # deleting an absent key is quiet


def test_store_get_timeout(store):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        store.get("never", 80)
    assert time.monotonic() - t0 < 5.0


def test_store_blocking_get_sees_late_write(store):
    def writer():
        time.sleep(0.1)
        store.set("late", b"v")

    t = threading.Thread(target=writer)
    t.start()
    assert store.get("late", 5000) == b"v"
    t.join()


def test_store_barrier(store):
    done = []

    def member(i):
        store.barrier("bar/x", 5000, [0, 1, 2], i)
        done.append(i)

    _run_members([lambda i=i: member(i) for i in range(3)])
    assert sorted(done) == [0, 1, 2]


def test_store_barrier_dead_member_names_missing_ids(store):
    errors = []

    def survivor(i):
        t0 = time.monotonic()
        try:
            store.barrier("bar/dead", 400, [0, 1, 2, 3], i)
        except dist.PeerLossError as e:
            errors.append((e, time.monotonic() - t0))

    _run_members([lambda i=i: survivor(i) for i in (0, 1)])
    assert len(errors) == 2
    for e, elapsed in errors:
        assert sorted(e.missing) == [2, 3]
        assert "barrier" in str(e) and "2" in str(e) and "3" in str(e)
        assert elapsed < 5.0


def test_store_set_if_absent_and_list(store):
    assert store.set_if_absent("lease/h1", b"me") is True
    assert store.set_if_absent("lease/h1", b"you") is False
    assert store.try_get("lease/h1") == b"me"
    store.set("inbox/h0/a", b"1")
    store.set("inbox/h0/b", b"2")
    store.set("inbox/h1/c", b"3")
    assert store.list("inbox/h0/") == ["inbox/h0/a", "inbox/h0/b"]
    assert store.list("lease/") == ["lease/h1"]
    store.delete("lease/h1")
    assert store.set_if_absent("lease/h1", b"again") is True
    assert store.try_get("lease/h1") == b"again"


def test_store_set_if_absent_race_has_one_winner(store):
    wins = []
    lock = threading.Lock()

    def claimant(i):
        if store.set_if_absent("claim/x", f"c{i}".encode()):
            with lock:
                wins.append(i)

    _run_members([lambda i=i: claimant(i) for i in range(8)])
    assert len(wins) == 1
    assert store.try_get("claim/x") == f"c{wins[0]}".encode()


def test_torch_store_defaults_to_the_world_store(monkeypatch):
    st = _tcp_store()
    monkeypatch.setattr(dist, "_STORE", st)
    s = mem.TorchCoordStore()
    s.set("k", b"vv")
    assert mem.TorchCoordStore(st).try_get("k") == b"vv"
    assert isinstance(mem.coord_store(), mem.TorchCoordStore)


# -- payloads across the packages over one store --------------------------------


class _StoreClient:
    """The JAX coordination client's KV surface over a port CoordStore, for
    rank ``pid`` of a world of 2: JAX's ``_kv_allgather`` posts and reads
    through it."""

    def __init__(self, store, pid):
        self.store, self.pid = store, pid

    def key_value_set_bytes(self, key, value):
        self.store.set(key, value)

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        return self.store.get(key, timeout_ms)

    def key_value_delete(self, key):
        self.store.delete(key)

    def wait_at_barrier(self, bid, timeout_ms, process_ids=None):
        self.store.barrier(bid, timeout_ms, list(process_ids or [0, 1]), self.pid)


@pytest.mark.parametrize("port_rank", [0, 1])
def test_kv_allgather_payloads_cross_packages(monkeypatch, store, port_rank):
    """The port's ``_kv_allgather`` (as rank ``port_rank``) and the JAX
    package's (the other rank) in two threads on one store: each decodes
    the other's ``np.savez`` post, and both return the same stacks."""
    from jax._src import distributed as _jd

    jax_rank = 1 - port_rank
    monkeypatch.setattr(dist, "world_shape", lambda: (2, port_rank))
    monkeypatch.setattr(mem, "coord_store", lambda: store)
    monkeypatch.setattr(dist, "_KV_SEQ", 0)
    monkeypatch.setattr(jdist, "_KV_SEQ", 0)
    monkeypatch.setattr(_jd.global_state, "client", _StoreClient(store, jax_rank))
    monkeypatch.setattr(jax, "process_index", lambda: jax_rank)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setenv("SR_KV_TIMEOUT_MS", "20000")
    payload = {r: (np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r,
                   np.full((4,), r, np.int32)) for r in (0, 1)}
    out = {}
    _run_members([
        lambda: out.__setitem__("port", dist._kv_allgather(payload[port_rank])),
        lambda: out.__setitem__("jax", jdist._kv_allgather(payload[jax_rank])),
    ])
    for who in ("port", "jax"):
        got = out[who]
        for j in range(2):
            want = np.stack([payload[0][j], payload[1][j]])
            np.testing.assert_array_equal(np.asarray(got[j]), want)
            assert np.asarray(got[j]).dtype == want.dtype
