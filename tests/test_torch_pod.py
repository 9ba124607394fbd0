"""The port's pod federation (``serve/pod.py``) on the CPU, against the JAX
package's, and the repaired ``JobSpec`` decoding (``serve/queue.decode_spec``).

Mirrors tests/test_pod.py (routing, stale and draining hosts, the burst
hint, one node end to end, adoption of a dead host's journal and inbox, a
terminal job reported once, a fresh generation after adoption, the drain
handoff, the skewed observer) and the three ``_poll_backoff`` /
``PodClient.wait`` tests of tests/test_net.py, all in-process over a
``FileCoordStore`` with ``Options(device="cpu")``. Held against the JAX
package: ``route`` on the same seeded ads, the ``_PodKeys`` strings, a
JAX ``PodClient`` reading a port node's ads and done ledger and decoding
its final frame, and a JAX envelope in a port node's inbox deleted as
poison. A subprocess holds the port's ``NetServer`` and
``SearchServer._recover`` refusing a JAX ``JobSpec`` without importing
jax or the JAX package, with JAX importable and with it blocked. Every
wait has a timeout.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu.serve as jserve
from symbolicregression_jl_tpu.parallel.membership import FileCoordStore as JFileCoordStore
from symbolicregression_jl_tpu.serve import pod as jpod
from symbolicregression_jl_tpu.utils.checkpoint import load_frontier_bytes as j_load_frontier_bytes
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.parallel.membership import FileCoordStore
from symbolicregression_jl_tpu_torch.serve import (
    DONE,
    Job,
    JobJournal,
    JobSpec,
    PodClient,
    PodNode,
    bucket_digest,
    shape_bucket,
)
from symbolicregression_jl_tpu_torch.serve import pod as tpod
from symbolicregression_jl_tpu_torch.serve.pod import _poll_backoff
from symbolicregression_jl_tpu_torch.serve.queue import decode_spec
from symbolicregression_jl_tpu_torch.utils import faults
from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (a module run earlier in this process may have
    enabled x64) and torch on one thread."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.install(None)


def _problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


_BASE = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
             population_size=8, ncycles_per_iteration=8, maxsize=10, save_to_file=False,
             seed=0, scheduler="lockstep")


def _opts(**kw):
    return T.Options(**{**_BASE, "device": "cpu", "progress": False, **kw})


def _jopts(**kw):
    return J.Options(**{**_BASE, **kw})


def _spec(X, y, **kw):
    kw.setdefault("options", _opts())
    kw.setdefault("niterations", 2)
    return JobSpec(X, y, **kw)


def _store(tmp_path):
    return FileCoordStore(str(tmp_path / "coord"))


def _node(store, host, **kw):
    kw.setdefault("hb_seconds", 0.05)
    kw.setdefault("suspect_seconds", 0.6)
    kw.setdefault("max_concurrency", 1)
    kw.setdefault("poll_seconds", 0.02)
    return PodNode(host, store=store, **kw)


def _client(store, **kw):
    kw.setdefault("suspect_seconds", 0.6)
    return PodClient(store=store, **kw)


def _ad(store, host, *, t=None, gen=1, warm=(), draining=False,
        queue_depth=0, running=0, pod="pod0"):
    store.set_mutable(
        f"srpod/{pod}/ad/{host}",
        pickle.dumps({
            "host": host, "t": time.time() if t is None else t, "gen": gen,
            "queue_depth": queue_depth, "running": running,
            "warm": list(warm), "draining": draining, "pid": 0,
        }),
    )


def _wait_live(client, hosts, timeout=10):
    deadline = time.monotonic() + timeout
    while set(hosts) - set(client.live_hosts()):
        assert time.monotonic() < deadline, "node never advertised"
        time.sleep(0.02)


def _frontier(frame, options):
    upd = load_frontier_bytes(frame)
    return [(m.get_complexity(options), m.loss) for m in upd.members]


# -- digests / routing (no engine) ---------------------------------------------


def test_bucket_digest_stable_and_shape_sensitive():
    X, y = _problem()
    b1 = shape_bucket(X, y, None, _opts(seed=1))
    b2 = shape_bucket(X, y, None, _opts(seed=2))
    assert bucket_digest(b1) == bucket_digest(b2)  # seed-agnostic warmth
    X3, y3 = _problem(n=61)
    assert bucket_digest(shape_bucket(X3, y3, None, _opts())) != bucket_digest(b1)
    assert len(bucket_digest(b1)) == 12
    # the warmth currency both packages' hosts advertise
    assert bucket_digest(b1) == jserve.bucket_digest(
        jserve.shape_bucket(X, y, None, _jopts(seed=1)))


def test_route_prefers_warm_then_least_loaded(tmp_path):
    st = _store(tmp_path)
    X, y = _problem()
    spec = _spec(X, y)
    digest = bucket_digest(shape_bucket(spec.X, spec.y, None, spec.options))
    _ad(st, "cold-idle", queue_depth=0)
    _ad(st, "warm-busy", warm=[digest], queue_depth=3, running=1)
    c = _client(st)
    # warmth beats load: resident data and tables are worth more than a slot
    assert c.route(spec) == "warm-busy"
    _ad(st, "warm-idle", warm=[digest], queue_depth=0)
    assert c.route(spec) == "warm-idle"  # least loaded within the warm pool


def test_route_skips_stale_and_draining_hosts(tmp_path):
    st = _store(tmp_path)
    X, y = _problem()
    spec = _spec(X, y)
    _ad(st, "dead", t=time.time() - 30)
    _ad(st, "leaving", draining=True)
    _ad(st, "alive", queue_depth=5)
    c = _client(st)
    assert c.route(spec) == "alive"
    st.delete("srpod/pod0/ad/alive")
    with pytest.raises(RuntimeError, match="no live hosts"):
        c.route(spec)


def test_client_load_hint_spreads_a_burst(tmp_path):
    st = _store(tmp_path)
    X, y = _problem()
    _ad(st, "a")
    _ad(st, "b")
    c = _client(st)
    targets = []
    for _ in range(4):  # a burst between ad beats: ads never refresh here
        t = c.route(_spec(X, y))
        targets.append(t)
        c._sent_since.setdefault(t, []).append(time.time())
    assert targets.count("a") == 2 and targets.count("b") == 2


@pytest.mark.parametrize("seed", range(6))
def test_route_equals_jax_on_seeded_ads(tmp_path, seed):
    """Both packages' clients pick the same host on the same random ads
    (warm sets, loads, stale and draining hosts) read from one store."""
    rng = np.random.default_rng(seed)
    st = _store(tmp_path)
    X, y = _problem(n=40 + seed)
    spec, jspec = _spec(X, y), jserve.JobSpec(X, y, options=_jopts(), niterations=2)
    digest = bucket_digest(shape_bucket(X, y, None, spec.options))
    now = time.time()
    for h in range(int(rng.integers(3, 8))):
        _ad(st, f"h{h}", t=now - (30.0 if rng.random() < 0.2 else 0.0),
            warm=[digest] if rng.random() < 0.4 else ["0" * 12],
            draining=bool(rng.random() < 0.15), queue_depth=int(rng.integers(0, 5)),
            running=int(rng.integers(0, 2)))
    c = _client(st, suspect_seconds=5.0)
    jc = jpod.PodClient(store=JFileCoordStore(st.root), suspect_seconds=5.0)
    got, want = [], []
    for _ in range(5):
        for client, out, s in ((c, got, spec), (jc, want, jspec)):
            try:
                t = client.route(s)
            except RuntimeError:
                t = None
            out.append(t)
            if t is not None:
                client._sent_since.setdefault(t, []).append(time.time())
    assert got == want


def test_pod_keys_equal_jax():
    k, jk = tpod._PodKeys("lab"), jpod._PodKeys("lab")
    assert k.ns == jk.ns
    for name, args in (("ad", ("h1",)), ("ad_prefix", ()), ("inbox", ("h1", "pj-1")),
                       ("inbox_prefix", ("h1",)), ("frame", ("pj-1",)), ("done", ("pj-1",)),
                       ("done_prefix", ()), ("claim", ("h1", 3)), ("retire", ("h1", 12)),
                       ("epoch", (7,))):
        assert getattr(k, name)(*args) == getattr(jk, name)(*args), name
    assert tpod.__all__ == jpod.__all__


# -- end-to-end over live nodes ------------------------------------------------


def test_single_node_end_to_end(tmp_path):
    st = _store(tmp_path)
    X, y = _problem()
    with _node(st, "h0") as node:
        c = _client(st)
        _wait_live(c, ["h0"])
        pjid = c.submit(_spec(X, y))
        rec = c.wait(pjid, timeout=TIMEOUT)
        assert rec["state"] == DONE and rec["host"] == "h0"
        assert rec["iterations_done"] == 2
        assert rec["final_frame"] is not None
        frame = c.latest_frame(pjid)
        assert frame is not None and frame["n"] >= 1
        assert node.stats()["duplicate_results"] == 0
        assert set(c.results()) == {pjid}
        # warmth is advertised as the bucket of the job the host ran
        digest = bucket_digest(shape_bucket(X, y, None, _opts()))
        deadline = time.monotonic() + 10
        while digest not in c.hosts()["h0"]["warm"]:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert c.route(_spec(X, y)) == "h0"


def test_jax_client_reads_a_port_pod(tmp_path):
    """A JAX ``PodClient`` on the same directory sees the port node's ad
    (the same fields), waits on its done ledger and decodes its final frame
    with the JAX package's loader to the port's frontier."""
    st = _store(tmp_path)
    X, y = _problem()
    jc = jpod.PodClient(store=JFileCoordStore(st.root), suspect_seconds=0.6)
    with _node(st, "h0"):
        c = _client(st)
        _wait_live(c, ["h0"])
        assert set(jc.live_hosts()) == {"h0"}
        ad = jc.hosts()["h0"]
        assert {"host", "t", "gen", "pid", "queue_depth", "running", "warm", "draining",
                "adopted_jobs", "adopted_hosts", "duplicate_results",
                "skew_suspects_suppressed"} == set(ad)
        pjid = c.submit(_spec(X, y))
        rec = jc.wait(pjid, timeout=TIMEOUT)
        assert rec["state"] == DONE and rec["host"] == "h0"
        assert set(jc.results()) == {pjid}
        o = _opts()
        jfront = [(m.get_complexity(o), m.loss)
                  for m in j_load_frontier_bytes(rec["final_frame"]).members]
        assert jfront == _frontier(rec["final_frame"], o) and jfront


def test_jax_envelope_in_port_inbox_is_poison(tmp_path):
    """A JAX ``PodClient`` drops a JAX ``JobSpec`` into a port node's inbox:
    the node deletes the envelope without running or tracking it, and a
    port job submitted after it runs."""
    st = _store(tmp_path)
    X, y = _problem()
    jc = jpod.PodClient(store=JFileCoordStore(st.root), suspect_seconds=0.6)
    with _node(st, "h0") as node:
        c = _client(st)
        _wait_live(c, ["h0"])
        bad = jc.submit(jserve.JobSpec(X, y, options=_jopts(), niterations=1), host="h0")
        key = f"srpod/pod0/inbox/h0/{bad}"
        deadline = time.monotonic() + 10
        while st.try_get(key) is not None:
            assert time.monotonic() < deadline, "the poison envelope was never deleted"
            time.sleep(0.02)
        good = c.submit(_spec(X, y, niterations=1), host="h0")
        assert c.wait(good, timeout=TIMEOUT)["state"] == DONE
        assert c.done(bad) is None
        assert node.stats()["tracked_jobs"] == 1
        assert node.server.stats()["jobs"] == {"done": 1}


def test_adopts_dead_host_journal_and_inbox(tmp_path):
    """A fabricated dead host left a journaled queued job AND an unconsumed
    inbox envelope behind a stale ad. The survivor claims the generation
    lease, adopts both, runs them, and publishes each result exactly once."""
    st = _store(tmp_path)
    X, y = _problem()
    pod_root = os.path.join(st.root, "_pod")
    spec_j = _spec(X, y)
    spec_j.label = "pj-journaled0001"
    jr = JobJournal(os.path.join(pod_root, "hx", "gen-0001"))
    jr.append_submit(Job("job-00001", spec_j, seq=1))
    jr.close()
    c = _client(st)
    pjid_inbox = c.submit(_spec(X, y, options=_opts(seed=3)), host="hx")
    _ad(st, "hx", t=time.time() - 30)

    with _node(st, "h0") as node:
        recs = c.wait_all(["pj-journaled0001", pjid_inbox], timeout=TIMEOUT)
        for rec in recs.values():
            assert rec["state"] == DONE and rec["host"] == "h0"
        stats = node.stats()
        assert stats["adopted_hosts"] == 1
        assert stats["adopted_jobs"] == 1  # the journaled one; inbox routes normally
        assert stats["duplicate_results"] == 0
    assert st.try_get("srpod/pod0/claim/hx/gen-0001") is not None
    ep = pickle.loads(st.try_get("srep/pod:pod0/1"))
    assert ep["event"] == "adopt" and ep["host"] == "hx" and ep["by"] == "h0"
    assert st.try_get("srpod/pod0/ad/hx") is None  # off the routing table


def test_adopted_terminal_job_reports_once_never_reruns(tmp_path):
    st = _store(tmp_path)
    X, y = _problem()
    spec = _spec(X, y)
    spec.label = "pj-finished00001"
    jr = JobJournal(os.path.join(st.root, "_pod", "hx", "gen-0001"))
    jr.append_submit(Job("job-00001", spec, seq=1))
    jr.append("terminal", "job-00001", state=DONE, error=None)
    jr.close()
    _ad(st, "hx", t=time.time() - 30)

    c = _client(st)
    with _node(st, "h0") as node:
        rec = c.wait("pj-finished00001", timeout=60)
        assert rec["state"] == DONE
        assert rec["from_journal_of"] == "hx"  # reported from the record
        srv = node.stats()["server"]
        assert srv["jobs"] == {} and srv["queued"] == 0  # never re-admitted
        assert node.stats()["duplicate_results"] == 0


def test_restart_after_adoption_starts_fresh_generation(tmp_path):
    """A host that reboots after its generation was adopted must not re-run
    jobs the adopter now owns: the claim lease forces a fresh generation."""
    st = _store(tmp_path)
    X, y = _problem()
    spec = _spec(X, y)
    spec.label = "pj-migrated00001"
    jr = JobJournal(os.path.join(st.root, "_pod", "hx", "gen-0001"))
    jr.append_submit(Job("job-00001", spec, seq=1))
    jr.close()
    _ad(st, "hx", t=time.time() - 30)

    c = _client(st)
    with _node(st, "h0") as h0:
        c.wait("pj-migrated00001", timeout=TIMEOUT)
        with _node(st, "hx") as hx:  # the dead host comes back
            assert hx.gen == 2  # gen-0001 is claimed: start a new journal
            assert hx.stats()["tracked_jobs"] == 0  # nothing re-admitted
            assert hx.server.stats()["queued"] == 0
        assert h0.stats()["duplicate_results"] == 0
    assert len(c.results()) == 1


def test_adopted_job_keeps_attempts_and_quarantines_past_budget(tmp_path):
    """``adopt_external`` (the survivor's side of a migration) keeps the
    dead host's attempt counter: a job already past the retry budget ends
    QUARANTINED on the survivor without running."""
    st = _store(tmp_path)
    X, y = _problem()
    spec = _spec(X, y)
    spec.label = "pj-poisoned00001"
    jr = JobJournal(os.path.join(st.root, "_pod", "hx", "gen-0001"))
    jr.append_submit(Job("job-00001", spec, seq=1))
    jr.append("start", "job-00001", attempts=3)
    jr.close()
    _ad(st, "hx", t=time.time() - 30)
    c = _client(st)
    with _node(st, "h0", job_retries=2) as node:
        rec = c.wait("pj-poisoned00001", timeout=60)
        assert rec["state"] == "quarantined" and rec["attempts"] == 3
        assert rec["iterations_done"] == 0
        assert node.stats()["server"]["quarantined"] == 1


def test_drain_hands_off_queued_jobs_to_survivor(tmp_path):
    """Graceful drain (the SIGTERM path, in-process): the draining host
    stops admission, journals its unfinished jobs, publishes a retirement
    marker, and a survivor adopts the generation without waiting out the
    suspicion window. Zero jobs lost, zero duplicated."""
    st = _store(tmp_path)
    X, y = _problem()
    c = _client(st)
    h1 = _node(st, "h1").start()
    try:
        _wait_live(c, ["h1"])
        pjids = [c.submit(_spec(X, y, options=_opts(seed=s)), host="h1") for s in range(3)]
        deadline = time.monotonic() + 30
        while h1.stats()["tracked_jobs"] < 3:
            assert time.monotonic() < deadline, "inbox never drained"
            time.sleep(0.02)
        assert h1.drain(timeout=60) is True
        assert h1.drain_seconds is not None
        assert st.try_get("srpod/pod0/retire/h1/gen-0001") is not None

        with _node(st, "h0") as h0:
            recs = c.wait_all(pjids, timeout=TIMEOUT)
            assert all(r["state"] == DONE for r in recs.values())
            assert {r["host"] for r in recs.values()} <= {"h0", "h1"}
            assert any(r["host"] == "h0" for r in recs.values())
            assert h0.stats()["duplicate_results"] == 0
        assert set(c.results()) == set(pjids)
        ep = pickle.loads(st.try_get("srep/pod:pod0/1"))
        assert ep["event"] == "handoff" and ep["host"] == "h1"
    finally:
        h1.stop()


def test_skewed_observer_never_adopts_live_host(tmp_path, monkeypatch):
    """An observer whose wall clock is +600 s sees every peer ad as ancient.
    It must not claim a live, heartbeating host's generation — yet a
    genuinely dead host, whose stamp stays frozen for a full suspect window,
    is still adopted under skew."""
    real_time = time.time

    def fake_skewed(host=None):
        return real_time() + (600.0 if host == "h0" else 0.0)

    monkeypatch.setattr(faults, "skewed_time", fake_skewed)
    store = _store(tmp_path)
    h0 = _node(store, "h0").start()
    h1 = _node(store, "h1").start()
    try:
        time.sleep(2.5)
        assert store.try_get(h0.keys.claim("h1", 1)) is None
        assert h0.stats()["skew_suspects_suppressed"] > 0
        assert h1.stats()["adopted_hosts"] == 0
        # only h0's stamps carry the skew
        ads = _client(store).hosts()
        assert ads["h0"]["t"] - ads["h1"]["t"] > 500
        h1.stop()
        deadline = real_time() + 30
        while store.try_get(h0.keys.claim("h1", 1)) is None:
            assert real_time() < deadline, "the skewed observer never adopted the dead host"
            time.sleep(0.05)
    finally:
        h0.stop()
        try:
            h1.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass


# -- PodClient wait backoff (tests/test_net.py's three) -------------------------


def test_poll_backoff_schedule(monkeypatch):
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "100")
    monkeypatch.setenv("SR_KV_BACKOFF_MAX_MS", "400")
    gen = _poll_backoff(0.05)
    got = [round(next(gen), 4) for _ in range(7)]
    assert got == [0.05, 0.05, 0.1, 0.2, 0.4, 0.4, 0.4]
    jgen = jpod._poll_backoff(0.05)
    assert got == [round(next(jgen), 4) for _ in range(7)]


def test_poll_backoff_cap_never_below_poll(monkeypatch):
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "0")
    monkeypatch.setenv("SR_KV_BACKOFF_MAX_MS", "10")
    gen = _poll_backoff(0.05)
    assert [next(gen) for _ in range(3)] == [0.05, 0.05, 0.05]


def test_pod_wait_backs_off_but_honors_deadline(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_KV_BACKOFF_MS", "20")
    monkeypatch.setenv("SR_KV_BACKOFF_MAX_MS", "200")
    cli = PodClient(store=FileCoordStore(str(tmp_path / "kv")), pod_id="t")
    sleeps: list[float] = []
    real_sleep = time.sleep
    monkeypatch.setattr(
        "symbolicregression_jl_tpu_torch.serve.pod.time.sleep",
        lambda s: (sleeps.append(s), real_sleep(min(s, 0.002)))[0],
    )
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        cli.wait("pj-none", timeout=0.5, poll=0.01)
    assert time.monotonic() - t0 < 5.0
    assert len(sleeps) >= 3
    assert max(sleeps) <= 0.2 + 1e-6
    assert any(b > a for a, b in zip(sleeps, sleeps[1:]))


# -- JobSpec decoding without the JAX package ----------------------------------


def test_decode_spec_port_and_foreign():
    X, y = _problem()
    spec = _spec(X, y, tenant="lab", label="pj-x")
    got = decode_spec(pickle.dumps(spec))
    assert isinstance(got, JobSpec) and got.tenant == "lab" and got.label == "pj-x"
    assert np.array_equal(got.X, X) and got.options.populations == 2
    jraw = pickle.dumps(jserve.JobSpec(X, y, options=_jopts(), niterations=1))
    with pytest.raises(ValueError, match="'spec' decodes to JobSpec, not JobSpec"):
        decode_spec(jraw)
    with pytest.raises(ValueError, match="undecodable JobSpec"):
        decode_spec(b"\x80\x05not a pickle")
    with pytest.raises(ValueError, match="'spec' decodes to dict, not JobSpec"):
        decode_spec(pickle.dumps({"spec": 1}))


@pytest.mark.parametrize("jax_mode", ["importable", "blocked"])
def test_port_refuses_jax_jobspec_without_importing_jax(tmp_path, jax_mode):
    """The port's ``NetServer`` submit op and ``SearchServer._recover`` (a
    journal holding a JAX ``JobSpec`` beside a port one) refuse the JAX spec
    with the held text; the process never imports jax or the JAX package,
    whether JAX is importable there or blocked."""
    X, y = _problem()
    raw = tmp_path / "jax_spec.pkl"
    raw.write_bytes(pickle.dumps(jserve.JobSpec(X, y, options=_jopts(), niterations=1)))
    jdir = tmp_path / "journal"
    jj = jserve.JobJournal(str(jdir))
    jj.append_submit(jserve.Job("job-00001", jserve.JobSpec(X, y, options=_jopts()), seq=1))
    jj.close()
    jr = JobJournal(str(jdir))
    jr.append_submit(Job("job-00002", _spec(X, y, niterations=1), seq=2))
    jr.close()
    block = "for m in ('jax', 'jaxlib', 'symbolicregression_jl_tpu'): sys.modules[m] = None"
    code = textwrap.dedent(f"""
        import asyncio, sys
        {block if jax_mode == "blocked" else ""}
        sys.path.insert(0, {str(ROOT)!r})
        from symbolicregression_jl_tpu_torch.serve import NetServer, SearchServer
        raw = open({str(raw)!r}, "rb").read()
        srv = SearchServer(max_concurrency=1, journal_dir={str(jdir)!r})
        net = NetServer(srv, port=0)
        try:
            asyncio.run(net._op_submit(None, {{"spec": raw}}))
            print("accepted")
        except ValueError as e:
            print("refused:", e)
        print("recovered", srv._recovered["dropped"], srv._recovered["queued"])
        srv.shutdown(wait=False)
        print("jax", any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                         or m == "symbolicregression_jl_tpu"
                         for m in sys.modules if sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "refused: 'spec' decodes to JobSpec, not JobSpec", out.stdout
    assert lines[1] == "recovered 1 1"  # the JAX record dropped, the port's queued
    assert lines[2] == "jax False"
