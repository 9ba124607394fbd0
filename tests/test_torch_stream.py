"""The stream session (``stream/session.py``, ``stream/drift.py``) and the
fleet's ``data_update_hook`` / ``on_lanes_ready``, on the CPU.

- The host-side units equal the JAX package's on the same inputs:
  ``next_row_bucket`` on a grid (errors included), ``DriftDetector``'s
  decisions, EMA and counts on seeded sequences with non-finite values,
  ``DriftConfig``'s validation, and the ``StreamSession`` constructor's
  rejections (the JAX constructor compiles nothing).
- ``_FleetLane.rebuild_score_data`` on the lane's own rows gives the lane's
  tensors bit for bit, and rejects other shapes or weight presence.
- The session on JAX's small options (tests/test_stream.py: 4 x 16, 40
  cycles, maxsize 14, 64 rows), driven a step at a time by a gate in the
  iteration callback: an identical ``replace_rows`` changes the trajectory
  in no bit; in-bucket pushes and replaces keep the lane's tensors (same
  ``data_ptr``) with no epoch restart; a swap reaches the kernels' lane-axis
  stack (the block's plain version) and the BFGS, which then read the new
  rows; overflow is one restart on the next bucket with the same hall of
  fame; drift rescores the frontier and resets the lane's frequencies.
- Frames decode with the port's ``load_frontier_bytes`` and with the JAX
  package's to equal members, and the same frontier framed by the JAX
  package decodes to equal members in both packages.
- The port's ``stream`` imports with jax blocked.
The JAX package's engine-driving stream tests are slow (AOT compiles), so
the session's engine runs are held to the port's own fleet and to the
JAX package's documented outcomes.
"""

import dataclasses
import math
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.ops import flat as jflat
from symbolicregression_jl_tpu.stream import DriftConfig as JDriftConfig
from symbolicregression_jl_tpu.stream import DriftDetector as JDriftDetector
from symbolicregression_jl_tpu.stream import StreamSession as JStreamSession
from symbolicregression_jl_tpu.stream import next_row_bucket as j_next_row_bucket
from symbolicregression_jl_tpu.utils import checkpoint as jck
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import device_search as tds
from symbolicregression_jl_tpu_torch.models.device_search import (
    FleetLaneSpec,
    LaneDataUpdate,
    fleet_search,
)
from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np
from symbolicregression_jl_tpu_torch.stream import (
    DriftConfig,
    DriftDetector,
    StreamSession,
    next_row_bucket,
)
from symbolicregression_jl_tpu_torch.utils import checkpoint as tck

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (an earlier module in this process may have turned
    x64 on) and one torch thread, as the fleet tests run."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _problem(n=100, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


_SMALL = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
              population_size=16, ncycles_per_iteration=40, maxsize=14, save_to_file=False,
              seed=0, scheduler="device")


def _opts(**kw):
    return T.Options(**dict(_SMALL, device="cpu", progress=False, **kw))


def _jopts(**kw):
    return J.Options(**dict(_SMALL, **kw))


# --------------------------------------------------------------------------
# Host-side units against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [-3, 0, 1, 3, 63, 64, 65, 1000, 10_000, 11_000])
def test_next_row_bucket_equals_jax(n):
    for minimum in (0, 1, 4, 64, 100, 10_240):
        try:
            want = j_next_row_bucket(n, minimum=minimum)
        except ValueError:
            with pytest.raises(ValueError):
                next_row_bucket(n, minimum=minimum)
            continue
        assert next_row_bucket(n, minimum=minimum) == want
    if n >= 1:
        assert next_row_bucket(n) == j_next_row_bucket(n)


def _drift_trace(det, ops):
    out = []
    for op, v in ops:
        r = getattr(det, op)(v)
        out.append((op, r, det.ema, det.observations, det.drifts))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_drift_detector_equals_jax(seed):
    """The same sequence of observe / probe / rebase, non-finite values
    included, gives the same decisions, EMA, observation and drift counts."""
    rng = np.random.default_rng(seed)
    cfg = dict(ratio=float(rng.uniform(1.2, 4.0)), ema_decay=float(rng.uniform(0.0, 0.95)),
               min_obs=int(rng.integers(1, 5)))
    ops = []
    for _ in range(200):
        kind = rng.choice(["observe", "probe", "rebase"], p=[0.5, 0.4, 0.1])
        v = float(np.exp(rng.normal(0.0, 1.5)))
        u = rng.uniform()
        if u < 0.05:
            v = math.inf
        elif u < 0.1:
            v = math.nan
        elif u < 0.12:
            v = -math.inf
        ops.append((str(kind), v))
    got = _drift_trace(DriftDetector(DriftConfig(**cfg)), ops)
    want = _drift_trace(JDriftDetector(JDriftConfig(**cfg)), ops)
    assert [g[:2] + g[3:] for g in got] == [w[:2] + w[3:] for w in want]
    for g, w in zip(got, want):
        assert (g[2] is None and w[2] is None) or g[2] == w[2]
    assert any(g[1] for g in got if g[0] == "probe")


@pytest.mark.parametrize("kw", [
    dict(ratio=0.0), dict(ratio=-1.0), dict(ema_decay=1.0), dict(ema_decay=1.5),
    dict(ema_decay=-0.1), dict(min_obs=0), dict(ratio=math.nan),
    dict(), dict(ratio=3.0, ema_decay=0.0, min_obs=1, rescore=False, reset_freq=False),
])
def test_drift_config_validation_equals_jax(kw):
    try:
        want = JDriftConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            DriftConfig(**kw)
        return
    assert dataclasses.asdict(DriftConfig(**kw)) == dataclasses.asdict(want)


def _constructor_cases():
    X, y = _problem(60)
    return [
        ("lockstep", lambda S, o: S(X, y, o(scheduler="lockstep"))),
        ("warmup", lambda S, o: S(X, y, o(warmup_maxsize_by=0.5))),
        ("row_bucket", lambda S, o: S(X, y, o(), row_bucket=32)),
        ("drift", lambda S, o: S(X, y, o(), drift=42)),
        ("drift_dict", lambda S, o: S(X, y, o(), drift={"ratio": 0.0})),
        ("window", lambda S, o: S(X, y, o(), window=0)),
        ("stream_every", lambda S, o: S(X, y, o(), stream_every=-1)),
        ("niterations", lambda S, o: S(X, y, o(), niterations=-2)),
        ("X_shape", lambda S, o: S(X[0], y, o())),
        ("rows", lambda S, o: S(X, y[:-1], o())),
        ("weights", lambda S, o: S(X, y, o(), np.ones(5, np.float32))),
        ("push_features", lambda S, o: S(X, y, o(), row_bucket=64).push_rows(
            np.zeros((3, 4), np.float32), np.zeros(4, np.float32))),
        ("push_weights", lambda S, o: S(X, y, o(), row_bucket=64).push_rows(
            np.zeros((2, 4), np.float32), np.zeros(4, np.float32), np.zeros(5, np.float32))),
        ("replace_shape", lambda S, o: S(X, y, o(), row_bucket=64).replace_rows(
            np.zeros((2, 4), np.float32), np.zeros(3, np.float32))),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _constructor_cases()])
def test_session_rejects_what_jax_rejects(case):
    """Each bad argument raises the JAX constructor's exception type (and
    its message's key word, as tests/test_stream.py matches it)."""
    make = dict(_constructor_cases())[case]
    with pytest.raises(Exception) as want:
        make(JStreamSession, _jopts)
    with pytest.raises(want.type) as got:
        make(StreamSession, _opts)
    assert type(got.value) is type(want.value)
    for word in ("streamable", "warmup_maxsize_by", "row_bucket", "feature count", "weights",
                 "window", "stream_every", "niterations"):
        assert (word in str(got.value)) == (word in str(want.value)), (got.value, want.value)


def test_session_accepts_what_jax_accepts():
    X, y = _problem(60)
    for kw in (dict(), dict(row_bucket=64, window=64, drift=False), dict(drift={"ratio": 3.0}),
               dict(niterations=5, stream_every=0, min_row_bucket=16)):
        s, j = StreamSession(X, y, _opts(), **kw), JStreamSession(X, y, _jopts(), **kw)
        assert dataclasses.asdict(s.stats) == dataclasses.asdict(j.stats)
        assert s._options.maxsize == j._options.maxsize and not s.finished


# --------------------------------------------------------------------------
# The fleet's hooks and the lane's data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_rebuild_score_data_is_bitwise(weighted):
    """The lane's own rows rebuild the lane's X, y, w and norm bit for bit
    (the prelude's arithmetic, ``_baseline_norm``); other shapes or weight
    presence raise ValueError."""
    X, y = _problem(64)
    w = np.linspace(0.5, 2.0, 64, dtype=np.float32) if weighted else None
    lane = tds._FleetLane(0, FleetLaneSpec(X=X, y=y, weights=w, options=_opts()), 64, False)
    data, ds = lane.rebuild_score_data(X, y, w)
    for got, want in zip(data, lane.data):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert got.data_ptr() != want.data_ptr()
    assert ds.baseline_loss == lane.dataset.baseline_loss
    with pytest.raises(ValueError, match="shapes"):
        lane.rebuild_score_data(X[:, :60], y[:60], None if w is None else w[:60])
    with pytest.raises(ValueError, match="shapes"):
        lane.rebuild_score_data(X, y, None if weighted else np.ones(64, np.float32))


def _spy_block(monkeypatch, calls):
    """Record what each launch of the block's plain version reads: the
    stacked data's pointers and values, and its outputs."""
    orig = tds.evolve_block_reference

    def spy(*args):
        out = orig(*args)
        X, y, w = args[-6:-3]
        calls.append(dict(args=args, ptrs=(X.data_ptr(), y.data_ptr(), w.data_ptr()),
                          X=X.clone(), y=y.clone(), w=w.clone(), out=out))
        return out

    monkeypatch.setattr(tds, "evolve_block_reference", spy)
    return orig


def test_swap_reaches_the_block_and_the_bfgs(monkeypatch):
    """After a swap to a shifted target at iteration 1, the block's plain
    version (on the lane-axis stack, whose views are the lane's tensors) and
    every BFGS gradient read
    the new rows through the same pointers: their outputs equal the same
    calls on a fresh lane's data on the new rows, and differ from the old
    rows'. ``on_lanes_ready`` hands over the live lanes."""
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    X, y = _problem(64)
    y_new = (y + 3.0).astype(np.float32)
    ones = np.ones(64, np.float32)
    opts = _opts()
    block_calls, grad_calls, lanes_seen = [], [], []
    orig_block = _spy_block(monkeypatch, block_calls)
    orig_grad = tds.EngineScorer.packed_loss_grad

    def grad_spy(self, prog, vals, Xd, yd, wd):
        out = orig_grad(self, prog, vals, Xd, yd, wd)
        grad_calls.append(dict(args=(prog, vals), ptr=Xd.data_ptr(), y=yd.clone(), out=out))
        return out

    monkeypatch.setattr(tds.EngineScorer, "packed_loss_grad", grad_spy)

    def hook(it):
        if it != 1:
            return None
        data, ds = lanes_seen[0].rebuild_score_data(X, y_new, ones)
        return {0: LaneDataUpdate(score_data=data, dataset=ds)}

    res = fleet_search([FleetLaneSpec(X=X, y=y, weights=ones, options=opts, niterations=3)],
                       data_update_hook=hook, on_lanes_ready=lanes_seen.extend)[0]
    assert len(lanes_seen) == 1 and isinstance(lanes_seen[0], tds._FleetLane)
    assert res.engine_stats["block"] == "plain" and len(block_calls) == 3
    assert np.array_equal(res.dataset.y, y_new)
    fresh = tds._FleetLane(0, FleetLaneSpec(X=X, y=y_new, weights=ones, options=opts),
                           64, False).data
    old = tds._FleetLane(0, FleetLaneSpec(X=X, y=y, weights=ones, options=opts), 64, False).data
    assert len({c["ptrs"] for c in block_calls}) == 1
    assert torch.equal(block_calls[0]["y"][0], old.y)
    for c in block_calls[1:]:
        assert torch.equal(c["y"][0], fresh.y) and torch.equal(c["X"][0], fresh.X)
        pop = c["args"][:-6]
        tail = c["args"][-3:]
        want = orig_block(*pop, fresh.X[None], fresh.y[None], fresh.w[None], *tail)
        stale = orig_block(*pop, old.X[None], old.y[None], old.w[None], *tail)
        assert all(torch.equal(a, b) for a, b in zip(c["out"], want))
        assert not all(torch.equal(a, b) for a, b in zip(c["out"], stale))
    lane_ptr = lanes_seen[0].data.X.data_ptr()
    assert grad_calls and all(c["ptr"] == lane_ptr for c in grad_calls)
    n_after = 0
    for c in grad_calls:
        if torch.equal(c["y"], fresh.y):
            n_after += 1
            f, g = orig_grad(lanes_seen[0].scorer, *c["args"], fresh.X, fresh.y, fresh.w)
            assert torch.equal(c["out"][0], f) and torch.equal(c["out"][1], g)
        else:
            assert torch.equal(c["y"], old.y)
    assert n_after >= 2  # iterations 2 and 3 optimize on the new rows


def test_hooks_reject_an_update_of_other_shapes():
    X, y = _problem(64)
    lanes = []

    def hook(it):
        data, ds = lanes[0].rebuild_score_data(X, y, None)
        bad = data._replace(X=data.X[:, :32], y=data.y[:32])
        return {0: LaneDataUpdate(score_data=bad, dataset=ds)}

    with pytest.raises(ValueError, match="ScoreData structure"):
        fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(), niterations=2)],
                     data_update_hook=hook, on_lanes_ready=lanes.extend)


# --------------------------------------------------------------------------
# The session, a step at a time
# --------------------------------------------------------------------------


class _Gate:
    """Holds the engine at every iteration boundary until the test lets it
    go on, so that a staged update lands at a chosen iteration (the JAX
    package's tests/test_stream.py gate)."""

    def __init__(self):
        self.release = threading.Semaphore(0)
        self.arrived = threading.Semaphore(0)

    def cb(self, report):
        self.arrived.release()
        self.release.acquire()
        return None

    def step(self, sess, n=1):
        for _ in range(n):
            self.release.release()
            assert self.arrived.acquire(timeout=TIMEOUT), sess.error


def _start_gated(X, y, gate, opts=None, **kw):
    sess = StreamSession(X, y, dataclasses.replace(opts or _opts(), iteration_callback=gate.cb),
                         stream_every=1, **kw)
    sess.start()
    assert gate.arrived.acquire(timeout=TIMEOUT), sess.error
    return sess


def _drain(sess, gate):
    sess.request_stop()
    gate.release.release()
    assert sess.wait(timeout=TIMEOUT), sess.error
    while gate.arrived.acquire(timeout=0.01):
        gate.release.release()
    return sess.result


def _sig(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def _ptrs(lane):
    return tuple(t.data_ptr() for t in lane.data)


def test_identical_replace_is_bitwise_noop():
    """Re-staging the current rows through replace_rows at iteration 1
    leaves the trajectory bit for bit as it was (JAX tests/test_stream.py's
    test_identical_push_is_bitwise_noop); only the evaluation count grows,
    by the drift probe's one tree."""
    X, y = _problem(n=64, seed=0)

    def run(touch):
        gate = _Gate()
        sess = _start_gated(X, y, gate, row_bucket=64)
        gate.step(sess)
        if touch:
            sess.replace_rows(X, y)
        gate.step(sess, 3)
        res = _drain(sess, gate)
        assert sess.error is None
        assert sess.stats.updates_applied == int(touch)
        return res

    a, b = run(False), run(True)
    assert _sig(a) == _sig(b)
    # the replace's drift probe scores the best member on the rows once
    assert b.num_evals == a.num_evals + 1


def test_in_bucket_updates_keep_the_lane_tensors():
    """30 pushes and replaces within the bucket under ``window=64``: every
    one written into the same tensors, no epoch restart (JAX
    tests/test_stream.py's test_hundred_updates_zero_recompiles)."""
    rng = np.random.default_rng(42)
    X, y = _problem(n=56, seed=0)
    gate = _Gate()
    sess = _start_gated(X, y, gate, row_bucket=64, window=64)
    ptrs = _ptrs(sess._lane)
    n_iters = 30
    for i in range(n_iters):
        if i % 3 == 2:
            Xr, yr = _problem(n=int(rng.integers(40, 64)), seed=200 + i)
            sess.replace_rows(Xr, yr)
        else:
            sess.push_rows(*_problem(n=2, seed=100 + i))
        gate.step(sess)
        assert _ptrs(sess._lane) == ptrs
    lane = sess._lane
    Xh, yh, wh = pad_rows_np(sess._Xh, sess._yh, sess._wh, 64)
    assert torch.equal(lane.data.y, torch.from_numpy(yh))
    assert torch.equal(lane.data.w, torch.from_numpy(wh))
    _drain(sess, gate)
    assert sess.error is None
    assert sess.stats.updates_applied >= n_iters - 1
    assert sess.stats.recompile_events == 0 and sess.stats.epochs == 1
    assert sess.stats.iterations >= n_iters


def test_bucket_overflow_is_one_recompile_event():
    """Growing past the bucket restarts the lane warm on the next power of
    two: one recompile event, the same hall of fame object (JAX
    tests/test_stream.py's test_bucket_overflow_is_one_recompile_event)."""
    X, y = _problem(n=60, seed=0)
    gate = _Gate()
    sess = _start_gated(X, y, gate, row_bucket=64)
    hof_before = sess.hof
    gate.step(sess)
    frontier_before = sess.frontier()
    sess.push_rows(*_problem(n=10, seed=7))
    gate.step(sess, 3)
    _drain(sess, gate)
    assert sess.error is None
    assert sess.stats.recompile_events == 1
    assert sess.stats.row_bucket == 128 and sess.stats.rows == 70
    assert sess.stats.epochs == 2
    assert sess.hof is hof_before and frontier_before
    assert sess.result is not None and sess.result.dataset.n == 128


def test_drift_rescores_and_resets_freq(monkeypatch):
    """A target shifted by +10 trips the detector: the frontier is rescored
    on the new rows (losses from near-fit to the shift's order) and the
    lane's frequency histogram is back to ones when the next iteration
    starts (JAX tests/test_stream.py's test_drift_triggers_rescore_and_freq_reset)."""
    freqs = []
    orig = tds.run_fleet_iteration_fused

    def spy(states, *a, **k):
        freqs.append(states[0].freq.clone())
        return orig(states, *a, **k)

    monkeypatch.setattr(tds, "run_fleet_iteration_fused", spy)
    X, y = _problem(n=64, seed=0)
    gate = _Gate()
    sess = _start_gated(X, y, gate, row_bucket=64)
    gate.step(sess, 4)
    lo_before = min(m.loss for m in sess.frontier())
    n_before = len(freqs)
    assert not torch.equal(freqs[-1], torch.ones_like(freqs[-1]))
    sess.replace_rows(X, (y + 10.0).astype(np.float32))
    gate.step(sess)
    assert sess.stats.drifts >= 1, sess.stats.summary()
    assert sess.stats.rescores >= 1
    assert sess.stats.last_rescore_best is not None
    assert sess.stats.last_rescore_best > 10 * lo_before
    assert torch.equal(freqs[n_before], torch.ones_like(freqs[n_before]))
    _drain(sess, gate)
    assert sess.error is None


def _members(update, operators):
    return [(m.complexity, m.loss, m.tree.string_tree(operators, precision=17))
            for m in update.members]


def test_frames_decode_in_both_packages():
    """Frames arrive and decode with the port's ``load_frontier_bytes``
    (niterations 0, the endless sentinel), ``stop()`` returns the result of
    a callback stop, the session's own frame decodes with the JAX package's
    loader (what a JAX subscriber reads) to the same members, and the same
    frontier framed by the JAX package decodes to equal members with either
    package's loader (JAX tests/test_stream.py's
    test_frames_stream_and_session_stops)."""
    X, y = _problem(n=64, seed=0)
    frames = []
    opts = _opts()
    sess = StreamSession(X, y, opts, row_bucket=64, stream_every=1, on_frame=frames.append)
    sess.start()
    frame = sess.wait_for_frame(after=0, timeout=TIMEOUT)
    assert frame is not None, sess.error
    res = sess.stop()
    assert sess.finished and sess.error is None
    assert res is not None and res.stop_reason == "callback"
    assert frames and frames[-1] == sess.latest_frame
    update = tck.load_frontier_bytes(frame)
    assert update.members and update.niterations == 0 and update.iteration >= 1
    want = _members(update, opts.operators)

    jopts = _jopts()
    jupdate = jck.load_frontier_bytes(frame)
    assert jupdate.niterations == 0 and jupdate.iteration == update.iteration
    assert jupdate.num_evals == update.num_evals
    assert _members(jupdate, jopts.operators) == want
    arrays = convert.flat_arrays([m.tree for m in update.members], opts.max_nodes,
                                 dtype=np.float64)
    flat = jflat.FlatTrees(**arrays)
    jhof = J.HallOfFame(jopts.maxsize)
    for i, m in enumerate(update.members):
        jhof.update(J.PopMember(jflat.unflatten_tree(flat, i), m.score, m.loss,
                                complexity=m.complexity), jopts)
    jframe = jck.dump_frontier_bytes(jhof, iteration=update.iteration, niterations=0,
                                     num_evals=update.num_evals,
                                     fingerprint=jck.options_fingerprint(jopts))
    for dec, ops in ((jck.load_frontier_bytes(jframe), jopts.operators),
                     (tck.load_frontier_bytes(jframe), opts.operators)):
        assert dec.niterations == 0 and dec.iteration == update.iteration
        assert _members(dec, ops) == want


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_error_surfaces_and_ends_the_session():
    """An exception on the engine thread (here the user's iteration
    callback) becomes ``error``, ends the session and wakes a frame waiter;
    a later push is refused."""
    X, y = _problem(n=64, seed=0)

    def boom(report):
        raise RuntimeError("callback failed")

    sess = StreamSession(X, y, _opts(iteration_callback=boom), row_bucket=64, stream_every=0)
    sess.start()
    assert sess.wait_for_frame(after=0, timeout=TIMEOUT) is None
    assert sess.wait(timeout=TIMEOUT) and sess.finished
    assert sess.error == "RuntimeError: callback failed"
    sess._thread.join(TIMEOUT)
    assert not sess._thread.is_alive()
    with pytest.raises(RuntimeError, match="ended"):
        sess.push_rows(X, y)


def test_stream_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import symbolicregression_jl_tpu_torch as T
        from symbolicregression_jl_tpu_torch.stream import (
            DriftConfig, DriftDetector, StreamSession, StreamStats, next_row_bucket)
        assert T.StreamSession is StreamSession and T.DriftDetector is DriftDetector
        assert next_row_bucket(65) == 128 and DriftDetector(DriftConfig()).ema is None
        from symbolicregression_jl_tpu_torch.models.hall_of_fame import HallOfFame
        from symbolicregression_jl_tpu_torch.utils import checkpoint as ck
        frame = ck.dump_frontier_bytes(HallOfFame(5), iteration=3)
        assert b"symbolicregression_jl_tpu.utils.checkpoint" in frame
        assert ck.load_frontier_bytes(frame).iteration == 3
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
