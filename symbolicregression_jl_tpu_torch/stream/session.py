"""StreamSession: a long-lived fleet lane whose rows are updated live.

Counterpart of ``symbolicregression_jl_tpu/stream/session.py``. The session
keeps its rows in a power-of-two **row bucket** (``ops/scoring.pad_rows_np``:
pad rows replicate row 0 at weight 0, and the losses are those of the real
rows), and turns every ``push_rows`` / ``replace_rows`` into a write of the
lane's resident tensors:

- updates are staged on the host under a lock and applied by
  ``fleet_search``'s ``data_update_hook`` at the next iteration boundary, on
  the engine thread, so no device work crosses threads;
- while the row count stays within the bucket, the swap is a ``copy_`` into
  the lane's resident X, y, w and norm, views of its slice of the fleet's
  lane-axis stack (``models/device_search.LaneDataUpdate``): every kernel
  (B3's evolve block, B1 and B2 under the BFGS, B1 in the simplify
  rescoring) reads the new rows through the same pointers, and nothing is
  built or allocated for the lane;
- when the rows overflow the bucket, the session ends the epoch at the next
  boundary and restarts the lane warm (the previous populations and the SAME
  live hall of fame) on the next bucket, counted in ``recompile_events``
  (the JAX package's name: there a new bucket compiles new programs; here
  it rebuilds the lane's tensors and state, and compiles nothing);
- a :class:`~.drift.DriftDetector` compares each incoming batch's loss under
  the current best expression with the frontier-loss EMA; on drift the hall
  of fame is rescored on the new rows and the lane's parsimony-frequency
  histogram resets, so the search adapts instead of defending stale
  equations.

Frontier frames are the format-2 wire encoding
(``utils/checkpoint.dump_frontier_bytes``) with ``niterations=0``, the
sentinel of an endless session.

Requires fleet-eligible Options (the device scheduler) with
``warmup_maxsize_by == 0``: a session is open-ended, and the maxsize warmup
schedules complexity against a finite budget. ``timeout_in_seconds``,
``max_evals`` and early stop hold per epoch through the fleet loop and end
the session.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .drift import DriftConfig, DriftDetector

__all__ = ["StreamSession", "StreamStats", "next_row_bucket"]

_ENDLESS = 1 << 30  # an epoch's iteration budget: the callback is the stop


def next_row_bucket(n: int, minimum: int = 64) -> int:
    """The power-of-two row bucket >= n (at least ``minimum``). Doubling
    bounds the number of epoch restarts of a session at O(log rows)."""
    if n < 1:
        raise ValueError("need at least one row")
    b = max(1, int(minimum))
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class StreamStats:
    """Host-side session counters (the engine thread writes, anyone reads)."""

    iterations: int = 0
    epochs: int = 0
    rows: int = 0
    row_bucket: int = 0
    updates_applied: int = 0
    drifts: int = 0
    rescores: int = 0
    # best frontier loss right after the latest drift rescore: the honest
    # loss on the new regime, before the next iteration adapts the members
    last_rescore_best: float | None = None
    frames: int = 0
    recompile_events: int = 0  # epoch restarts on a grown bucket: epochs - 1
    num_evals: float = 0.0

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class StreamSession:
    """One long-lived search over a live dataset. Typical use::

        session = StreamSession(X0, y0, options)
        session.start()                       # engine thread
        session.push_rows(X_new, y_new)       # applied next iteration
        frame = session.wait_for_frame(after=0, timeout=30)
        ...
        result = session.stop()               # SearchResult

    ``run()`` drives the engine on the calling thread instead;
    ``request_stop()`` is the non-blocking cancel either way. ``on_frame(bytes)``
    fires for every frontier frame emitted.
    """

    def __init__(
        self,
        X,
        y,
        options,
        weights=None,
        *,
        row_bucket: int | None = None,
        min_row_bucket: int = 64,
        window: int | None = None,
        drift=None,
        stream_every: int = 1,
        on_frame=None,
        niterations: int | None = None,
        label: str = "stream",
    ):
        from ..models.device_search import fleet_eligibility
        from ..models.hall_of_fame import HallOfFame
        from ..utils.checkpoint import options_fingerprint

        X, y = np.asarray(X), np.asarray(y)
        if X.ndim != 2 or y.ndim != 1 or X.shape[1] != y.shape[0]:
            raise ValueError(
                f"expected X [features, rows] and y [rows]; got {X.shape} and {y.shape}"
            )
        # the session owns the weight channel: explicit weights from the
        # start keep the lane's ScoreData structure for every later swap
        w = np.ones(y.shape, dtype=y.dtype) if weights is None else np.asarray(weights)
        if w.shape != y.shape:
            raise ValueError(f"weights shape {w.shape} != y shape {y.shape}")

        base = dataclasses.replace(
            options, save_to_file=False, progress=False, checkpoint_every=None,
            checkpoint_every_seconds=None,
        )
        reason = fleet_eligibility(base)
        if reason is not None:
            raise ValueError(f"options are not streamable: {reason}")
        if base.warmup_maxsize_by:
            raise ValueError(
                "streaming sessions are open-ended; warmup_maxsize_by schedules "
                "curmaxsize against a finite niterations — set it to 0"
            )
        self._user_callback = base.iteration_callback
        self._options = dataclasses.replace(base, iteration_callback=self._on_iteration)
        self._fingerprint = options_fingerprint(self._options)
        self._niterations = int(niterations) if niterations else _ENDLESS
        if self._niterations < 1:
            raise ValueError("niterations must be >= 1 (or None for endless)")
        if stream_every < 0:
            raise ValueError("stream_every must be >= 0 (0 disables frames)")
        self.stream_every = int(stream_every)
        self.on_frame = on_frame
        self.label = label
        self.min_row_bucket = int(min_row_bucket)
        self.window = None if window is None else int(window)
        if self.window is not None and self.window < 1:
            raise ValueError("window must be >= 1 rows")

        if drift is False:
            self._detector = None
        else:
            if drift is None:
                cfg = DriftConfig()
            elif isinstance(drift, DriftConfig):
                cfg = drift
            elif isinstance(drift, dict):
                cfg = DriftConfig(**drift)
            else:
                raise TypeError(f"drift must be DriftConfig|dict|False: {drift!r}")
            self._detector = DriftDetector(cfg)

        self._Xh, self._yh, self._wh = X.copy(), y.copy(), w.copy()
        n = y.shape[0]
        self._bucket = (
            next_row_bucket(n, self.min_row_bucket) if row_bucket is None else int(row_bucket)
        )
        if self._bucket < n:
            raise ValueError(f"row_bucket {self._bucket} < initial rows {n}")

        self.hof = HallOfFame(self._options.maxsize)
        self.stats = StreamStats(rows=int(n), row_bucket=self._bucket)
        self.latest_frame: bytes | None = None
        self.frame_count = 0
        self.error: str | None = None

        self._lock = threading.Lock()
        self._frame_cond = threading.Condition(self._lock)
        self._staged: list = []  # ("push"|"replace", X, y, w) in arrival order
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._epoch_end = False
        self._grow_to: int | None = None
        self._lane = None
        self._thread: threading.Thread | None = None
        self._result = None
        self._evals_base = 0.0
        self._t0 = time.time()

    # -- client surface -------------------------------------------------------
    def push_rows(self, X, y, weights=None) -> None:
        """Append rows to the live dataset at the next iteration boundary.
        Restarts the lane on a grown bucket (one recompile event) only when
        the rows overflow the bucket."""
        self._stage("push", X, y, weights)

    def replace_rows(self, X, y, weights=None) -> None:
        """Replace the whole dataset (same feature count) at the next
        iteration boundary."""
        self._stage("replace", X, y, weights)

    def _stage(self, kind: str, X, y, weights) -> None:
        X, y = np.asarray(X), np.asarray(y)
        if X.ndim != 2 or y.ndim != 1 or X.shape[1] != y.shape[0]:
            raise ValueError(
                f"expected X [features, rows] and y [rows]; got {X.shape} and {y.shape}"
            )
        if X.shape[0] != self._Xh.shape[0]:
            raise ValueError(
                f"feature count is fixed for a session: {self._Xh.shape[0]} != pushed "
                f"{X.shape[0]}"
            )
        w = np.ones(y.shape, dtype=y.dtype) if weights is None else np.asarray(weights)
        if w.shape != y.shape:
            raise ValueError(f"weights shape {w.shape} != y shape {y.shape}")
        if self._finished.is_set():
            raise RuntimeError("session has ended")
        with self._lock:
            self._staged.append((kind, X.copy(), y.copy(), w.copy()))

    def start(self) -> "StreamSession":
        if self._thread is not None:
            raise RuntimeError("session already started")
        self._thread = threading.Thread(
            target=self._run_guarded, name=f"sr-stream-{self.label}", daemon=True
        )
        self._thread.start()
        return self

    def request_stop(self) -> None:
        """Non-blocking: the engine stops at the next iteration boundary."""
        self._stop.set()

    def stop(self, wait: bool = True, timeout: float | None = 300.0):
        """Request a stop and (by default) wait for the engine to finish.
        Returns the final SearchResult (None if no epoch completed)."""
        self._stop.set()
        if wait:
            self._finished.wait(timeout)
            if self._thread is not None:
                self._thread.join(timeout)
        return self._result

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the session ends on its own (early stop, timeout,
        max_evals, error) or through stop(). True when finished."""
        return self._finished.wait(timeout)

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    @property
    def result(self):
        return self._result

    def frontier(self) -> list:
        """A snapshot of the live Pareto frontier (copied members)."""
        return [m.copy() for m in self.hof.pareto_frontier()]

    def wait_for_frame(self, after: int = 0, timeout: float | None = None) -> bytes | None:
        """Block until a frame with index > ``after`` exists (frames count
        from 1); returns the LATEST frame, or None on timeout or end."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._frame_cond:
            while self.frame_count <= after and not self._finished.is_set():
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._frame_cond.wait(0.2 if remaining is None else min(0.2, remaining))
            return self.latest_frame if self.frame_count > after else None

    # -- engine side ----------------------------------------------------------
    def run(self):
        """Drive the engine on the calling thread until stop or termination;
        returns the final SearchResult. ``start()`` runs it on a thread of
        its own."""
        from ..models.device_search import FleetLaneSpec, fleet_search
        from ..ops.scoring import pad_rows_np

        init_trees = None
        while True:
            with self._lock:
                Xh, yh, wh = self._Xh, self._yh, self._wh
            Xp, yp, wp = pad_rows_np(Xh, yh, wh, self._bucket)
            spec = FleetLaneSpec(
                X=Xp, y=yp, weights=wp, options=self._options, niterations=self._niterations,
                label=self.label, init_trees=init_trees, init_hof=self.hof,
            )
            self.stats.epochs += 1
            self.stats.row_bucket = self._bucket
            res = fleet_search([spec], data_update_hook=self._hook,
                               on_lanes_ready=self._adopt_lanes)[0]
            self._result = res
            self._evals_base += float(res.num_evals)
            self.stats.num_evals = self._evals_base
            if res.stop_reason == "callback" and self._epoch_end and not self._stop.is_set():
                # bucket overflow: restart the lane warm on the grown bucket
                self._epoch_end = False
                if self._grow_to is not None:
                    self._bucket = self._grow_to
                    self._grow_to = None
                self.stats.recompile_events += 1
                init_trees = [m.tree for pop in res.populations for m in pop.members]
                continue
            break
        self._finished.set()
        with self._frame_cond:
            self._frame_cond.notify_all()
        return self._result

    def _run_guarded(self) -> None:
        try:
            self.run()
        except BaseException as e:
            # surfaced through .error and the waiters woken before the thread
            # ends with its traceback: a session must not die silently
            self.error = f"{type(e).__name__}: {e}"
            self._finished.set()
            with self._frame_cond:
                self._frame_cond.notify_all()
            raise

    def _adopt_lanes(self, lanes) -> None:
        self._lane = lanes[0]

    def _hook(self, it: int):
        """``fleet_search``'s data_update_hook: merge the staged updates into
        the host rows and hand the lane a same-shape ScoreData to write in
        place, or end the epoch on bucket overflow."""
        with self._lock:
            if not self._staged:
                return None
            staged, self._staged = self._staged, []
        pushed: list = []
        replaced = False
        Xh, yh, wh = self._Xh, self._yh, self._wh
        for kind, Xn, yn, wn in staged:
            if kind == "replace":
                Xh, yh, wh = Xn, yn, wn
                replaced, pushed = True, []
            else:
                Xh = np.concatenate([Xh, Xn], axis=1)
                yh = np.concatenate([yh, yn])
                wh = np.concatenate([wh, wn.astype(yh.dtype)])
                pushed.append((Xn, yn, wn))
        if self.window is not None and yh.shape[0] > self.window:
            k = yh.shape[0] - self.window
            Xh, yh, wh = Xh[:, k:], yh[k:], wh[k:]
        with self._lock:
            self._Xh, self._yh, self._wh = Xh, yh, wh
        n = int(yh.shape[0])
        self.stats.rows = n
        if n > self._bucket:
            self._grow_to = next_row_bucket(n, self.min_row_bucket)
            self._epoch_end = True  # the iteration callback ends the epoch
            return None

        from ..models.device_search import LaneDataUpdate
        from ..ops.scoring import pad_rows_np

        lane = self._lane
        drifted = False
        if self._detector is not None:
            probe = [(Xh, yh, wh)] if replaced else pushed
            if probe:
                Xn = np.concatenate([p[0] for p in probe], axis=1)
                yn = np.concatenate([p[1] for p in probe])
                wn = np.concatenate([p[2] for p in probe])
                if yn.shape[0] <= self._bucket:
                    pl = self._probe_best_loss(lane, Xn, yn, wn)
                    if pl is not None:
                        drifted = self._detector.probe(pl)
                        self.stats.drifts = self._detector.drifts

        Xp, yp, wp = pad_rows_np(Xh, yh, wh, self._bucket)
        data, ds = lane.rebuild_score_data(Xp, yp, wp)
        if drifted and self._detector.config.rescore:
            self._rescore_frontier(lane, data)
            best = [m.loss for m in lane.hof.pareto_frontier()]
            if best:
                self._detector.rebase(min(best))
        self.stats.updates_applied += 1
        return {0: LaneDataUpdate(score_data=data, dataset=ds,
                                  reset_freq=drifted and self._detector.config.reset_freq)}

    def _score_members(self, lane, members, X, y, w) -> list:
        """Loss of each member's tree on the rows (X, y, w) on the lane's
        device: one call of the lane's scorer (one B1 launch on the card,
        which takes any batch and row count as it is), plus the dimensional
        penalty under units."""
        from ..models.device_search import _flat_to_tree
        from ..ops.evolve import dim_penalty_batch
        from ..ops.flat import flatten_trees

        trees = [m.tree for m in members]
        flat = flatten_trees(trees, lane.cfg.n_slots, dtype=lane.eng_dt)
        batch = _flat_to_tree(flat, lane.device, lane.vdt)
        losses = lane.scorer.losses(batch, X, y, w)
        if lane.ecfg.units_check:
            losses = losses.to(lane.vdt) + dim_penalty_batch(batch, lane.ecfg, lane.ctx)
        self._evals_probe(lane, len(trees))
        return losses.cpu().tolist()

    def _evals_probe(self, lane, n_trees: int) -> None:
        lane.host_evals += n_trees
        lane.num_evals = lane.device_evals + lane.host_evals

    def _probe_best_loss(self, lane, Xn, yn, wn) -> float | None:
        """The current best expression's loss on the incoming rows, as they
        are: B1 takes any row count, so they are not padded to the bucket."""
        from ..dataset import Dataset

        frontier = lane.hof.pareto_frontier()
        if not frontier:
            return None
        best = min(frontier, key=lambda m: m.loss)
        X, y, w = Dataset(Xn, yn, weights=wn).device_arrays(lane.eng_dt, lane.device)
        return float(self._score_members(lane, [best], X, y, w)[0])

    def _rescore_frontier(self, lane, data) -> None:
        """Drift response: recompute every hall-of-fame member's loss on the
        swapped rows, in place. A member whose loss is no longer finite
        leaves its slot (a NaN occupant would block it for good:
        HallOfFame.update's invariant)."""
        from ..ops.evolve import _score_of

        hof = lane.hof
        idx = [i for i, e in enumerate(hof.exists) if e]
        if not idx:
            return
        members = [hof.members[i] for i in idx]
        losses = self._score_members(lane, members, data.X, data.y, data.w)
        norm = float(data.norm)
        for i, m, lo in zip(idx, members, losses):
            if not np.isfinite(lo):
                hof.exists[i] = False
                continue
            m.loss = float(lo)
            m.score = float(_score_of(float(lo), float(m.get_complexity(lane.options)),
                                      lane.cfg, norm))
        self.stats.rescores += 1
        frontier = hof.pareto_frontier()
        if frontier:
            self.stats.last_rescore_best = float(min(m.loss for m in frontier))

    def _on_iteration(self, report):
        """The lane's iteration callback: EMA upkeep, frame emission, and
        the stop plumbing (user callback -> session stop -> epoch end)."""
        self.stats.iterations += 1
        if self._detector is not None:
            frontier = report.hall_of_fame.pareto_frontier()
            if frontier:
                self._detector.observe(min(m.loss for m in frontier))
        if self.stream_every and self.stats.iterations % self.stream_every == 0:
            self._emit_frame(report)
        user_stop = self._user_callback(report) if self._user_callback is not None else None
        if user_stop:
            self._stop.set()
        if self._stop.is_set() or self._epoch_end:
            return True
        return None

    def _emit_frame(self, report) -> None:
        from ..utils.checkpoint import dump_frontier_bytes

        if not report.hall_of_fame.pareto_frontier():
            # the pipelined readback's first report lags the hall of fame;
            # an empty frame is of no use to a subscriber
            return
        frame = dump_frontier_bytes(
            report.hall_of_fame,
            iteration=self.stats.iterations,
            niterations=0,  # sentinel: a session has no budget
            num_evals=self._evals_base + float(report.num_evals),
            fingerprint=self._fingerprint,
            wall_time=time.time() - self._t0,
        )
        with self._frame_cond:
            self.latest_frame = frame
            self.frame_count += 1
            self.stats.frames = self.frame_count
            self._frame_cond.notify_all()
        if self.on_frame is not None:
            self.on_frame(frame)
