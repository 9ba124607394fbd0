"""BatchScorer: the host<->device boundary of the search.

Counterpart of ``symbolicregression_jl_tpu/models/scorer.py``. Every scoring
request of a lockstep cycle — all candidates of all islands — is evaluated
as ONE batched dispatch; host<->device traffic is packed tree programs in,
loss vectors out.

On f32 with built-in operators and a built-in real loss (``use_kernel``),
every scoring call — full data or a minibatch of any size — goes through the
fused loss kernel (ops/interp_cuda.fused_loss), which on a CPU tensor runs
its plain version. Anything else (user operators or losses, f64, a custom
objective) takes the plain interpreter, as the JAX scorer does when its
Pallas probe fails.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.flat import flatten_trees
from ..ops.interp_cuda import fused_loss, loss_kernel_eligible, pack_programs_fused
from ..ops.scoring import batched_loss_bucketed, baseline_loss, loss_to_score
from ..tree import Node

__all__ = ["BatchScorer"]


class BatchScorer:
    def __init__(self, dataset: Dataset, options):
        self.dataset = dataset
        self.options = options
        self.opset = options.operators
        self.loss_elem = options.loss
        self.dtype = options.dtype
        self.max_nodes = options.max_nodes
        self.device = torch.device(options.device)
        X, y, w = dataset.device_arrays(self.dtype, self.device)
        self.X, self.y, self.w = X, y, w
        self.use_kernel = loss_kernel_eligible(self.opset, self.loss_elem, self.dtype)
        bl, use = baseline_loss(dataset, self.opset, self.loss_elem, self.dtype, self.device)
        dataset.baseline_loss = bl
        dataset.use_baseline = use
        self.num_evals = 0.0
        #: scoring dispatches made (each one a fused-kernel call when
        #: use_kernel holds)
        self.num_dispatches = 0
        self._evals_lock = threading.Lock()
        # debug-checks gate resolved ONCE here: the hot path below branches on
        # a plain bool and makes zero verifier calls when off
        from ..analysis.ir_verify import debug_checks_enabled

        self._debug_checks = debug_checks_enabled(options)
        # dimensional regularization (reference SymbolicRegression.jl
        # src/LossFunctions.jl:217-227): an additive penalty on every scored
        # tree the host oracle flags, when the dataset carries units
        self._units_penalty = None
        if dataset.has_units:
            self._units_penalty = (
                1000.0
                if options.dimensional_constraint_penalty is None
                else float(options.dimensional_constraint_penalty)
            )

    # -- losses --------------------------------------------------------------

    def rows(self, idx: np.ndarray | None):
        """(X, y, w) for all rows or a row subset, on the device."""
        if idx is None:
            return self.X, self.y, self.w
        sel = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        return (
            self.X.index_select(1, sel),
            self.y.index_select(0, sel),
            None if self.w is None else self.w.index_select(0, sel),
        )

    def loss_many_async(self, trees: list[Node], idx: np.ndarray | None = None):
        """Dispatch a scoring batch WITHOUT blocking on the result.

        Returns a zero-arg callable that materializes the numpy losses. On
        the card the kernel launches on the current stream, the losses are
        copied into pinned host memory with ``non_blocking=True`` and a CUDA
        event is recorded; ``materialize()`` waits on that event, so the host
        keeps proposing/applying evolution events while the device computes
        and the readback is in flight."""
        if not trees:
            return lambda: np.zeros((0,))
        if self.options.loss_function is not None:
            return self._custom_objective(trees, idx)
        P = len(trees)
        flat = flatten_trees(trees, self.max_nodes, dtype=self.dtype)
        if self._debug_checks:
            from ..analysis import ir_verify

            ir_verify.verify_flat_trees(
                flat,
                self.opset,
                n_features=self.dataset.n_features,
                max_nodes=self.max_nodes,
                allow_empty=False,
                where="scorer.loss_many_async: ",
            )
        with self._evals_lock:
            self.num_evals += P if idx is None else P * (len(idx) / self.dataset.n)
            self.num_dispatches += 1
        X, y, w = self.rows(idx)
        if self.use_kernel:
            prog, vals = pack_programs_fused(flat, self.opset)
            dev_losses = fused_loss(
                torch.from_numpy(prog).to(self.device),
                torch.from_numpy(vals).to(self.device),
                X, y, w, self.opset, self.loss_elem,
            )
            fetch = _readback(dev_losses)
        else:
            fetch = batched_loss_bucketed(flat, X, y, w, self.opset, self.loss_elem)

        def materialize() -> np.ndarray:
            return self.apply_units_penalty(trees, fetch()[:P].astype(np.float64))

        return materialize

    def _custom_objective(self, trees: list[Node], idx):
        """Full-objective dispatch: the user's ``loss_function(tree, dataset,
        options)`` replaces elementwise eval entirely (SymbolicRegression.jl
        src/LossFunctions.jl:78-94). Host-side by nature."""
        P = len(trees)
        with self._evals_lock:
            self.num_evals += P if idx is None else P * (len(idx) / self.dataset.n)
        fn = self.options.loss_function

        def materialize() -> np.ndarray:
            out = np.empty(P, dtype=np.float64)
            for k, t in enumerate(trees):
                try:
                    v = float(fn(t, self.dataset, self.options))
                except Exception:  # noqa: BLE001 — invalid tree => inf loss
                    v = np.inf
                out[k] = v if np.isfinite(v) or v == np.inf else np.inf
            return out

        return materialize

    def loss_many(self, trees: list[Node], idx: np.ndarray | None = None) -> np.ndarray:
        """Full-data (or row-subset) losses for a batch of trees. Returns
        float64 numpy [len(trees)]; inf = invalid candidate."""
        return self.loss_many_async(trees, idx=idx)()

    def apply_units_penalty(self, trees: list[Node], losses: np.ndarray) -> np.ndarray:
        """Add the dimensional-regularization penalty to losses of ``trees``
        (every scored batch, and the constant optimizer's losses) so that
        unit-violating trees cannot enter populations or the hall of fame
        un-penalized."""
        if self._units_penalty is None or not len(trees):
            return losses
        from ..dimensional_analysis import violates_dimensional_constraints

        viol = np.fromiter(
            (violates_dimensional_constraints(t, self.dataset, self.options) for t in trees),
            dtype=bool, count=len(trees),
        )
        return np.asarray(losses) + viol * self._units_penalty

    def batch_indices(self, rng: np.random.Generator) -> np.ndarray | None:
        """With-replacement minibatch row indices (reference: batch_sample,
        SymbolicRegression.jl src/LossFunctions.jl:125-127); None when not
        batching."""
        if not self.options.batching:
            return None
        return rng.integers(0, self.dataset.n, size=self.options.batch_size)

    # -- scores --------------------------------------------------------------

    def score_of(self, loss: np.ndarray, complexity: np.ndarray) -> np.ndarray:
        return loss_to_score(
            loss,
            complexity,
            use_baseline=self.dataset.use_baseline,
            baseline=self.dataset.baseline_loss,
            parsimony=self.options.parsimony,
        )

    def score_trees(
        self, trees: list[Node], complexities, idx: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores, losses) for a batch of trees."""
        losses = self.loss_many(trees, idx=idx)
        scores = self.score_of(losses, np.asarray(complexities))
        return scores, losses


def _readback(dev: torch.Tensor):
    """Start the device->host copy of ``dev`` and return its materializer."""
    if dev.device.type != "cuda":
        return lambda: dev.numpy()
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev.device))

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch
