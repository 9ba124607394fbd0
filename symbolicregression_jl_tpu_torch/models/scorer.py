"""BatchScorer: the host<->device boundary of the search.

Counterpart of ``symbolicregression_jl_tpu/models/scorer.py``. Every scoring
request of a lockstep cycle — all candidates of all islands — is evaluated
as ONE batched dispatch; host<->device traffic is packed tree programs in,
loss vectors out.

On f32 with built-in operators and a built-in real loss (``use_kernel``),
every scoring call — full data or a minibatch of any size — goes through the
fused loss kernel (ops/interp_cuda.fused_loss), which on a CPU tensor runs
its plain version. Under a full objective (``Options.loss_function_jit``)
the losses are the objective of the prediction matrix, which comes from B4
(``interp_cuda.objective_losses``) on f32 with built-in operators
(``use_kernel`` then means B4), whatever the elementwise loss. Anything else
(user operators or losses, f64, complex, a host ``loss_function``) takes the
plain interpreter, as the JAX scorer does when its Pallas probe fails.

Under ``graph_nodes`` a batch's flattening is re-pointed onto the postfix
stack (``interp_cuda.stack_sound_pointers``) before a kernel sees it: the
kernels decode on the stack, and a DAG's flattening points a shared
operand at its latest copy. The plain interpreter reads slots by pointer
and takes the flattening as it is.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.flat import flatten_trees
from ..ops.interp_cuda import (
    fused_loss, loss_kernel_eligible, objective_losses, optab_tensor, pack_programs_fused,
    preds_kernel_eligible, stack_sound_pointers,
)
from ..ops.operators import kernel_op_table
from ..ops.scoring import (
    batched_loss_bucketed, baseline_loss, loss_to_score, objective_loss_plain,
)
from ..serve.program_cache import global_program_cache
from ..tree import Node

__all__ = ["BatchScorer", "cached_optab"]


def cached_optab(opset, device) -> torch.Tensor | None:
    """The kernels' operator table of ``opset`` on ``device``
    (``interp_cuda.optab_tensor``), held for the process in the program
    cache (kind "optab", keyed on the table and the indexed card, so "cuda"
    and "cuda:0" share an entry and "cuda:1" has its own). A scorer looks it
    up once per search and hands it to every B1 and B2 launch it makes. None
    for an operator set the kernels do not take."""
    from ..parallel.mesh import indexed_device

    table = kernel_op_table(opset)
    if table is None:
        return None
    device = indexed_device(device)
    return global_program_cache().get_or_build(
        "optab", (table.tobytes(), str(device)), lambda: optab_tensor(opset, device))


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
        self.objective = options.loss_function_jit
        if self.objective is None:
            self.use_kernel = loss_kernel_eligible(self.opset, self.loss_elem, self.dtype)
        else:
            self.use_kernel = preds_kernel_eligible(self.opset, self.dtype)
        self.table = cached_optab(self.opset, self.device) if self.use_kernel else None
        # decided from Options, never probed: every other search keeps its
        # bits and host time
        self.repoint = bool(options.graph_nodes)
        bl, use = baseline_loss(dataset, self.opset, self.loss_elem, self.dtype, self.device)
        dataset.baseline_loss = bl
        dataset.use_baseline = use
        self.num_evals = 0.0
        #: scoring dispatches made (each one a B1 launch when use_kernel
        #: holds; under a full objective, a B4 launch)
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
        self._sharded = None
        if options.data_sharding == "rows":
            self._setup_row_sharding()

    def _setup_row_sharding(self) -> None:
        """Shard the dataset rows across the devices of ``Options.device``
        (``parallel.mesh.local_devices``: every card for "cuda", the one card
        for "cuda:N") and route full-data scoring through the row-sharded
        loss (``parallel/sharding.py``: only per-tree partials cross
        devices). With one device it returns at once, and the search is
        unchanged."""
        import warnings

        from ..parallel import mesh as mesh_mod
        from ..parallel.sharding import make_sharded_loss, shard_dataset

        devices = _row_devices(self.device)
        n_dev = len(devices)
        if n_dev == 1:
            return
        if self.dataset.n % n_dev != 0:
            warnings.warn(
                f"data_sharding='rows' needs n ({self.dataset.n}) divisible by "
                f"device count ({n_dev}); falling back to single-device scoring"
            )
            return
        mesh = mesh_mod.make_mesh(1, n_dev, devices=devices)
        self._mesh = mesh
        self._sharded = make_sharded_loss(
            mesh, self.opset, self.loss_elem, has_weights=self.w is not None
        )
        self._shards = shard_dataset(mesh, self.X, self.y, self.w)

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
        if self._sharded is not None and idx is None and self.objective is None:
            if self.repoint:
                flat = stack_sound_pointers(flat)
            fetch = _readback(self._sharded(flat, *self._shards))
        elif self.use_kernel:
            if self.repoint:
                flat = stack_sound_pointers(flat)
            prog, vals = pack_programs_fused(flat, self.opset)
            prog = torch.from_numpy(prog).to(self.device)
            vals = torch.from_numpy(vals).to(self.device)
            if self.objective is not None:
                dev_losses = objective_losses(prog, vals, X, y, w, self.opset, self.objective,
                                              self.table)
            else:
                dev_losses = fused_loss(prog, vals, X, y, w, self.opset, self.loss_elem,
                                        self.table)
            fetch = _readback(dev_losses)
        elif self.objective is not None:
            fetch = _readback(objective_loss_plain(flat, X, y, w, self.opset, self.objective))
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


def _row_devices(device: torch.device) -> list:
    """The devices ``data_sharding="rows"`` splits rows over: the search's
    ``parallel.mesh.local_devices``, as the device engine's mesh takes
    them."""
    from ..parallel.mesh import local_devices

    return local_devices(device)


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
