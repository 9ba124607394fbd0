"""Scikit-learn-style estimators: SRRegressor / MultitargetSRRegressor.

Copy of ``symbolicregression_jl_tpu/regressor.py`` over the PyTorch search
(``from_file`` reads hall-of-fame CSVs through utils/checkpoint.py).

The framework's counterpart of the reference's MLJ interface
(SymbolicRegression.jl/src/MLJInterface.jl): `SRRegressor` embeds every search
hyperparameter as a constructor keyword (the reference metaprograms its model
struct from the Options kwargs, :33-86), `fit` runs `equation_search` and —
when `warm_start=True` and the model was already fitted — resumes from the
saved state exactly like MLJ `update` re-enters with `saved_state`
(:118-202). `predict` evaluates the selected equation with an optional
per-call index, mirroring `predict(mach, (data=..., idx=...))` (:346-388).

Data layout follows scikit-learn: X is (n_samples, n_features), y is
(n_samples,) or (n_samples, n_outputs) — transposed internally to the
engine's feature-major layout (reference does the same table->matrix
transpose, :218-229).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from .options import Options
from .search import SearchResult, equation_search

__all__ = ["SRRegressor", "MultitargetSRRegressor"]

# runtime (non-Options) constructor keywords, mirroring the reference's extra
# model fields (SymbolicRegression.jl/src/MLJInterface.jl:68-86)
_RUNTIME_KEYS = ("niterations", "verbosity", "selection_method", "warm_start")

_OPTION_KEYS = tuple(
    f.name for f in dataclasses.fields(Options) if f.init
)


def _default_selection(rows: list[dict]) -> int:
    """choose_best: highest score among frontier rows with loss <= 1.5x min
    (SymbolicRegression.jl/src/MLJInterface.jl:399-408). Returns an index into rows."""
    losses = [r["loss"] for r in rows]
    min_loss = min(losses)
    eligible = [i for i, l in enumerate(losses) if l <= 1.5 * min_loss]
    return max(eligible, key=lambda i: rows[i]["score"])


class SRRegressor:
    """Symbolic-regression estimator with the scikit-learn protocol.

    Parameters: every `Options` field plus `niterations`, `verbosity`,
    `selection_method` (rows -> index), and `warm_start` (resume from the
    previous fit's state on refit).
    """

    _multitarget = False

    def __init__(
        self,
        niterations: int = 10,
        verbosity: int = 0,
        selection_method: Callable | None = None,
        warm_start: bool = False,
        **option_kwargs: Any,
    ):
        unknown = set(option_kwargs) - set(_OPTION_KEYS)
        if unknown:
            raise TypeError(f"unknown parameters: {sorted(unknown)}")
        self.niterations = niterations
        self.verbosity = verbosity
        self.selection_method = selection_method
        self.warm_start = warm_start
        self._option_kwargs = dict(option_kwargs)
        for k, v in option_kwargs.items():
            setattr(self, k, v)
        self.state_: Any = None  # SearchResult | list[SearchResult]

    # -- sklearn protocol ----------------------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        out = {k: getattr(self, k) for k in _RUNTIME_KEYS}
        out.update({k: getattr(self, k) for k in self._option_kwargs})
        return out

    def set_params(self, **params) -> "SRRegressor":
        for k, v in params.items():
            if k in _RUNTIME_KEYS:
                setattr(self, k, v)
            elif k in _OPTION_KEYS:
                self._option_kwargs[k] = v
                setattr(self, k, v)
            else:
                raise ValueError(f"unknown parameter {k!r}")
        return self

    def _make_options(self) -> Options:
        return Options(**{k: getattr(self, k) for k in self._option_kwargs})

    @classmethod
    def from_file(
        cls,
        path,
        *,
        variable_names: list[str] | None = None,
        niterations: int = 10,
        verbosity: int = 0,
        selection_method: Callable | None = None,
        n_outputs: int | None = None,
        **option_kwargs: Any,
    ):
        """Restore an estimator from hall-of-fame CSV checkpoint(s) written
        by a previous fit (``save_to_file`` / ``output_file``) of either
        package — the PySR-style resume path; the reference ecosystem's
        ``from_file`` counterpart (its core CSV is write-only).
        ``option_kwargs`` must recreate the operator set the file was
        written with.

        ``predict`` / ``equations_`` / ``full_report`` work immediately on
        the restored frontier; a subsequent ``fit`` warm-starts from it
        (losses are rescored against the new data). Multitarget: pass one
        path per output (the ``{base}.out{j}`` files) plus ``n_outputs`` so
        a wrong path count fails here instead of on a later fit."""
        import os

        from .utils.checkpoint import load_saved_state

        option_kwargs.pop("warm_start", None)  # from_file always warm-starts
        model = cls(
            niterations=niterations,
            verbosity=verbosity,
            selection_method=selection_method,
            warm_start=True,
            **option_kwargs,
        )
        options = model._make_options()
        paths = (
            [path]
            if isinstance(path, (str, bytes, os.PathLike))
            else list(path)
        )
        if not cls._multitarget and n_outputs not in (None, 1):
            raise ValueError(
                f"SRRegressor is single-output (got n_outputs={n_outputs}); "
                "use MultitargetSRRegressor.from_file"
            )
        if not cls._multitarget and len(paths) != 1:
            raise ValueError("SRRegressor.from_file takes exactly one path")
        if cls._multitarget and n_outputs is not None and len(paths) != n_outputs:
            raise ValueError(
                f"MultitargetSRRegressor.from_file got {len(paths)} checkpoint "
                f"path(s) but n_outputs={n_outputs}; pass one path per output"
            )
        states = [
            load_saved_state(p, options, variable_names) for p in paths
        ]
        model.state_ = states if cls._multitarget else states[0]
        model.options_ = options
        model.feature_names_in_ = variable_names
        return model

    # -- fit / predict -------------------------------------------------------

    def _check_y(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y)
        if self._multitarget:
            if y.ndim != 2:
                raise ValueError(
                    "MultitargetSRRegressor needs y of shape (n_samples, n_outputs); "
                    "use SRRegressor for single-output problems"
                )
            return y.T  # -> (n_outputs, n_samples)
        if y.ndim != 1:
            raise ValueError(
                "SRRegressor needs y of shape (n_samples,); "
                "use MultitargetSRRegressor for multi-output problems"
            )
        return y

    def fit(
        self,
        X,
        y,
        *,
        weights=None,
        variable_names: list[str] | None = None,
        X_units=None,
        y_units=None,
    ) -> "SRRegressor":
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be (n_samples, n_features)")
        yt = self._check_y(y)
        options = self._make_options()
        saved = self.state_ if (self.warm_start and self.state_ is not None) else None
        if saved is not None and self._multitarget:
            n_saved = len(saved) if isinstance(saved, list) else 1
            if n_saved != yt.shape[0]:
                raise ValueError(
                    f"warm start carries {n_saved} saved output state(s) but y "
                    f"has {yt.shape[0]} outputs (from_file needs one checkpoint "
                    "path per output)"
                )
        self.state_ = equation_search(
            X.T,
            yt,
            weights=weights,
            options=options,
            niterations=self.niterations,
            variable_names=variable_names,
            saved_state=saved,
            verbosity=self.verbosity,
            X_units=X_units,
            y_units=y_units,
        )
        self.options_ = options
        self.n_features_in_ = X.shape[1]
        self.feature_names_in_ = variable_names
        return self

    def _results(self) -> list[SearchResult]:
        if self.state_ is None:
            raise RuntimeError("call fit() first")
        return self.state_ if isinstance(self.state_, list) else [self.state_]

    def _selected_rows(self, idx=None) -> list[tuple[dict, list[dict]]]:
        """Per output: (selected row, all rows)."""
        select = self.selection_method or _default_selection
        out = []
        for j, res in enumerate(self._results()):
            rows = res.report()
            if not rows:
                raise RuntimeError("empty hall of fame")
            if idx is None:
                k = select(rows)
            else:
                idx_j = idx[j] if isinstance(idx, (list, tuple)) else idx
                matches = [
                    i for i, r in enumerate(rows) if r["complexity"] == idx_j
                ]
                k = matches[0] if matches else select(rows)
            out.append((rows[k], rows))
        return out

    def predict(self, X, idx=None) -> np.ndarray:
        """Evaluate the selected equation(s) on X (n_samples, n_features).
        ``idx`` selects by complexity (per output when a list), mirroring the
        reference's `(data=..., idx=...)` form
        (SymbolicRegression.jl/src/MLJInterface.jl:346-388). Failed evaluations
        return zeros with a warning, like the reference's fallback (:335-344)."""
        import warnings

        X = np.asarray(X)
        if X.dtype.kind == "c":
            raise NotImplementedError(
                "complex evaluation is not ported to the PyTorch package yet "
                "(ROADMAP.md, A, slice 2: complex dtypes)"
            )
        selected = list(zip(self._selected_rows(idx), self._results()))
        X = X.astype(np.float64)
        preds = []
        for (row, _rows), res in selected:
            tree = row["member"].tree
            out = tree.eval_np(X.T, res.options.operators)
            if not np.all(np.isfinite(out)):
                warnings.warn(
                    "selected equation produced non-finite values; replacing with 0"
                )
                out = np.where(np.isfinite(out), out, 0.0)
            preds.append(out)
        if self._multitarget:
            return np.stack(preds, axis=1)
        return preds[0]

    def score(self, X, y) -> float:
        """R^2 of the selected equation (sklearn convention)."""
        y = np.asarray(y, dtype=np.float64)
        pred = self.predict(X)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y, axis=0)) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-300)

    # -- reporting -----------------------------------------------------------

    @property
    def equations_(self):
        """Frontier rows per output (list for multitarget)."""
        reports = [res.report() for res in self._results()]
        return reports if self._multitarget else reports[0]

    def get_best(self, idx=None):
        """Selected PopMember(s) (reference full_report best_idx semantics)."""
        picked = [row["member"] for row, _ in self._selected_rows(idx)]
        return picked if self._multitarget else picked[0]

    def full_report(self) -> dict:
        """best_idx, equations, strings, losses, complexities, scores
        (SymbolicRegression.jl/src/MLJInterface.jl:89-113)."""
        select = self.selection_method or _default_selection
        reports = []
        for res in self._results():
            rows = res.report()
            reports.append(
                {
                    "best_idx": select(rows) if rows else None,
                    "equations": [r["member"].tree for r in rows],
                    "equation_strings": [r["equation"] for r in rows],
                    "losses": [r["loss"] for r in rows],
                    "complexities": [r["complexity"] for r in rows],
                    "scores": [r["score"] for r in rows],
                }
            )
        return {"outputs": reports} if self._multitarget else reports[0]


class MultitargetSRRegressor(SRRegressor):
    """Multi-output variant: y is (n_samples, n_outputs); one independent
    search per output (reference: MultitargetSRRegressor,
    SymbolicRegression.jl/src/MLJInterface.jl:85-86,231-248)."""

    _multitarget = True
