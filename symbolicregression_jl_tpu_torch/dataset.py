"""Dataset container.

Counterpart of ``symbolicregression_jl_tpu/dataset.py`` (SymbolicRegression.jl
src/Dataset.jl:53-82): X is feature-major ``(n_features, n)``, y is ``(n,)``,
optional per-row weights, variable names, weighted ``avg_y`` and the mutable
baseline loss of the constant-avg_y predictor. Device copies of X/y/weights
are cached per (dtype, device) so every scoring call reuses resident buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Dataset"]


@dataclasses.dataclass
class Dataset:
    X: np.ndarray  # (n_features, n)
    y: np.ndarray | None  # (n,) — None allowed for custom full objectives
    weights: np.ndarray | None = None
    variable_names: list[str] | None = None
    y_variable_name: str | None = None
    extra: dict = dataclasses.field(default_factory=dict)
    X_units: Any = None
    y_units: Any = None

    n_features: int = dataclasses.field(init=False)
    n: int = dataclasses.field(init=False)
    avg_y: float | None = dataclasses.field(init=False)
    baseline_loss: float = dataclasses.field(init=False, default=1.0)
    use_baseline: bool = dataclasses.field(init=False, default=False)

    def __post_init__(self):
        if self.X_units is not None or self.y_units is not None:
            raise NotImplementedError(
                "units / dimensional analysis are not ported yet "
                "(ROADMAP.md, A, slice 2: units.py)"
            )
        self.X = np.asarray(self.X)
        if self.X.ndim != 2:
            raise ValueError(f"X must be (n_features, n); got shape {self.X.shape}")
        if self.X.dtype.kind == "c":
            raise NotImplementedError(
                "complex datasets are not ported yet "
                "(ROADMAP.md, A, slice 2: complex dtypes)"
            )
        self.n_features, self.n = self.X.shape
        if self.y is not None:
            self.y = np.asarray(self.y).reshape(-1)
            if self.y.shape[0] != self.n:
                raise ValueError(
                    f"y has {self.y.shape[0]} rows but X has {self.n} columns"
                )
        if self.weights is not None:
            self.weights = np.asarray(self.weights).reshape(-1)
            if self.weights.shape[0] != self.n:
                raise ValueError("weights length must match number of rows")
        if self.variable_names is None:
            self.variable_names = [f"x{i + 1}" for i in range(self.n_features)]
        if self.y is None:
            self.avg_y = None
        elif self.weights is not None:
            self.avg_y = float(np.sum(self.y * self.weights) / np.sum(self.weights))
        else:
            self.avg_y = float(np.mean(self.y))
        self._device_cache: dict = {}

    def device_arrays(self, dtype=np.float32, device="cuda"):
        """(X, y, weights) as contiguous tensors of ``dtype`` on ``device``,
        cached per (dtype, device)."""
        device = torch.device(device)
        key = (np.dtype(dtype), str(device))
        if key not in self._device_cache:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(device)

            X = put(self.X)
            y = None if self.y is None else put(self.y)
            w = None if self.weights is None else put(self.weights)
            self._device_cache[key] = (X, y, w)
        return self._device_cache[key]
