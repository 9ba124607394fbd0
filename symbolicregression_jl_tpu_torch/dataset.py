"""Dataset container.

Counterpart of ``symbolicregression_jl_tpu/dataset.py`` (SymbolicRegression.jl
src/Dataset.jl:53-82): X is feature-major ``(n_features, n)``, y is ``(n,)``,
optional per-row weights, variable names, weighted ``avg_y``, the mutable
baseline loss of the constant-avg_y predictor, and the parsed SI units of X
and y (units.py). Device copies of X/y/weights
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
        self.X = np.asarray(self.X)
        if self.X.ndim != 2:
            raise ValueError(f"X must be (n_features, n); got shape {self.X.shape}")
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
        # avg_y keeps y's domain: complex datasets get a complex constant
        # predictor (its loss is still real, reference src/Dataset.jl:165)
        _scalar = complex if self.y is not None and self.y.dtype.kind == "c" else float
        if self.y is None:
            self.avg_y = None
        elif self.weights is not None:
            self.avg_y = _scalar(np.sum(self.y * self.weights) / np.sum(self.weights))
        else:
            self.avg_y = _scalar(np.mean(self.y))
        self._device_cache: dict = {}
        # parse units into rational-exponent SI quantities (reference:
        # SymbolicRegression.jl src/InterfaceDynamicQuantities.jl:24-66)
        from .units import parse_unit, parse_units_vector

        self.X_units_parsed = parse_units_vector(self.X_units, self.n_features)
        self.y_units_parsed = None if self.y_units is None else parse_unit(self.y_units)

    @property
    def has_units(self) -> bool:
        """Reference: has_units, SymbolicRegression.jl src/Dataset.jl:259-261."""
        return self.X_units_parsed is not None or self.y_units_parsed is not None

    def device_arrays(self, dtype=np.float32, device="cuda"):
        """(X, y, weights) as contiguous tensors of ``dtype`` on ``device``,
        cached per (dtype, device). A complex dtype stays on ``device`` (the
        card has complex arithmetic; the JAX package commits complex data to
        its CPU backend because XLA:TPU has none); the weights multiply a
        REAL elementwise loss, so they stay real (the reference's loss-type
        promotion, src/Dataset.jl:165)."""
        device = torch.device(device)
        key = (np.dtype(dtype), str(device))
        if key not in self._device_cache:
            def put(a, dt=dtype):
                return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(device)

            X = put(self.X)
            y = None if self.y is None else put(self.y)
            w_dtype = np.empty(0, dtype).real.dtype
            w = None if self.weights is None else put(self.weights, w_dtype)
            self._device_cache[key] = (X, y, w)
        return self._device_cache[key]
