"""Runtime debug checks: :mod:`.ir_verify`, the FlatTrees invariant verifier
behind the ``Options.debug_checks`` / ``SR_DEBUG_CHECKS=1`` gate (a copy of
the JAX package's verifier, which imports no JAX)."""

from .ir_verify import FlatIRError, debug_checks_enabled, verify_flat_trees

__all__ = ["FlatIRError", "debug_checks_enabled", "verify_flat_trees"]
