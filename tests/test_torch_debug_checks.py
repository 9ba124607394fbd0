"""The port's debug-checks gate (``analysis/ir_verify.debug_checks_enabled``)
and its gated verify sites, ported from the JAX package's
``tests/test_ir_verify.py`` (``test_gate_resolution``,
``test_flag_off_makes_zero_verifier_calls``,
``test_env_var_gates_device_scheduler``).

With the gate on, the flat-IR verifier runs at every site of the port that
it gates: the lockstep scorer's batches (``models/scorer.py``), the device
engine's frontier readback (``device_search._bs_to_members``) and its
population decode (``device_search._decode_state_populations``), the
latter on one device and on a mesh of two CPU shards, whose state it
decodes from the shards.
"""

import numpy as np
import pytest

from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch.analysis import ir_verify
from symbolicregression_jl_tpu_torch.analysis.ir_verify import debug_checks_enabled


def test_gate_resolution(monkeypatch):
    monkeypatch.delenv("SR_DEBUG_CHECKS", raising=False)
    assert debug_checks_enabled() is False

    class O:
        debug_checks = None

    assert debug_checks_enabled(O()) is False
    monkeypatch.setenv("SR_DEBUG_CHECKS", "1")
    assert debug_checks_enabled() is True
    assert debug_checks_enabled(O()) is True
    O.debug_checks = False  # explicit Options value beats the env
    assert debug_checks_enabled(O()) is False
    monkeypatch.delenv("SR_DEBUG_CHECKS")
    O.debug_checks = True
    assert debug_checks_enabled(O()) is True


def _problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y


def _opts(tmp_path, **kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=10, ncycles_per_iteration=6, maxsize=10, seed=0,
                scheduler="lockstep", save_to_file=False, device="cpu",
                checkpoint_file=str(tmp_path / "ck.pkl"))
    base.update(kw)
    return Options(**base)


def _count_verify_calls(monkeypatch):
    """Count the verifier's calls, by site (its ``where`` prefix)."""
    calls = {"n": 0, "where": set()}
    real = ir_verify.verify_flat_trees

    def counting(*a, **kw):
        calls["n"] += 1
        calls["where"].add(kw.get("where", "").split(":")[0])
        return real(*a, **kw)

    monkeypatch.setattr(ir_verify, "verify_flat_trees", counting)
    return calls


def test_flag_off_makes_zero_verifier_calls(monkeypatch, tmp_path):
    monkeypatch.delenv("SR_DEBUG_CHECKS", raising=False)
    calls = _count_verify_calls(monkeypatch)
    X, y = _problem()
    equation_search(X, y, niterations=1, options=_opts(tmp_path), verbosity=0)
    equation_search(X, y, niterations=1, options=_opts(tmp_path, scheduler="device"),
                    verbosity=0)
    assert calls["n"] == 0


def test_flag_on_verifies_the_lockstep_scorer(monkeypatch, tmp_path):
    monkeypatch.delenv("SR_DEBUG_CHECKS", raising=False)
    calls = _count_verify_calls(monkeypatch)
    X, y = _problem()
    res = equation_search(X, y, niterations=2,
                          options=_opts(tmp_path, debug_checks=True, checkpoint_every=1),
                          verbosity=0)
    assert "scorer.loss_many_async" in calls["where"]
    assert len(res.hall_of_fame.pareto_frontier()) >= 1


@pytest.mark.parametrize("shards", [1, 2])
def test_env_var_gates_device_scheduler(monkeypatch, tmp_path, shards):
    """``SR_DEBUG_CHECKS=1`` turns on the device engine's sites: the
    frontier readback every iteration, the population decode of each
    snapshot and of the final state, on one device and on two shards."""
    monkeypatch.setenv("SR_DEBUG_CHECKS", "1")
    calls = _count_verify_calls(monkeypatch)
    X, y = _problem()
    res = equation_search(X, y, niterations=2,
                          options=_opts(tmp_path, scheduler="device", checkpoint_every=1,
                                        mesh_devices=["cpu"] * shards),
                          verbosity=0)
    assert ("mesh" in res.engine_stats) == (shards > 1)
    assert {"device_search._bs_to_members",
            "device_search._decode_state_populations"} <= calls["where"]
    assert calls["n"] >= 2 + 3
    assert len(res.hall_of_fame.pareto_frontier()) >= 1
