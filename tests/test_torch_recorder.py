"""The device engine's recorder (``use_recorder=True``), on the CPU.

The engine's legs log their events into tensors on the device, the readback
leg copies them to the host once per iteration, and
``models/device_recorder.EngineLineageReplay`` replays them into the
recorder while it keeps a tree mirror of every (island, member) slot. The
mirror must equal the engine's state slot for slot after every iteration,
and the recorder file must have the JAX engine's schema on the same
Options.
"""

import json

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.device_search as tds
from symbolicregression_jl_tpu_torch.models import device_recorder
from symbolicregression_jl_tpu_torch.ops.evolve_block import block_eligible
from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees

OPTS = dict(binary_operators=["+", "*"], unary_operators=["cos"], populations=2,
            population_size=12, ncycles_per_iteration=6, maxsize=10, seed=0,
            scheduler="device", save_to_file=False, progress=False, use_recorder=True,
            crossover_probability=0.0)


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (an earlier module may have enabled x64) and one
    torch thread (xdist workers share the cores)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _data():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2, 60)).astype(np.float32)
    return X, (X[0] * X[0] + np.cos(X[1])).astype(np.float32)


def _schema(path):
    data = json.loads(path.read_text())
    events = {e["type"] for m in data["mutations"].values() for e in m["events"]}
    entry_keys = {k for m in data["mutations"].values() for k in m}
    pops = sorted(k for k in data if k.startswith("out"))
    iters = {k: sorted(data[k]) for k in pops}
    return sorted(data), events, entry_keys, pops, iters


def test_recorder_file_has_the_jax_schema(tmp_path):
    X, y = _data()
    schemas = []
    for P, kw, name in ((J, {}, "jax.json"), (T, {"device": "cpu"}, "port.json")):
        rec = tmp_path / name
        opts = P.Options(recorder_file=str(rec), **OPTS, **kw)
        P.equation_search(X, y, options=opts, niterations=2, verbosity=0)
        schemas.append(_schema(rec))
    assert schemas[0] == schemas[1]
    keys, events, _, pops, iters = schemas[1]
    assert {"mutate", "death", "tuning"} <= events
    assert pops == ["out1_pop1", "out1_pop2"]
    assert all(v == ["iteration1", "iteration2"] for v in iters.values())


@pytest.mark.parametrize("kw", [dict(optimizer_algorithm="BFGS"),
                                dict(optimizer_algorithm="NelderMead", populations=3),
                                dict(batching=True, batch_size=20)],
                         ids=["bfgs", "neldermead", "batching"])
def test_replay_mirror_equals_engine_state_every_iteration(tmp_path, monkeypatch, kw):
    """After each iteration's replay (events, migrations, tuning, the
    simplify pool) the mirror's trees are the engine's, field for field."""
    X, y = _data()
    checked = []
    snap = device_recorder.EngineLineageReplay.snapshot_populations

    def check(self, arrays, iteration):
        kind, op, lhs, rhs, feat, val, length, loss, score = arrays
        I, P, N = kind.shape
        flat = flatten_trees(list(self.trees.reshape(-1)), N, dtype=val.dtype)
        for name, got, want in (("kind", flat.kind, kind), ("op", flat.op, op),
                                ("feat", flat.feat, feat), ("val", flat.val, val)):
            got = np.asarray(got).reshape(I, P, N)
            for i in range(I):
                for p in range(P):
                    n = length[i, p]
                    np.testing.assert_array_equal(got[i, p, :n], want[i, p, :n],
                                                  err_msg=f"{name} [{i}, {p}] it {iteration}")
        np.testing.assert_array_equal(np.asarray(flat.length).reshape(I, P), length)
        if not kw.get("batching"):
            np.testing.assert_array_equal(self.loss, loss.astype(np.float64))
        checked.append(iteration)
        snap(self, arrays, iteration)

    monkeypatch.setattr(device_recorder.EngineLineageReplay, "snapshot_populations", check)
    opts = T.Options(device="cpu", recorder_file=str(tmp_path / "r.json"),
                     **dict(OPTS, **kw))
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert checked == [1, 2, 3]
    assert res.engine_stats["block"] is None
    data = json.loads((tmp_path / "r.json").read_text())
    n_mut = sum(e["type"] == "mutate" for m in data["mutations"].values() for e in m["events"])
    E = -(-opts.population_size // min(opts.tournament_selection_n, opts.population_size))
    assert n_mut == opts.populations * E * opts.ncycles_per_iteration * 3


def test_recorder_options_are_checked():
    with pytest.raises(ValueError, match="crossover_probability=0"):
        T.Options(device="cpu", scheduler="device", use_recorder=True,
                  crossover_probability=0.1)
    with pytest.raises(ValueError, match="async_readback=True"):
        T.Options(device="cpu", scheduler="device", use_recorder=True,
                  crossover_probability=0.0, async_readback=True)
    opts = T.Options(device="cpu", scheduler="device", use_recorder=True,
                     crossover_probability=0.0, device_mutation_attempts=2)
    assert tds.device_mode_supported(opts) == "recorder with device_mutation_attempts > 1"


def test_block_is_not_eligible_under_record_events():
    opts = T.Options(device="cpu", scheduler="device", use_recorder=True,
                     crossover_probability=0.0)
    cfg = tds.build_evo_config(opts, 2, 1.0, True, 1, n_rows=60)
    assert cfg.record_events
    assert block_eligible(cfg) == (False, "recorder mode needs the per-event XLA log")
    plain = tds.build_evo_config(T.Options(device="cpu", scheduler="device"), 2, 1.0, True,
                                 1, n_rows=60)
    assert not plain.record_events and block_eligible(plain)[0]
