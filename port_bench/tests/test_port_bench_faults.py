"""The comparison that decides ``correct``, shown to fail.

A run of each cell's path, cut to a host-sized search and driven through the
harness (everything but its look for a card), with the timed path broken
underneath: ``correct`` must come out false for each fault the cells can
have, and true on the sound path. The control, the reference in bfloat16 put
in the program's place, must come out false too. The card's own readings
(the cells' sizes, a dozen seeds) come from ``readings.py``; PERF.md has them.
"""

import time

import pytest
import torch

from port_bench import checks, harness

ds = pytest.importorskip("symbolicregression_jl_tpu_torch.models.device_search")
ic = pytest.importorskip("symbolicregression_jl_tpu_torch.ops.interp_cuda")
eb = pytest.importorskip("symbolicregression_jl_tpu_torch.ops.evolve_block")

SEED = 2**31 + 77
SECONDS = 6.0
CYCLES = 60


def _cut(cell):
    cell.config["data"]["rows"] = 200
    cell.config["options"].update(populations=3, population_size=36,
                                  ncycles_per_iteration=CYCLES, optimizer_probability=0.5)
    cell.traffic["warmup_iterations"] = 1
    return cell


def _run(name, traffic_of=None):
    """A cut run of cell ``name`` judged by its limits; ``traffic_of``: run
    that cell's traffic instead (the same configuration)."""
    cell = _cut(harness.load_cell(name))
    if traffic_of is not None:
        cell.traffic = _cut(harness.load_cell(traffic_of)).traffic
    run, X, y = harness.measure(cell, SEED, SECONDS, False, "cpu", time.perf_counter())
    correct, rows, attempted, failed, judged = harness.judge(cell, run, X, y, SEED)
    return cell, run, X, y, correct, {r[0]: r[1] for r in rows}, attempted, failed


@pytest.fixture(autouse=True)
def block_plain(monkeypatch):
    # the evolve block's plain version: the cells' path on the card is the block
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1")


def _break_plain_losses(monkeypatch, fn):
    """Every plain loss of the cut run (the block's, B1's and B2's) through
    ``fn``: the program's module binds its own name for it."""
    orig = ic.plain_losses

    def broken(flat, vals, X, y, w, opset, loss_elem, with_grad=False):
        return fn(orig, flat, vals, X, y, w, opset, loss_elem, with_grad)

    monkeypatch.setattr(ic, "plain_losses", broken)
    monkeypatch.setattr(ds, "plain_losses", broken)


def _half_rows(orig, flat, vals, X, y, w, opset, loss_elem, with_grad):
    h = X.shape[-1] // 2
    return orig(flat, vals, X[..., :h].contiguous(), y[..., :h].contiguous(),
                None if w is None else w[..., :h].contiguous(), opset, loss_elem, with_grad)


def _altered(orig, flat, vals, X, y, w, opset, loss_elem, with_grad):
    out = orig(flat, vals, X, y, w, opset, loss_elem, with_grad)
    if with_grad:
        return out[0] * (1 + 1e-3), out[1]
    return out * (1 + 1e-3)


def _zero_grad(orig, flat, vals, X, y, w, opset, loss_elem, with_grad):
    out = orig(flat, vals, X, y, w, opset, loss_elem, with_grad)
    return (out[0], torch.zeros_like(out[1])) if with_grad else out


CELLS = ["config3.search", "config3.noconst"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_path_is_correct_and_the_control_is_not(name):
    cell, run, X, y, correct, numbers, attempted, failed = _run(name)
    assert correct, numbers
    assert attempted > 0 and failed == 0
    control = checks.judge(run.result, X, y, cell.config, SEED, int(cell.traffic["sample"]),
                           dtype="bfloat16", numbers=("hof_loss_gap", "pop_loss_gap"))
    ok, rows = checks.verdict(control["numbers"],
                              {k: cell.limits[k] for k in control["numbers"]})
    assert not ok, rows


@pytest.mark.parametrize("name", CELLS)
def test_block_returns_its_input(monkeypatch, name):
    """The evolve leg's block hands back the population it was given."""
    monkeypatch.setattr(eb, "run_block", lambda pop, seed, step0, curmaxsize, fnorm, norm,
                        cfg, eval_fn, stages=4: eb.block_carry0(pop, cfg))
    cell, *_, correct, numbers, _, _ = _run(name)
    assert not correct, numbers
    assert numbers["frontier_shortfall"] > cell.limits["frontier_shortfall"], numbers


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half_rows, _altered], ids=["half_rows", "altered"])
def test_scoring_broken(monkeypatch, name, fault):
    _break_plain_losses(monkeypatch, fault)
    *_, correct, numbers, _, failed = _run(name)
    assert not correct and failed > 0, numbers


def test_constants_not_fitted():
    """config3.search's limits on a search that fits no constants."""
    *_, correct, numbers, _, _ = _run("config3.search", traffic_of="config3.noconst")
    assert not correct, numbers


def test_zero_gradient(monkeypatch):
    """const-opt's BFGS fed a gradient of zeros."""
    _break_plain_losses(monkeypatch, _zero_grad)
    *_, correct, numbers, _, _ = _run("config3.search")
    assert not correct, numbers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest port_bench/tests -m cuda on the chip")


@pytest.mark.cuda
def test_card_run_is_correct(cuda):
    import json
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "config3.search",
                        "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900,
                       cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and {"setup_s", "iter_ms", "iter_p90_ms"} <= set(line["metrics"])
