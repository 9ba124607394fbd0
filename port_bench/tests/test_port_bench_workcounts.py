"""The frozen work counts against the program's own at small sizes, through
the recorders the traced run uses."""

import numpy as np
import pytest
import torch

from port_bench import workcounts

ic = pytest.importorskip("symbolicregression_jl_tpu_torch.ops.interp_cuda")
ebc = pytest.importorskip("symbolicregression_jl_tpu_torch.ops.evolve_block_cuda")


def _prog(P, N, seed):
    rng = np.random.default_rng(seed)
    prog = np.zeros((P, 4 * N + 1), np.int32)
    lengths = rng.integers(1, N + 1, size=P)
    prog[:, 4 * N] = lengths
    prog[:, :N] = rng.integers(0, 5, size=(P, N))  # code 0 marks a constant
    return prog


@pytest.mark.parametrize("P, N, R, F, weighted, lanes", [
    (7, 8, 100, 3, False, 1), (64, 24, 10_000, 5, True, 1), (40, 16, 333, 5, False, 4),
])
def test_loss_and_grad_counts_equal_the_programs(P, N, R, F, weighted, lanes):
    prog = _prog(P, N, P + N)
    X = torch.zeros((lanes, F, R) if lanes > 1 else (F, R))
    y = torch.zeros((lanes, R) if lanes > 1 else (R,))
    w = torch.ones_like(y) if weighted else None
    args = (torch.from_numpy(prog), torch.zeros(P, N), X, y, w)
    got = workcounts.counts_loss(workcounts.record_loss(args, {}))
    want = ic.work_counts(prog, R, F, weighted, lanes)
    assert got == {"operations": want["operations"], "bytes": want["bytes"]}
    got = workcounts.counts_grad(workcounts.record_grad(args, {}))
    want = ic.grad_work_counts(prog, R, F, weighted, lanes)
    assert got == {"operations": want["operations"], "bytes": want["bytes"]}


@pytest.mark.parametrize("lanes", [1, 3])
def test_block_counts_equal_the_programs(lanes):
    T = pytest.importorskip("symbolicregression_jl_tpu_torch")
    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config

    o = T.Options(binary_operators=["+", "*"], unary_operators=["cos"], populations=4,
                  population_size=24, maxsize=12, ncycles_per_iteration=7, device="cpu")
    cfg = build_evo_config(o, 5, 1.0, False, 10)
    I, P, N, R, F = 4 * lanes, cfg.pop_size, cfg.n_slots, 250, 5
    length = torch.randint(1, N + 1, (I, P), dtype=torch.int32)
    X = torch.zeros((lanes, F, R) if lanes > 1 else (F, R))
    args = [None] * 17
    args[2], args[11], args[13], args[14] = length, X, None, cfg
    rec = workcounts.record_block(args, {})
    assert rec["n_candidates"] == cfg.ncycles * I * cfg.events_per_cycle
    got = workcounts.counts_block(rec)
    slots = round(rec["n_candidates"] * int(length.sum()) / length.numel())
    want = ebc.block_work_counts(cfg, R, F, False, rec["n_candidates"], slots, lanes)
    assert got == {"operations": want["operations"], "bytes": want["bytes"]}


def test_a_batch_is_summed_once_however_many_launches_it_feeds():
    """The const-opt leg hands B1 and B2 one program batch for every launch
    of a leg: the recorder sums it once, and a new batch anew."""
    workcounts.BATCH_SUMS.reset()
    X, y = torch.zeros((5, 50)), torch.zeros(50)
    a, b = (torch.from_numpy(_prog(9, 8, s)) for s in (1, 2))
    recs = [workcounts.record_loss((a, None, X, y, None), {}),
            workcounts.record_grad((a, None, X, y, None), {}),
            workcounts.record_loss((a, None, X, y, None), {}),
            workcounts.record_grad((b, None, X, y, None), {})]
    assert workcounts.BATCH_SUMS.batches == 2
    for rec, p in zip(recs, (a, a, a, b)):
        assert int(rec["live_slots"]) == int(p[:, 32].sum())
    live = np.arange(8)[None, :] < b.numpy()[:, 32][:, None]
    assert int(recs[3]["n_const"]) == int(((b.numpy()[:, :8] == 0) & live).sum())
    workcounts.BATCH_SUMS.reset()
