"""The operations and bytes a kernel launch needs: the least work its inputs
ask for, against which its device time is a share of the roofline.

A frozen copy of the program's arithmetic at commit 7454d72:
``symbolicregression_jl_tpu_torch/ops/interp_cuda.py`` ``work_counts``
(lines 948-960) and ``grad_work_counts`` (962-976), and
``ops/evolve_block_cuda.py`` ``block_work_counts`` (293-309). The program
may change its own copy; this one is the yardstick.

Each kernel file (``kernels/<id>.json``) names a recorder here. In the traced
run the harness wraps the program's entry points and hands each launch's
arguments to the recorder, which keeps only shapes and small device-side sums
(no host sync inside the window; a program batch is summed once, however many
launches it feeds); ``counts`` turns a record into operations and bytes once
the window has closed.
"""

from __future__ import annotations

__all__ = ["loss_counts", "grad_counts", "block_counts", "RECORDERS"]


def loss_counts(P: int, N: int, R: int, F: int, weighted: bool, lanes: int,
                live_slots: int) -> dict:
    """One B1 launch: each real slot of each tree once per row plus the loss
    and the two sums per row; each input read once (``lanes`` datasets on a
    lane axis; R is a lane's rows) and the losses written once."""
    slot_evals = int(live_slots) * R
    ops = slot_evals + 4 * P * R
    data = lanes * (F * R * 4 + R * 4 * (2 if weighted else 1))
    prog_bytes = P * (4 * N + 1) * 4
    return {"operations": ops, "bytes": prog_bytes + P * N * 4 + data + P * 4}


def grad_counts(P: int, N: int, R: int, F: int, weighted: bool, lanes: int,
                live_slots: int, n_const: int) -> dict:
    """One B2 launch: each real slot forward and once in reverse per row,
    per row the loss, its derivative, the two loss sums and one gradient sum
    per constant slot; each input read once, the losses and the [P, N]
    gradients written once."""
    slot_evals = int(live_slots) * R
    ops = 2 * slot_evals + 4 * P * R + int(n_const) * R
    data = lanes * (F * R * 4 + R * 4 * (2 if weighted else 1))
    prog_bytes = P * (4 * N + 1) * 4
    return {"operations": ops, "bytes": prog_bytes + P * N * 4 + data + P * 4 + P * N * 4}


def block_counts(I: int, P: int, N: int, maxsize: int, R: int, F: int, weighted: bool,
                 lanes: int, n_candidates: int, slots: int) -> dict:
    """One B3 launch (I islands in all lanes): B1's rule on the
    ``n_candidates`` programs it scores (``slots`` real slots in all): one
    operation per real slot per row plus four per row for the loss and its
    sums; the population, fnorm and the rows read once, the population and
    the per-island carries written once. Mutation and replacement are not
    counted."""
    S1 = maxsize + 1
    slot_evals = int(slots) * R
    ops = slot_evals + 4 * int(n_candidates) * R
    pop_bytes = I * P * N * 8 + I * P * 16
    carry_bytes = I * S1 * (12 + N * 8)
    data = lanes * (S1 * 4 + F * R * 4 + R * 4 * (2 if weighted else 1))
    return {"operations": ops, "bytes": 2 * pop_bytes + carry_bytes + data}


# -- recorders: a launch's arguments -> a record (device sums stay lazy) -----


def _lanes_rows(X):
    lanes = X.shape[0] if X.dim() == 3 else 1
    return lanes, int(X.shape[-2]), int(X.shape[-1])


class _BatchSums:
    """The device sums of the last program batch a launch was handed: its
    real slots and its constant slots. The const-opt leg hands every B1 and
    B2 launch of a leg one batch, so the sums are taken once a batch, not
    once a launch; ``batches`` counts the batches summed."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.prog = None
        self.sums = None
        self.batches = 0

    def __call__(self, prog, N: int):
        if prog is not self.prog:
            import torch

            lens = prog[:, 4 * N]
            live = torch.arange(N, device=prog.device)[None, :] < lens[:, None]
            self.prog, self.sums = prog, (lens.sum(), ((prog[:, :N] == 0) & live).sum())
            self.batches += 1
        return self.sums


BATCH_SUMS = _BatchSums()


def _record_loss(args, kwargs, with_consts: bool):
    prog, vals, X, y, w = args[:5]
    lanes, F, R = _lanes_rows(X)
    P, ld = prog.shape
    N = (ld - 1) // 4
    live_slots, n_const = BATCH_SUMS(prog, N)
    rec = {"P": int(P), "N": int(N), "R": R, "F": F, "weighted": w is not None,
           "lanes": lanes, "live_slots": live_slots}
    if with_consts:
        rec["n_const"] = n_const
    return rec


def record_loss(args, kwargs):
    return _record_loss(args, kwargs, False)


def record_grad(args, kwargs):
    return _record_loss(args, kwargs, True)


def record_block(args, kwargs):
    """B3: (words, consts, length, loss, score, birth, fnorm, seed, step0,
    curmaxsize, norm, X, y, w, cfg, opset, loss_elem). A launch scores
    ``events_per_cycle`` candidates per island per cycle; their lengths are
    not among its outputs, so the candidates' slots are taken as the mean
    length of the population it starts from (the tournament winners they
    are mutated from are drawn from it)."""
    length, X, w, cfg = args[2], args[11], args[13], args[14]
    lanes, F, R = _lanes_rows(X)
    I = int(length.shape[0])
    n_candidates = int(cfg.ncycles) * I * int(cfg.events_per_cycle)
    return {"I": I, "P": int(cfg.pop_size), "N": int(cfg.n_slots), "maxsize": int(cfg.maxsize),
            "R": R, "F": F, "weighted": w is not None, "lanes": lanes,
            "n_candidates": n_candidates, "length_sum": length.sum(),
            "members": int(length.numel())}


def _host(v):
    return int(v.item()) if hasattr(v, "item") else int(v)


def counts_loss(rec):
    return loss_counts(rec["P"], rec["N"], rec["R"], rec["F"], rec["weighted"], rec["lanes"],
                       _host(rec["live_slots"]))


def counts_grad(rec):
    return grad_counts(rec["P"], rec["N"], rec["R"], rec["F"], rec["weighted"], rec["lanes"],
                       _host(rec["live_slots"]), _host(rec["n_const"]))


def counts_block(rec):
    slots = round(rec["n_candidates"] * _host(rec["length_sum"]) / rec["members"])
    return block_counts(rec["I"], rec["P"], rec["N"], rec["maxsize"], rec["R"], rec["F"],
                        rec["weighted"], rec["lanes"], rec["n_candidates"], slots)


#: a kernel file's ``recorder`` -> (record fn, counts fn)
RECORDERS = {
    "loss": (record_loss, counts_loss),
    "grad": (record_grad, counts_grad),
    "block": (record_block, counts_block),
}
