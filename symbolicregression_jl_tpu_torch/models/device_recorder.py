"""Host-side lineage replay for the device engine's recorder mode.

The reference's recorder traces every mutation/death/tuning event inline
(SymbolicRegression.jl/src/Mutate.jl:126-341, SingleIteration.jl:140-171,
SearchUtils.jl:377-393). The device engine batches all of a cycle's events
into one step and keeps every tensor on the card, so inline tracing would
sync the evolve leg — the engine keeps an EVENT LOG instead: under
``record_events`` each leg fills per-event tensors preallocated on the device
(chosen mutation kind, tournament winner, replaced slot, accept flag,
candidate tree fields, migration replace/src/pool rows, const-opt accept
mask + new values — ops/evolve.py), the readback leg copies them to the host
once per iteration, and this module replays them into the same Recorder
schema, maintaining a tree mirror of every (island, member) slot so
parent/child trees in the record are exact. (A copy of the JAX package's
module; the logs arrive here as numpy arrays.)

Documented deviations from the host engines' records:
- migrated-in copies get FRESH refs (the reference's migration copies keep
  their source member's ref) — migration appears as death + unrelated birth;
- rejected events insert a parent copy under a fresh ref (host path keeps the
  parent object alive in place);
- with ``Options.batching`` the recorded per-event losses are MINIBATCH
  losses (each event scores a fresh with-replacement row subset, like the
  reference's ``score_func_batched`` accept draw), and the iteration-boundary
  finalize's exact full-data rescore is NOT replayed into the mirror — so a
  member's recorded loss can differ from the same tree's loss in the hall of
  fame / CSV output, which always come from the finalize rescore. Mirror
  losses are the engine's accept-time evidence, not the reporting losses.
"""

from __future__ import annotations

import numpy as np

from ..ops.flat import FlatTrees, unflatten_tree
from .pop_member import PopMember

__all__ = ["EngineLineageReplay", "ENGINE_MUTATION_NAMES"]

#: M_* index -> reference mutation-kind name (ops/evolve.py order)
ENGINE_MUTATION_NAMES = (
    "mutate_constant",
    "mutate_operator",
    "swap_operands",
    "add_node",
    "insert_node",
    "delete_node",
    "randomize",
    "do_nothing",
)


class EngineLineageReplay:
    """Replays device-engine event logs into a Recorder.

    ``state0_arrays``: numpy (kind, op, lhs, rhs, feat, val, length) of the
    initial populations, shapes [I, P, N] / [I, P] — the mirror's seed.
    """

    def __init__(self, state0_arrays, options, recorder, out_j: int = 1,
                 cfg=None, loss0=None, score0=None):
        kind, op, lhs, rhs, feat, val, length = state0_arrays
        self.I, self.P, self.N = kind.shape
        self.options = options
        self.recorder = recorder
        self.out_j = out_j
        self.cfg = cfg  # real-baseline EvoConfig for host-side score math
        # tree mirror: one decoded Node per slot + its (score, loss, ref);
        # initial losses/scores are the ENGINE's init values so entries for
        # first-generation members don't carry placeholder zeros
        self.trees = np.empty((self.I, self.P), dtype=object)
        self.loss = (
            np.zeros((self.I, self.P), np.float64)
            if loss0 is None else np.asarray(loss0, np.float64).copy()
        )
        self.score = (
            np.zeros((self.I, self.P), np.float64)
            if score0 is None else np.asarray(score0, np.float64).copy()
        )
        self.refs = np.zeros((self.I, self.P), dtype=np.int64)
        for i in range(self.I):
            flat_i = FlatTrees(
                kind[i], op[i], lhs[i], rhs[i], feat[i], val[i], length[i]
            )
            for p in range(self.P):
                m = PopMember(unflatten_tree(flat_i, p), 0.0, 0.0)
                self.trees[i, p] = m.tree
                self.refs[i, p] = m.ref

    # -- helpers -------------------------------------------------------------

    def _member(self, i: int, p: int) -> PopMember:
        m = PopMember.__new__(PopMember)
        m.tree = self.trees[i, p]
        m.score = float(self.score[i, p])
        m.loss = float(self.loss[i, p])
        m.birth = 0
        m.complexity = None
        m.ref = int(self.refs[i, p])
        m.parent = -1
        return m

    def _fresh(self, tree, score, loss, parent_ref: int) -> PopMember:
        m = PopMember(tree, float(score), float(loss), parent=int(parent_ref))
        return m

    # -- per-program consumers ----------------------------------------------

    def consume_iteration(self, log) -> None:
        """Replay one run_iteration log: {'events': {...[C, L, ...]},
        'mig_island'/'mig_hof': {...}} (numpy or device arrays)."""
        ev = {
            k: np.asarray(v) if not isinstance(v, tuple)
            else tuple(np.asarray(f) for f in v)
            for k, v in log["events"].items()
        }
        C, L = ev["kind"].shape
        E = L // self.I
        for c in range(C):
            cand_flat = FlatTrees(*(f[c] for f in ev["cand"]))
            # two passes per cycle: the engine batches ALL of a cycle's
            # events against ONE pre-event population snapshot, so every
            # lane's parent (and every death) must be read BEFORE any lane's
            # insert lands — a sequential replay would hand lane k a tree
            # that lane j < k already replaced
            staged = []
            for lane in range(L):
                i = lane // E
                win1 = int(ev["win1"][c, lane])
                slot1 = int(ev["slot1"][c, lane])
                kindname = ENGINE_MUTATION_NAMES[int(ev["kind"][c, lane])]
                accepted = bool(ev["accept"][c, lane])
                parent = self._member(i, win1)
                parent.loss = float(ev["ploss"][c, lane])
                parent.score = float(ev["pscore"][c, lane])
                if accepted:
                    baby_tree = unflatten_tree(cand_flat, lane)
                    b_loss = float(ev["loss"][c, lane])
                    b_score = float(ev["score"][c, lane])
                else:
                    baby_tree = parent.tree.copy()
                    b_loss, b_score = parent.loss, parent.score
                baby = self._fresh(baby_tree, b_score, b_loss, parent.ref)
                self.recorder.record_mutation(
                    parent, baby, kindname, accepted, self.options
                )
                self.recorder.record_death(self._member(i, slot1), self.options)
                staged.append((i, slot1, baby, b_loss, b_score))
            for i, slot1, baby, b_loss, b_score in staged:
                self.trees[i, slot1] = baby.tree
                self.loss[i, slot1] = b_loss
                self.score[i, slot1] = b_score
                self.refs[i, slot1] = baby.ref
        for key in ("mig_island", "mig_hof"):
            if key in log:
                self.consume_migration(log[key])

    def consume_migration(self, mig) -> None:
        replace = np.asarray(mig["replace"])
        src = np.asarray(mig["src"])
        pool = tuple(np.asarray(a) for a in mig["pool"])
        pool_flat = FlatTrees(*pool[:7])
        pool_loss = pool[7]
        for i in range(self.I):
            for p in range(self.P):
                if not replace[i, p]:
                    continue
                s = int(src[i, p])
                self.recorder.record_death(self._member(i, p), self.options)
                tree = unflatten_tree(pool_flat, s)
                loss = float(pool_loss[s])
                # real score for the migrated-in copy (the engine computes it
                # in _inject_pool via _score_of): lineage entries for these
                # members must not carry a placeholder score
                if self.cfg is not None:
                    from ..complexity import compute_complexity
                    from ..ops.evolve import _score_of

                    score = float(
                        _score_of(
                            loss,
                            float(compute_complexity(tree, self.options)),
                            self.cfg,
                        )
                    )
                else:
                    score = loss
                m = PopMember(tree, score, loss)
                self.trees[i, p] = m.tree
                self.loss[i, p] = m.loss
                self.score[i, p] = m.score
                self.refs[i, p] = m.ref

    def consume_tuning(self, tlog) -> None:
        """Replay a const-opt log: {'ii','pp','improved','new_loss','new_val'}."""
        ii = np.asarray(tlog["ii"])
        pp = np.asarray(tlog["pp"])
        improved = np.asarray(tlog["improved"])
        new_loss = np.asarray(tlog["new_loss"])
        new_val = np.asarray(tlog["new_val"])
        for k in range(len(ii)):
            i, p = int(ii[k]), int(pp[k])
            if improved[k]:
                # rewrite the mirror tree's constants in postorder slot order
                tree = self.trees[i, p]
                vals = new_val[k]
                for j, node in enumerate(tree.postorder()):
                    if node.degree == 0 and node.is_const:
                        node.val = complex(vals[j]) if np.iscomplexobj(
                            vals
                        ) else float(vals[j])
                self.loss[i, p] = float(new_loss[k])
                # keep the mirror's (loss, score) pair consistent, like the
                # engine's _accept_and_scatter recomputes _score_of
                if self.cfg is not None:
                    from ..complexity import compute_complexity
                    from ..ops.evolve import _score_of

                    self.score[i, p] = float(
                        _score_of(
                            self.loss[i, p],
                            float(compute_complexity(tree, self.options)),
                            self.cfg,
                        )
                    )
            self.recorder.record_tuning(
                self._member(i, p), bool(improved[k]), self.options
            )

    def snapshot_populations(self, state_arrays, iteration: int) -> None:
        """record_population from the AUTHORITATIVE decoded engine state
        (not the mirror): per-iteration out{j}_pop{i} entries like the host
        engines'."""
        from .population import Population

        kind, op, lhs, rhs, feat, val, length, loss, score = state_arrays
        for i in range(self.I):
            flat_i = FlatTrees(
                kind[i], op[i], lhs[i], rhs[i], feat[i], val[i], length[i]
            )
            members = []
            for p in range(self.P):
                if length[i, p] < 1:
                    continue
                m = PopMember.__new__(PopMember)
                m.tree = unflatten_tree(flat_i, p)
                m.score = float(score[i, p])
                m.loss = float(loss[i, p])
                m.birth = 0
                m.complexity = None
                m.ref = int(self.refs[i, p])
                m.parent = -1
                members.append(m)
            self.recorder.record_population(
                self.out_j, i + 1, iteration, Population(members), self.options
            )
