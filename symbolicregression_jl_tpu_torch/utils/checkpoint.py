"""Checkpointing: full-state snapshots plus hall-of-fame CSV resume.

Copy of ``symbolicregression_jl_tpu/utils/checkpoint.py`` over the port's
classes, with one addition: snapshots are read through
:class:`_PortUnpickler`, which resolves a class the JAX package pickled
(``symbolicregression_jl_tpu.<module>.<name>``) to the port's class of the
same module and name, importing nothing of the JAX package. ``Node``,
``PopMember``, ``Population`` and ``HallOfFame`` carry the same attributes
in both packages, so a JAX snapshot decodes to equal trees, losses, RNG
state and counters. Such a snapshot resumes as a rescored warm start
(``exact`` is cleared on load): the port's scoring does not repeat the JAX
package's bits, so a verbatim continuation would not be the JAX run's. The
other direction is closed for snapshots: the JAX loader checks the
payload's class, which a port snapshot does not name. Frontier frames are
written under the JAX package's class names (:class:`_JaxNamedPickler`),
so they decode in both packages. Hall-of-fame CSVs cross both ways.

Two tiers of persistence live here:

1. **Full-state checkpoints**: :class:`SearchCheckpointer` writes
   rolling pickle snapshots — populations, hall of fame, RNG state,
   adaptive-parsimony frequencies, ``num_evals``, and the member id counters
   — atomically (tmp + fsync + ``os.replace``) on a configurable cadence
   (``Options.checkpoint_every`` iterations and/or
   ``checkpoint_every_seconds``). ``equation_search(resume_from=...)``
   restores the newest snapshot: **bit-exact** continuation on the serial
   (lockstep) scheduler — the resumed run's hall of fame is identical to the
   uninterrupted run's — and a rescored warm start on the device/async
   schedulers (their state lives on-device / across threads, so snapshots
   are decoded observations, not the exact machine state).

2. **CSV resume**: the reference's CSV output is write-only — its only
   resume path is the in-memory ``saved_state`` object
   (SymbolicRegression.jl/src/SearchUtils.jl:410-450 writes, nothing reads).
   ``load_saved_state`` parses the ``Complexity,Loss,Equation`` rows back
   into trees and returns a warm-startable state. Losses in the file are
   treated as stale: every scheduler RESCORES saved hall-of-fame members
   against the current dataset on warm start, so a checkpoint written
   against one dataset can seed a search on another. A ``.meta.json``
   sidecar written next to the CSV carries ``num_evals`` so warm-started
   runs don't under-report total evaluations.

Equations are parsed by a recursive-descent parser for string_tree's own
grammar (tree.py:197-232) — exact structural round-trip, no algebraic
normalization (sympy's sympify rewrites x - y as x + (-1*y), which inflates
complexity and can push a frontier member past maxsize). Strings the
grammar does not cover fall back to the sympy bridge.
"""

from __future__ import annotations

import csv
import dataclasses
import errno as _errno
import io
import json
import os
import pickle
import re
import time
from typing import NamedTuple

import numpy as np

__all__ = [
    "CheckpointError",
    "LoadedState",
    "load_saved_state",
    "parse_equation",
    "FlatPopulations",
    "SearchCheckpoint",
    "SearchCheckpointer",
    "latest_checkpoint",
    "load_checkpoint",
    "peek_checkpoint_meta",
    "dump_checkpoint_bytes",
    "load_checkpoint_bytes",
    "FrontierUpdate",
    "dump_frontier_bytes",
    "load_frontier_bytes",
    "options_fingerprint",
]

# format 2: populations are stored as ONE flat postorder batch
# (FlatPopulations) instead of pickled Node graphs — smaller, and every
# documented FlatTrees invariant is verified on load so a corrupted or
# truncated snapshot is rejected with a named invariant instead of
# warm-starting a search with garbage trees. Format-1 snapshots (raw
# Population lists) remain loadable.
CHECKPOINT_FORMAT = 2


class CheckpointError(ValueError):
    """A snapshot that cannot be trusted: torn/truncated pickle, wrong
    payload type, or a flat-IR invariant violation (the message names the
    violated invariant, e.g. ``[postorder] tree 3 slot 5: ...``)."""

# string_tree's complex-constant rendering: "(Re±Imim)", e.g. "(2-0.5im)",
# "(1e+03+2.5e-05im)". Unambiguous vs infix binaries, which always have
# spaces around the operator token.
_NUM = r"(?:\d+\.?\d*|\.\d+|inf|nan)(?:[eE][+-]?\d+)?"
_COMPLEX_RE = re.compile(rf"\((-?{_NUM})([+-]{_NUM})im\)")


class LoadedState:
    """Warm-startable state restored from a CSV checkpoint. Quacks like
    SearchResult for the read paths the estimators use: ``hall_of_fame``,
    ``populations`` (empty — schedulers refill), ``options``, ``report()``."""

    def __init__(self, hall_of_fame, options, variable_names=None):
        self.hall_of_fame = hall_of_fame
        self.populations: list = []
        self.options = options
        self.variable_names = variable_names
        self.num_evals = 0.0

    def report(self):
        return self.hall_of_fame.format(self.options, self.variable_names)

    @property
    def pareto_frontier(self):
        return self.hall_of_fame.pareto_frontier()


def parse_equation(s: str, opset, variable_names: list[str] | None = None):
    """Parse a string_tree rendering back into a Node — the exact inverse of
    tree.Node.string_tree: ``(L <display> R)`` infix binaries,
    ``name(args...)`` calls, ``-(x)`` for neg, xN / variable-name leaves,
    %.Ng constants (incl. inf/nan)."""
    from ..tree import binary, constant, feature, unary

    names = {}
    if variable_names is not None:
        names = {name: i for i, name in enumerate(variable_names)}
    n = len(s)
    pos = 0

    def error(msg):
        return ValueError(f"cannot parse equation at {pos}: {msg} in {s!r}")

    def peek():
        return s[pos] if pos < n else ""

    def expect(ch):
        nonlocal pos
        if not s.startswith(ch, pos):
            raise error(f"expected {ch!r}")
        pos += len(ch)

    def ident():
        nonlocal pos
        start = pos
        while pos < n and (s[pos].isalnum() or s[pos] == "_"):
            pos += 1
        return s[start:pos]

    def number():
        nonlocal pos
        start = pos
        if peek() in "+-":
            pos += 1
        if s.startswith("inf", pos) or s.startswith("nan", pos):
            pos += 3
            return float(s[start:pos])
        while pos < n and (s[pos].isdigit() or s[pos] == "."):
            pos += 1
        if pos < n and s[pos] in "eE":
            pos += 1
            if peek() in "+-":
                pos += 1
            while pos < n and s[pos].isdigit():
                pos += 1
        return float(s[start:pos])

    def expr():
        nonlocal pos
        c = peek()
        if c == "(":
            m = _COMPLEX_RE.match(s, pos)
            if m:  # complex constant literal
                pos = m.end()
                return constant(complex(float(m[1]), float(m[2])))
            # infix binary: (L <display> R)
            expect("(")
            left = expr()
            expect(" ")
            op_start = pos
            while pos < n and s[pos] != " ":
                pos += 1
            op_tok = s[op_start:pos]
            expect(" ")
            right = expr()
            expect(")")
            return binary(opset.binary_index(op_tok), left, right)
        if c == "-":
            if s.startswith("-(", pos):  # neg's special rendering
                pos += 1
                expect("(")
                inner = expr()
                expect(")")
                return unary(opset.unary_index("neg"), inner)
            return constant(number())
        if c.isdigit() or c == ".":
            return constant(number())
        name = ident()
        if not name:
            raise error("expected a term")
        if peek() == "(":  # function call: unary or display-less binary
            expect("(")
            args = [expr()]
            while s.startswith(", ", pos):
                pos += 2
                args.append(expr())
            expect(")")
            if len(args) == 1:
                return unary(opset.unary_index(name), args[0])
            if len(args) == 2:
                return binary(opset.binary_index(name), args[0], args[1])
            raise error(f"{name} takes {len(args)} args")
        if name in names:
            return feature(names[name])
        if name.startswith("x") and name[1:].isdigit():
            return feature(int(name[1:]) - 1)
        if name in ("inf", "nan"):
            return constant(float(name))
        raise error(f"unknown symbol {name!r}")

    out = expr()
    if pos != n:
        raise error("trailing characters")
    return out


def load_saved_state(
    path: str, options, variable_names: list[str] | None = None
):
    """Parse a hall-of-fame CSV (save_hall_of_fame format) into an object
    accepted by ``equation_search(saved_state=...)``: populations are left
    empty (schedulers fill with fresh random members) and the hall of fame
    seeds the search, rescored against the live dataset."""
    from ..complexity import compute_complexity
    from ..export_sympy import sympy_to_node
    from ..models.hall_of_fame import HallOfFame
    from ..models.pop_member import PopMember

    hof = HallOfFame(options.maxsize)
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        fields = set(reader.fieldnames or ())
        if not {"Loss", "Equation"} <= fields:
            raise ValueError(
                f"{path!r} is not a hall-of-fame CSV "
                "(expected a Complexity,Loss,Equation header)"
            )
        for row in reader:
            try:
                tree = parse_equation(
                    row["Equation"], options.operators, variable_names
                )
            except (ValueError, KeyError):
                # not our grammar (hand-edited file / foreign tool): the
                # sympy bridge accepts general infix ('^' is sympy XOR)
                tree = sympy_to_node(
                    row["Equation"].replace("^", "**"),
                    options.operators,
                    variable_names,
                )
            loss = float(row["Loss"])
            comp = compute_complexity(tree, options)
            # score is recomputed on warm-start rescore; loss is a stale hint
            m = PopMember(tree, loss, loss, complexity=comp)
            hof.update(m, options)

    state = LoadedState(hof, options, variable_names)
    # .meta.json sidecar (save_hall_of_fame): restores the eval budget so a
    # warm-started run's reported total spans the whole lineage
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                state.num_evals = float(json.load(f).get("num_evals", 0.0))
        except (OSError, ValueError):
            pass  # corrupt/foreign sidecar: keep the 0.0 default
    return state


# -- full-state checkpoints --------------------------------------------------


def options_fingerprint(options) -> tuple:
    """A light, picklable summary of the options that shape search dynamics.
    Stored in every snapshot so ``resume_from`` can WARN on a mismatch —
    callables and device config make the full Options unpicklable, and a
    hard error would block legitimate cross-config warm starts."""
    ops = options.operators
    return (
        tuple(op.name for op in ops.binary),
        tuple(op.name for op in ops.unary),
        int(options.maxsize),
        int(options.populations),
        int(options.population_size),
        int(options.ncycles_per_iteration),
        options.seed,
    )


class _OpsetBounds(NamedTuple):
    """Duck-typed opset stand-in for verify_flat_trees' op-range checks,
    rebuilt from the snapshot's own operator counts (the real OperatorSet is
    not picklable and not needed to decode)."""

    n_binary: int
    n_unary: int


@dataclasses.dataclass
class FlatPopulations:
    """Snapshot populations as ONE flat postorder batch (format 2).

    Tree arrays follow the :class:`~..ops.flat.FlatTrees` layout over all
    members of all populations concatenated; ``pop_sizes`` rebuilds the
    population boundaries and the per-member arrays carry the PopMember
    metadata (``complexity`` uses -1 for "not computed"). ``val`` is float64
    — complex128 when any constant is complex — so a decode-encode round
    trip is bit-exact and resume stays lockstep-identical."""

    kind: np.ndarray
    op: np.ndarray
    lhs: np.ndarray
    rhs: np.ndarray
    feat: np.ndarray
    val: np.ndarray
    length: np.ndarray
    score: np.ndarray
    loss: np.ndarray
    complexity: np.ndarray
    ref: np.ndarray
    parent: np.ndarray
    birth: np.ndarray
    pop_sizes: list
    n_binary: int = -1  # -1 = unknown: op-range checks are skipped on load
    n_unary: int = -1


def _scan_tree(tree):
    """(node count, has complex constant) — or None when the tree shares
    subtrees (graph_nodes DAGs): flat postorder would silently duplicate
    shared nodes, so those snapshots keep raw Population pickling."""
    size = 0
    has_complex = False
    seen = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            return None
        seen.add(id(node))
        size += 1
        if node.degree == 0 and node.is_const and isinstance(node.val, complex):
            has_complex = True
        if node.degree >= 1:
            stack.append(node.l)
        if node.degree == 2:
            stack.append(node.r)
    return size, has_complex


def flatten_populations(populations, fingerprint=()) -> "FlatPopulations | None":
    """Flat-encode a list of Populations for a format-2 snapshot. Returns
    None when any tree is a DAG (caller falls back to raw pickling).
    ``fingerprint`` (options_fingerprint) supplies the operator counts for
    the op-range checks on load."""
    from ..ops.flat import flatten_trees

    members = [m for pop in populations for m in pop.members]
    if not members:
        # nothing to flat-encode (e.g. an empty-frontier streaming frame):
        # raw pickling of the empty list is exact and trivially safe
        return None
    sizes = []
    has_complex = False
    for m in members:
        scan = _scan_tree(m.tree)
        if scan is None:
            return None
        sizes.append(scan[0])
        has_complex = has_complex or scan[1]
    max_nodes = max(sizes, default=1)
    dtype = np.complex128 if has_complex else np.float64
    flat = flatten_trees([m.tree for m in members], max_nodes, dtype=dtype)
    n_binary = len(fingerprint[0]) if fingerprint else -1
    n_unary = len(fingerprint[1]) if fingerprint else -1
    return FlatPopulations(
        kind=flat.kind, op=flat.op, lhs=flat.lhs, rhs=flat.rhs,
        feat=flat.feat, val=flat.val, length=flat.length,
        score=np.asarray([m.score for m in members], np.float64),
        loss=np.asarray([m.loss for m in members], np.float64),
        complexity=np.asarray(
            [-1 if m.complexity is None else int(m.complexity) for m in members],
            np.int64,
        ),
        ref=np.asarray([m.ref for m in members], np.int64),
        parent=np.asarray([m.parent for m in members], np.int64),
        birth=np.asarray([m.birth for m in members], np.int64),
        pop_sizes=[len(pop.members) for pop in populations],
        n_binary=n_binary,
        n_unary=n_unary,
    )


def restore_populations(flat: FlatPopulations):
    """Verify a FlatPopulations payload against every flat-IR invariant and
    decode it back into Populations of PopMembers. Decoding goes through
    ``PopMember.__new__`` (the ``copy()`` pattern): birth/ref come from the
    snapshot, so the global counters are not burned and a bit-exact resume
    keeps the exact id stream. Raises :class:`CheckpointError` naming the
    violated invariant on corruption."""
    from ..analysis.ir_verify import FlatIRError, verify_flat_trees
    from ..models.pop_member import PopMember
    from ..models.population import Population
    from ..ops.flat import FlatTrees, unflatten_tree

    ft = FlatTrees(
        flat.kind, flat.op, flat.lhs, flat.rhs, flat.feat, flat.val, flat.length
    )
    bounds = (
        _OpsetBounds(int(flat.n_binary), int(flat.n_unary))
        if int(flat.n_binary) >= 0
        else None
    )
    try:
        # every stored member has a real tree: empty rows are corruption
        verify_flat_trees(
            ft, bounds, allow_empty=False, where="checkpoint populations: "
        )
    except FlatIRError as e:
        raise CheckpointError(
            f"snapshot populations failed flat-IR verification: {e}"
        ) from e
    P = np.asarray(flat.kind).shape[0]
    meta = (flat.score, flat.loss, flat.complexity, flat.ref, flat.parent, flat.birth)
    if int(sum(flat.pop_sizes)) != P or any(
        np.asarray(a).shape != (P,) for a in meta
    ):
        raise CheckpointError(
            f"[shape] snapshot member metadata inconsistent: sum(pop_sizes)="
            f"{int(sum(flat.pop_sizes))}, trees={P}"
        )
    pops = []
    i = 0
    for size in flat.pop_sizes:
        members = []
        for _ in range(int(size)):
            m = PopMember.__new__(PopMember)
            m.tree = unflatten_tree(ft, i)
            m.score = float(flat.score[i])
            m.loss = float(flat.loss[i])
            m.birth = int(flat.birth[i])
            c = int(flat.complexity[i])
            m.complexity = None if c < 0 else c
            m.ref = int(flat.ref[i])
            m.parent = int(flat.parent[i])
            members.append(m)
            i += 1
        pops.append(Population(members))
    return pops


@dataclasses.dataclass
class SearchCheckpoint:
    """One full-state snapshot of a running search.

    Quacks like ``saved_state`` (``populations`` / ``hall_of_fame`` /
    ``num_evals`` / ``pareto_frontier``) so the device/async schedulers can
    warm-start from it through their existing rescore path; the serial
    scheduler additionally consumes ``rng_state`` / ``stats_frequencies`` /
    ``counters`` for bit-exact continuation (``exact=True``)."""

    iteration: int  # iterations COMPLETED when the snapshot was taken
    niterations: int  # the run's total budget (resume runs the remainder)
    scheduler: str
    exact: bool  # bit-exact continuation supported (serial scheduler only)
    populations: list
    hall_of_fame: object
    num_evals: float
    rng_state: dict | None = None  # np.random.Generator.bit_generator.state
    stats_frequencies: object = None  # RunningSearchStatistics.frequencies
    counters: tuple | None = None  # pop_member.counter_state()
    options_fingerprint: tuple = ()
    wall_time: float = 0.0
    out_j: int = 1
    format_version: int = CHECKPOINT_FORMAT

    @property
    def pareto_frontier(self):
        return self.hall_of_fame.pareto_frontier()


def _list_snapshots(base: str) -> list[tuple[int, str]]:
    """(seq, path) of every ``{base}.NNNNNN`` snapshot, ascending."""
    d = os.path.dirname(base) or "."
    name = os.path.basename(base)
    out = []
    try:
        entries = os.listdir(d)
    except OSError:
        return []
    for e in entries:
        if e.startswith(name + "."):
            tail = e[len(name) + 1 :]
            if tail.isdigit():
                out.append((int(tail), os.path.join(d, e)))
    return sorted(out)


def latest_checkpoint(base: str) -> str | None:
    """Path of the newest ``{base}.NNNNNN`` snapshot, or None."""
    snaps = _list_snapshots(base)
    return snaps[-1][1] if snaps else None


_JAX_PACKAGE = "symbolicregression_jl_tpu"
_PORT_PACKAGE = __name__.split(".")[0]

# what a torn, truncated or foreign pickle raises while loading
_UNPICKLE_ERRORS = (
    pickle.PickleError,
    EOFError,
    AttributeError,
    ImportError,
    IndexError,
    ValueError,
    TypeError,
    UnicodeDecodeError,
)


class _PortUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to the port's: a global pickled
    from ``symbolicregression_jl_tpu.<module>`` is looked up in
    ``symbolicregression_jl_tpu_torch.<module>``, so the JAX package is never
    imported. ``remapped`` records whether any global was."""

    def __init__(self, f):
        super().__init__(f)
        self.remapped = False

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
            self.remapped = True
        return super().find_class(module, name)


def _unpickle(data: bytes, what: str, decode: bool = True) -> SearchCheckpoint:
    """Unpickle a snapshot of either package, check its type, and (``decode``)
    verify and decode its flat populations. A snapshot the JAX package wrote
    loses ``exact``: it resumes as a rescored warm start."""
    up = _PortUnpickler(io.BytesIO(data))
    try:
        ckpt = up.load()
    except _UNPICKLE_ERRORS as e:
        raise CheckpointError(
            f"cannot unpickle {what}: truncated or corrupt ({e})"
        ) from e
    if not isinstance(ckpt, SearchCheckpoint):
        raise CheckpointError(f"{what} is not a SearchCheckpoint snapshot")
    if up.remapped:
        ckpt.exact = False
    if decode and isinstance(ckpt.populations, FlatPopulations):
        try:
            ckpt.populations = restore_populations(ckpt.populations)
        except CheckpointError as e:
            raise CheckpointError(f"{what}: {e}") from e
    return ckpt


def _resolve_snapshot(path: str) -> str:
    """``path`` itself when it is a file, else the newest ``{path}.NNNNNN``."""
    if os.path.isfile(path):
        return path
    latest = latest_checkpoint(path)
    if latest is None:
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (nor any {path}.NNNNNN snapshot)"
        )
    return latest


def _read_snapshot(target: str) -> bytes:
    try:
        with open(target, "rb") as f:
            return f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read snapshot {target!r} ({e})") from e


def load_checkpoint(path: str) -> SearchCheckpoint:
    """Load a snapshot. ``path`` may be a snapshot file or a checkpoint base
    (``Options.checkpoint_file``), in which case the newest snapshot wins.

    Format-2 snapshots carry flat-encoded populations: these are verified
    against every documented flat-IR invariant and decoded back into
    Populations here — a corrupted/truncated snapshot raises
    :class:`CheckpointError` naming the violated invariant instead of
    warm-starting a search with garbage trees. Snapshots the JAX package
    wrote load too (:class:`_PortUnpickler`), as warm starts."""
    target = _resolve_snapshot(path)
    return _unpickle(_read_snapshot(target), f"snapshot {target!r}")


def peek_checkpoint_meta(path: str) -> dict:
    """Resolve ``path`` like :func:`load_checkpoint` (file or base → newest
    ``{base}.NNNNNN`` snapshot) and return its METADATA without decoding or
    verifying the populations — the serve layer's crash recovery needs
    iteration/scheduler/exactness to plan a resume for many jobs at once,
    and full decode+verify happens anyway when the job actually resumes.

    Returns ``{"path", "iteration", "niterations", "scheduler", "exact",
    "format_version"}``; raises :class:`FileNotFoundError` when nothing
    exists at ``path`` and :class:`CheckpointError` when the snapshot cannot
    even be unpickled into a SearchCheckpoint shell."""
    target = _resolve_snapshot(path)
    ckpt = _unpickle(_read_snapshot(target), f"snapshot {target!r}", decode=False)
    return {
        "path": target,
        "iteration": int(ckpt.iteration),
        "niterations": int(ckpt.niterations),
        "scheduler": ckpt.scheduler,
        "exact": bool(ckpt.exact),
        "format_version": int(ckpt.format_version),
    }


def dump_checkpoint_bytes(ckpt: SearchCheckpoint) -> bytes:
    """Serialize a snapshot to the format-2 wire encoding (flat-encoded
    populations, highest-protocol pickle) WITHOUT touching the filesystem.

    This is the elastic-membership shard format (slice 4 of the port): the
    leader publishes these bytes when a peer joins, and the joiner decodes
    them with :func:`load_checkpoint_bytes` — the identical (verified)
    representation the on-disk snapshots use, so shard adoption inherits
    every flat-IR invariant check for free."""
    return pickle.dumps(_flat_checkpoint(ckpt), protocol=pickle.HIGHEST_PROTOCOL)


def _flat_checkpoint(ckpt: SearchCheckpoint) -> SearchCheckpoint:
    """``ckpt`` with its populations flat-encoded (format 2), where it has
    any to encode."""
    if isinstance(ckpt.populations, list):
        flat = flatten_populations(ckpt.populations, ckpt.options_fingerprint)
        if flat is not None:
            ckpt = dataclasses.replace(
                ckpt, populations=flat, format_version=CHECKPOINT_FORMAT
            )
    return ckpt


class _JaxNamedPickler(pickle._Pickler):
    """Writes a global of the port (``symbolicregression_jl_tpu_torch.<module>``)
    under the JAX package's name (``symbolicregression_jl_tpu.<module>``),
    which has the same modules and classes, so that the JAX package's loader
    reads the bytes; :class:`_PortUnpickler` maps the names back. Python's
    own pickler, because the C one imports every global it writes to check
    it."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if module != _PORT_PACKAGE and not module.startswith(_PORT_PACKAGE + "."):
            return super().save_global(obj, name)
        self.save(_JAX_PACKAGE + module[len(_PORT_PACKAGE):])
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def load_checkpoint_bytes(data: bytes) -> SearchCheckpoint:
    """Decode + verify bytes produced by :func:`dump_checkpoint_bytes`.
    Raises :class:`CheckpointError` on corruption, exactly like
    :func:`load_checkpoint` does for on-disk snapshots."""
    return _unpickle(data, "checkpoint shard")


# -- streaming frontier frames ------------------------------------------------
#
# The serving layer pushes incremental Pareto-frontier updates to clients as
# the search runs. The wire format IS the format-2 checkpoint encoding: the
# frontier members travel as one flat-encoded population (every flat-IR
# invariant verified on decode), the hall_of_fame field stays an EMPTY stub
# (raw tree pickling is exactly what format 2 exists to avoid), and
# scheduler="frontier" marks the frame type so a frame is never mistaken for
# a resumable full-state snapshot.


class FrontierUpdate(NamedTuple):
    """One decoded streaming frame: the Pareto frontier at ``iteration``."""

    iteration: int
    niterations: int
    num_evals: float
    members: list  # PopMember frontier, best-per-complexity
    wall_time: float
    out_j: int


def dump_frontier_bytes(
    hall_of_fame,
    iteration: int = 0,
    niterations: int = 0,
    num_evals: float = 0.0,
    fingerprint: tuple = (),
    wall_time: float = 0.0,
    out_j: int = 1,
) -> bytes:
    """Encode a hall-of-fame Pareto frontier as one streaming frame.

    Members are copied before encoding, so the caller may pass the LIVE
    hall of fame from an iteration callback. ``fingerprint``
    (:func:`options_fingerprint`) supplies the operator counts for the
    decode-side op-range checks. The frame names the JAX package's classes
    (:class:`_JaxNamedPickler`): a subscriber decodes it with either
    package's :func:`load_frontier_bytes`."""
    from ..models.hall_of_fame import HallOfFame
    from ..models.population import Population

    members = [m.copy() for m in hall_of_fame.pareto_frontier()]
    ckpt = SearchCheckpoint(
        iteration=int(iteration),
        niterations=int(niterations),
        scheduler="frontier",
        exact=False,
        populations=[Population(members)] if members else [],
        hall_of_fame=HallOfFame(0),  # empty stub: the frontier travels flat
        num_evals=float(num_evals),
        options_fingerprint=tuple(fingerprint),
        wall_time=float(wall_time),
        out_j=int(out_j),
    )
    buf = io.BytesIO()
    _JaxNamedPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(_flat_checkpoint(ckpt))
    return buf.getvalue()


def load_frontier_bytes(data: bytes) -> FrontierUpdate:
    """Decode + verify a frame produced by :func:`dump_frontier_bytes`.
    Raises :class:`CheckpointError` on corruption or a non-frontier payload."""
    ckpt = load_checkpoint_bytes(data)
    if ckpt.scheduler != "frontier":
        raise CheckpointError(
            f"not a frontier frame (scheduler={ckpt.scheduler!r}); full-state "
            "snapshots resume searches, they do not stream"
        )
    members = [m for pop in ckpt.populations for m in pop.members]
    return FrontierUpdate(
        iteration=int(ckpt.iteration),
        niterations=int(ckpt.niterations),
        num_evals=float(ckpt.num_evals),
        members=members,
        wall_time=float(ckpt.wall_time),
        out_j=int(ckpt.out_j),
    )


class SearchCheckpointer:
    """Atomic rolling snapshot writer.

    Snapshots are ``{base}.{seq:06d}``, written tmp-first with an fsync and
    promoted by ``os.replace`` — a crash mid-write (exercised by the
    ``ckpt_crash`` fault) can only ever leave a ``.tmp`` orphan behind, never
    a torn snapshot; the previous snapshot stays loadable. At most ``keep``
    snapshots are retained (oldest pruned after each successful write). The
    sequence continues from existing snapshots, so a resumed run never
    overwrites its ancestors' files."""

    def __init__(
        self,
        base: str,
        every_iterations: int | None = None,
        every_seconds: float | None = None,
        keep: int = 3,
    ):
        self.base = base
        self.every_iterations = every_iterations
        self.every_seconds = every_seconds
        self.keep = max(1, int(keep))
        self._last_time = time.time()
        self._last_iter_saved = -1
        self.enospc_skipped = 0  # snapshots skipped on a full disk (previous
        #                          snapshot intact — the degradation contract)
        existing = _list_snapshots(base)
        self._seq = existing[-1][0] + 1 if existing else 0

    @classmethod
    def from_options(cls, options, base: str) -> "SearchCheckpointer | None":
        """None when checkpointing is disabled (both cadences unset)."""
        if (
            options.checkpoint_every is None
            and options.checkpoint_every_seconds is None
        ):
            return None
        return cls(
            base,
            every_iterations=options.checkpoint_every,
            every_seconds=options.checkpoint_every_seconds,
            keep=options.checkpoint_keep,
        )

    def due(self, iterations_done: int) -> bool:
        """Should a snapshot be written after ``iterations_done`` complete
        iterations? Safe to call repeatedly at the same count (async
        scheduler): a count already saved never re-triggers."""
        if (
            self.every_iterations
            and iterations_done > 0
            and iterations_done % self.every_iterations == 0
            and iterations_done != self._last_iter_saved
        ):
            return True
        return (
            self.every_seconds is not None
            and time.time() - self._last_time >= self.every_seconds
        )

    def save(self, ckpt: SearchCheckpoint) -> str:
        from . import faults

        # format 2: flat-encode the populations (verified on load). DAG trees
        # (graph_nodes shared subtrees) keep the format-1 raw pickling.
        data = dump_checkpoint_bytes(ckpt)
        path = f"{self.base}.{self._seq:06d}"
        tmp = path + ".tmp"
        inj = faults.active()
        try:
            if inj.armed("disk_full"):
                df = inj.fire("disk_full")
                if df is not None and str(df.get("path", "both")) in (
                    "ckpt", "both",
                ):
                    raise OSError(
                        _errno.ENOSPC, "No space left on device (injected)"
                    )
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        except OSError as exc:
            if exc.errno != _errno.ENOSPC:
                raise
            # disk full mid-snapshot: the atomic-rename discipline means the
            # PREVIOUS snapshot is still intact and loadable — drop the tmp
            # orphan, log, and keep searching undurably rather than killing
            # a healthy run over a full scratch disk
            try:
                os.remove(tmp)
            except OSError:
                pass
            self.enospc_skipped += 1
            print(
                f"[checkpoint] ENOSPC writing {path}: keeping previous "
                f"snapshot, search continues ({self.enospc_skipped} skipped)",
                flush=True,
            )
            snaps = _list_snapshots(self.base)
            return snaps[-1][1] if snaps else ""
        hit = inj.fire("ckpt_crash")
        if hit is not None:
            # kill-after-tmp-write: the torn-write window the atomic rename
            # exists to close — the tmp orphan stays, the promote never runs
            if hit.get("mode") == "exit":
                os._exit(int(hit.get("code", 44)))
            raise faults.CheckpointWriteCrash(
                f"injected ckpt_crash before os.replace -> {path!r}"
            )
        os.replace(tmp, path)
        self._seq += 1
        self._last_time = time.time()
        self._last_iter_saved = int(ckpt.iteration)
        self._prune()
        return path

    def _prune(self) -> None:
        snaps = _list_snapshots(self.base)
        for _, p in snaps[: -self.keep]:
            try:
                os.remove(p)
            except OSError:
                pass
