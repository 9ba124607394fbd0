"""sr-lint: project-specific static analysis for the PyTorch port.

Counterpart of ``symbolicregression_jl_tpu/analysis/lint.py`` with a rule
set for eager PyTorch on a CUDA card. It guards the invariants the port's
engine depends on and that otherwise only a run on the card checks: the
evolve leg makes no host sync and the const-opt leg only its known ones;
every random draw comes from an explicit ``torch.Generator``; compiled or
uploaded results are cached through ``serve.program_cache.ProgramCache``
under keys that name every ``Options`` field they depend on; and no hot
loop packs programs on the host or goes through a one-shot kernel entry.

Pure stdlib (ast + tokenize): ``scripts/sr_lint.py`` loads this module by
file path, so the lint runs where torch is not installed.

Rules
-----
==========  ==================================================================
SRL003      blocking host sync in an engine hot path: ``.item()``,
            ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
            ``.synchronize()``, ``torch.equal``; ``bool``/``int``/``float``
            of a tensor reduction, or one as an ``if``/``while`` test; and
            the data-dependent shapes (``.nonzero()``, ``torch.where(c)``,
            ``unique``, ``masked_select``, indexing by a visible mask)
SRL005      random draw outside an explicit generator: a ``torch`` sampler
            or in-place ``uniform_``/``normal_``/... without ``generator=``,
            ``torch.manual_seed``, numpy's global ``np.random.<fn>``
SRL007      cache key omits an ``Options`` field its cached body reads (the
            JAX rule, which also reads ``CACHE.get(kind, key)``)
SRL008      one-shot kernel entry (``interp_cuda.eval_trees_kernel``: packs
            and uploads on every call) inside a hot loop
SRL009      direct mutation of a module-level ``*CACHE*`` dict outside
            ``serve.program_cache.ProgramCache`` (the JAX rule)
SRL010      host program-IR packing (``pack_batch``, ``pack_programs``,
            ``pack_programs_fused``, ``flatten_trees``) inside a hot loop
==========  ==================================================================

Reserved ids: SRL001 (Python branch on a traced value), SRL002 (numpy on a
traced value), SRL004 (environment read at trace time) and SRL006 (read of
a donated buffer) are the JAX linter's rules for ``jit`` tracing and buffer
donation. The port traces nothing and donates nothing, so they have no
PyTorch form; their ids stay reserved and are never reused, so that an id
names one concern in both packages. SRL005 keeps its id for the port's form
of JAX's key discipline (one ``torch.Generator`` on the engine's device).

Hot paths: the engine's leg functions (``LEG_FUNCTIONS``, every line of
their bodies, nested functions included) and the loops of the drivers
(``DRIVER_FUNCTIONS``). SRL008 and SRL010 fire in loops of either, and
anywhere in a function that runs once per cycle (``PER_CYCLE_FUNCTIONS``).

Suppressions: a trailing ``# srl: disable=SRL003[,SRL010] [-- reason]``
comment silences those rule ids on its line; a comment-only line applies to
the next line. ``sr-lint`` reports suppressed findings only with
``--show-suppressed``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import tokenize

__all__ = ["RULES", "Finding", "lint_source", "lint_file", "lint_paths", "render_json"]

RULES = {
    "SRL003": (
        "host-sync-in-hot-path",
        "blocking host sync (.item(), .tolist(), .cpu(), .numpy(), .to('cpu'), "
        "synchronize, bool/int/float of a tensor reduction, a data-dependent "
        "shape) inside an engine hot path — the host waits for the card and "
        "the launch queue drains; keep the decision on the device "
        "(torch.where) or move the readback to the leg boundary",
    ),
    "SRL005": (
        "draw-outside-generator",
        "random draw without an explicit torch.Generator (a torch sampler or "
        "in-place uniform_/normal_/... without generator=, torch.manual_seed, "
        "numpy's global np.random.<fn>) — the process-wide stream is shared "
        "by every search and test in the process; draw from the engine's "
        "generator (EvoContext.gen) or a seeded np.random.default_rng",
    ),
    "SRL007": (
        "incomplete-cache-key",
        "cache key omits an Options field the cached body reads — a second "
        "search with a different value for that field silently reuses the "
        "stale cached result (the r06 k_copt incident)",
    ),
    "SRL008": (
        "one-shot-kernel-entry-in-hot-loop",
        "one-shot kernel entry (interp_cuda.eval_trees_kernel) inside an "
        "engine hot loop — it packs the batch on the host and uploads it on "
        "every call; pack once (on the device) and launch with "
        "interp_cuda.eval_preds on resident programs",
    ),
    "SRL009": (
        "ad-hoc-program-cache",
        "module-level program-cache dict mutated directly — ad-hoc cache "
        "dicts have no lock, no bound, and no counters (the pre-r12 "
        "_SCORE_FN_CACHE/_AOT_CACHE class, including an unlocked cross-"
        "thread .get race); route compiled-program caching through "
        "serve.program_cache (global_program_cache().get/put)",
    ),
    "SRL010": (
        "host-ir-pack-in-hot-loop",
        "host-side program-IR packing (pack_batch / pack_programs / "
        "pack_programs_fused / flatten_trees) inside an engine hot loop — "
        "every call re-packs the candidates, the per-cycle cost the "
        "kernel-resident evolve block exists to remove; pack once outside "
        "the loop or keep programs device-resident",
    ),
}

# -- project configuration ----------------------------------------------------

#: the engine's legs: a sync anywhere in these bodies (nested defs included)
#: stalls the card once per iteration or per cycle. Evolve leg
#: (ops/evolve.py, ops/evolve_block.py), const-opt leg
#: (models/device_search.py, ops/constant_opt._neldermead), and under a
#: mesh the sharded legs, the frontier merge and the rows combine
#: (ops/evolve.py, models/device_search.py) and the collectives
#: (parallel/mesh.py).
LEG_FUNCTIONS = {
    "run_iteration", "run_iteration_fused", "run_fleet_iteration_fused", "_event",
    "run_block_iteration", "run_block_iteration_fleet",
    "make_const_opt_fn", "make_fleet_const_opt_fn", "_select_and_jitter",
    "_accept_and_scatter", "_bfgs_lockstep", "_neldermead",
    "run_finalize", "_merge_best_seen", "make_sharded_iteration", "make_sharded_finalize",
    "iterate", "_combine_rows", "all_gather", "psum", "pmin", "_gather",
}
#: leg functions that run once per cycle: their whole body is a hot loop
PER_CYCLE_FUNCTIONS = {"_event", "_merge_best_seen", "_combine_rows"}
#: engine-driver functions whose loops are latency-critical. Extend when a
#: new scheduler loop lands.
DRIVER_FUNCTIONS = {
    "_search_one_output",
    "device_search_one_output",
    "fleet_search",
    "async_search_one_output",
    "s_r_cycle_lockstep",
}

#: parameter names treated as the Options object for SRL007.
OPTIONS_PARAM_NAMES = {"options"}

#: methods that copy to the host and wait for the card
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: torch functions that return a host bool computed on the card
SYNC_TORCH_FUNCS = {"equal", "allclose"}
#: reductions whose Python truth or number value is a device-to-host copy
REDUCTIONS = {
    "all", "any", "sum", "max", "min", "amax", "amin", "mean", "prod", "norm",
    "count_nonzero", "argmax", "argmin", "std", "var", "median",
}
#: calls whose output shape depends on the data (the host must read it)
DATA_SHAPE_FUNCS = {"nonzero", "argwhere", "masked_select", "unique", "unique_consecutive"}
#: calls that visibly produce a boolean mask
MASK_FUNCS = {
    "isfinite", "isnan", "isinf", "isposinf", "isneginf", "logical_and",
    "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt", "ge",
}

#: torch samplers that take ``generator=``; without it they draw from the
#: process-wide stream
TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli", "normal",
    "poisson",
}
#: torch samplers that take no generator at all
TORCH_GLOBAL_SAMPLERS = {"rand_like", "randn_like", "randint_like"}
#: in-place tensor samplers that take ``generator=`` (the method forms of
#: ``multinomial`` and ``bernoulli`` are left out: numpy's Generator has a
#: ``multinomial`` of its own)
TENSOR_SAMPLERS = {
    "uniform_", "normal_", "exponential_", "bernoulli_", "random_", "geometric_",
    "log_normal_", "cauchy_",
}
#: global seeding
GLOBAL_SEEDS = {"manual_seed", "manual_seed_all", "seed"}
#: np.random constructors of explicit generators (not draws)
NP_RANDOM_CONSTRUCTORS = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}

#: one-shot kernel entry points SRL008 bans from hot loops
ONESHOT_KERNEL_FUNCS = {"eval_trees_kernel"}
#: host program-IR packers SRL010 bans from hot loops
IR_PACK_FUNCS = {"pack_batch", "pack_programs", "pack_programs_fused", "flatten_trees"}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{tag} {self.message}"


# -- suppression comments -----------------------------------------------------

def _parse_suppressions(source: str) -> dict[int, tuple[set[str], str | None]]:
    """line -> (rule ids disabled on that line, reason). A comment-only line
    also applies to the next line (long flagged lines put the pragma above)."""
    out: dict[int, tuple[set[str], str | None]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return out
    # lines that hold only a comment (and whitespace/NL)
    code_lines = {
        t.start[0]
        for t in tokens
        if t.type
        not in (
            tokenize.COMMENT,
            tokenize.NL,
            tokenize.NEWLINE,
            tokenize.INDENT,
            tokenize.DEDENT,
            tokenize.ENDMARKER,
        )
    }
    for t in tokens:
        if t.type != tokenize.COMMENT:
            continue
        text = t.string.lstrip("#").strip()
        if not text.startswith("srl:"):
            continue
        body = text[len("srl:"):].strip()
        if not body.startswith("disable="):
            continue
        body = body[len("disable="):]
        reason = None
        if "--" in body:
            body, reason = body.split("--", 1)
            reason = reason.strip()
        ids = {x.strip().upper() for x in body.split(",") if x.strip()}
        line = t.start[0]
        prev = out.get(line, (set(), None))
        out[line] = (prev[0] | ids, reason or prev[1])
        if line not in code_lines:  # standalone pragma: applies to next line
            nxt = out.get(line + 1, (set(), None))
            out[line + 1] = (nxt[0] | ids, reason or nxt[1])
    return out


# -- AST utilities ------------------------------------------------------------

def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._srl_parent = node  # noqa: SLF001 — private annotation


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _tail(dotted: str | None) -> str | None:
    return dotted.rsplit(".", 1)[-1] if dotted else None


def _root(dotted: str | None) -> str | None:
    return dotted.split(".", 1)[0] if dotted else None


def _param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


def _enclosing_function(node: ast.AST):
    cur = getattr(node, "_srl_parent", None)
    while cur is not None and not isinstance(cur, _FUNC_DEFS):
        cur = getattr(cur, "_srl_parent", None)
    return cur


def _in_loop_below(node: ast.AST, top: ast.AST) -> bool:
    """Is ``node`` inside a loop (or comprehension) that lies inside ``top``?"""
    cur = getattr(node, "_srl_parent", None)
    while cur is not None and cur is not top:
        if isinstance(cur, _LOOPS):
            return True
        cur = getattr(cur, "_srl_parent", None)
    return False


def _hot_nodes(tree: ast.Module):
    """Yield (node, function name, in a hot loop) for every node of an engine
    hot path, once each: every node of a leg function's body, and every node
    inside a loop that a driver function owns."""
    seen: set[int] = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, _FUNC_DEFS):
            continue
        if fn.name in LEG_FUNCTIONS:
            per_cycle = fn.name in PER_CYCLE_FUNCTIONS
            for node in ast.walk(fn):
                if node is fn or id(node) in seen:
                    continue
                seen.add(id(node))
                yield node, fn.name, per_cycle or _in_loop_below(node, fn)
        elif fn.name in DRIVER_FUNCTIONS:
            loops = [n for n in ast.walk(fn)
                     if isinstance(n, (ast.For, ast.AsyncFor, ast.While))
                     and _enclosing_function(n) is fn]
            for lp in loops:
                for node in ast.walk(lp):
                    if node is lp or id(node) in seen:
                        continue
                    seen.add(id(node))
                    yield node, fn.name, True


# -- rule implementations -----------------------------------------------------

def _is_reduction(node: ast.AST) -> bool:
    """A tensor-valued expression whose truth or number value needs the host
    to read the card: a reduction call (``x.all()``), or arithmetic, a
    comparison, ``not`` or ``and``/``or`` over one."""
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if isinstance(node.func, ast.Attribute) and node.func.attr in REDUCTIONS:
            return _root(d) not in {"np", "numpy", "math", "builtins"}
        return False
    if isinstance(node, ast.Compare):
        return any(_is_reduction(x) for x in [node.left, *node.comparators])
    if isinstance(node, ast.UnaryOp):
        return _is_reduction(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_reduction(node.left) or _is_reduction(node.right)
    if isinstance(node, ast.BoolOp):
        return any(_is_reduction(v) for v in node.values)
    return False


def _mask_names(fn: ast.AST) -> set[str]:
    """Names a function binds to a visible boolean mask."""
    names: set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and _is_mask(node.value, set())):
            names.add(node.targets[0].id)
    return names


def _is_mask(node: ast.AST, names: set[str]) -> bool:
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, names)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(node.left, names) or _is_mask(node.right, names)
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if _tail(d) in MASK_FUNCS:
            return _root(d) == "torch" or (isinstance(node.func, ast.Attribute)
                                           and _root(d) not in {"np", "numpy", "math"})
        if isinstance(node.func, ast.Attribute) and node.func.attr == "bool" and not node.args:
            return True
    return False


def _is_cpu_device(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and _tail(_dotted(node.func)) == "device" and node.args:
        return _is_cpu_device(node.args[0])
    return False


def _sync_of(node: ast.AST, masks: set[str]) -> str | None:
    """The host sync ``node`` makes, as text, or None."""
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        name = _tail(d)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if _sync_of(node.func.value, masks):
                return None  # `.cpu().numpy()`: one sync, at the inner call
            if attr == "item" and not node.args:
                return ".item()"
            if attr in SYNC_METHODS - {"item"}:
                return f"{d}()" if attr == "synchronize" and d else f".{attr}()"
            if attr == "to" and (any(_is_cpu_device(a) for a in node.args[:1]) or any(
                    kw.arg == "device" and _is_cpu_device(kw.value) for kw in node.keywords)):
                return '.to("cpu")'
            if _root(d) in {"np", "numpy"}:
                return None
            if attr in DATA_SHAPE_FUNCS:
                return f".{attr}()" if _root(d) != "torch" else f"torch.{attr}(...)"
        if _root(d) == "torch" and name in SYNC_TORCH_FUNCS:
            return f"{d}(...)"
        if d == "torch.where" and len(node.args) == 1 and not node.keywords:
            return "torch.where(cond) (nonzero)"
        if isinstance(node.func, ast.Name) and name in {"bool", "int", "float"} and node.args:
            if _is_reduction(node.args[0]):
                return f"{name}() of a tensor reduction"
    elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
        if _is_reduction(node.test):
            kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional expression",
                    ast.Assert: "assert"}[type(node)]
            return f"`{kind}` on a tensor reduction"
    elif isinstance(node, ast.Subscript):
        sl = node.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        if any(_is_mask(p, masks) for p in parts):
            return "indexing by a boolean mask (nonzero)"
    return None


def _check_hot_sync(tree, path, findings):
    """SRL003: blocking host syncs in the engine's hot paths."""
    masks_of: dict[int, set[str]] = {}
    for node, fname, _ in _hot_nodes(tree):
        fn = _enclosing_function(node)
        masks = masks_of.get(id(fn))
        if masks is None:
            masks = masks_of[id(fn)] = _mask_names(fn) if fn is not None else set()
        sync = _sync_of(node, masks)
        if sync:
            findings.append(Finding(
                "SRL003", path, node.lineno, node.col_offset,
                f"blocking host sync {sync} in the `{fname}` engine hot path — "
                "the host waits for the card and the launch queue drains",
            ))


def _check_hot_loop_calls(tree, path, findings):
    """SRL008 (one-shot kernel entry) and SRL010 (host IR packing) inside a
    hot loop."""
    for node, fname, in_loop in _hot_nodes(tree):
        if not in_loop or not isinstance(node, ast.Call):
            continue
        name = _tail(_dotted(node.func))
        if name in ONESHOT_KERNEL_FUNCS:
            findings.append(Finding(
                "SRL008", path, node.lineno, node.col_offset,
                f"one-shot kernel entry {name}(...) inside the `{fname}` engine loop "
                "— packs and uploads the batch on every call; launch "
                "interp_cuda.eval_preds on programs packed once",
            ))
        elif name in IR_PACK_FUNCS:
            findings.append(Finding(
                "SRL010", path, node.lineno, node.col_offset,
                f"host IR packing {name}(...) inside the `{fname}` engine loop — "
                "re-packs candidate programs every pass; pack once outside the "
                "loop or keep programs device-resident",
            ))


def _check_global_draws(tree, path, findings):
    """SRL005: random draws outside an explicit generator, anywhere."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        name = _tail(d)
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        what = None
        if d is not None and d.startswith(("np.random.", "numpy.random.")):
            if d.count(".") == 2 and name not in NP_RANDOM_CONSTRUCTORS:
                what = f"numpy's global stream {d}(...)"
        elif _root(d) == "torch" and name in GLOBAL_SEEDS:
            what = f"global seeding {d}(...)"
        elif _root(d) == "torch" and d.count(".") == 1 and name in TORCH_SAMPLERS:
            if not has_gen:
                what = f"{d}(...) without generator="
        elif _root(d) == "torch" and d.count(".") == 1 and name in TORCH_GLOBAL_SAMPLERS:
            what = f"{d}(...) (no generator argument exists)"
        elif (isinstance(node.func, ast.Attribute) and name in TENSOR_SAMPLERS
              and _root(d) not in {"torch", "np", "numpy", "random"} and not has_gen):
            what = f".{name}(...) without generator="
        if what:
            findings.append(Finding(
                "SRL005", path, node.lineno, node.col_offset,
                f"random draw {what} — the process-wide stream is shared by "
                "every search in the process; draw from an explicit generator",
            ))


def _options_reads(fn: ast.FunctionDef) -> set[str]:
    """Attribute reads on parameters that carry the Options object."""
    params = set(_param_names(fn))
    opt_names = {
        p
        for p in params
        if p in OPTIONS_PARAM_NAMES
    }
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        ann = a.annotation
        if ann is not None and _tail(_dotted(ann)) == "Options":
            opt_names.add(a.arg)
    reads: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in opt_names
            and isinstance(node.ctx, ast.Load)
        ):
            reads.add(node.attr)
    return reads


def _module_call_graph(tree: ast.Module):
    """module-level function name -> (direct option-field reads,
    module-local callee names)."""
    info: dict[str, tuple[set[str], set[str]]] = {}
    for node in tree.body:
        if isinstance(node, _FUNC_DEFS):
            callees = {
                _tail(_dotted(c.func))
                for c in ast.walk(node)
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
            }
            info[node.name] = (_options_reads(node), {c for c in callees if c})
    return info


def _transitive_options_reads(names, graph, _seen=None) -> set[str]:
    seen = _seen if _seen is not None else set()
    out: set[str] = set()
    for name in names:
        if name in seen or name not in graph:
            continue
        seen.add(name)
        reads, callees = graph[name]
        out |= reads
        out |= _transitive_options_reads(callees, graph, seen)
    return out


def _check_cache_keys(tree, path, findings):
    """SRL007: for each `key = (...)` tuple later used as `CACHE.get(key)` or
    `CACHE.get(kind, key)` (or a `put` / `*_cache_put` / `setdefault` taking
    it), every Options field read by the cache-miss branch — directly or
    through module-local calls — must appear in the key tuple."""
    graph = _module_call_graph(tree)
    for fn in ast.walk(tree):
        if not isinstance(fn, _FUNC_DEFS):
            continue
        # key-tuple assignments in this function
        key_tuples: dict[str, ast.Assign] = {}
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Tuple)
            ):
                key_tuples[node.targets[0].id] = node
        if not key_tuples:
            continue

        body = list(ast.walk(fn))
        for key_name, assign in key_tuples.items():
            # cache use: CACHE.get(key) assigned to a result name, or a
            # direct put/setdefault
            result_name = None
            used_as_key = False
            for node in body:
                if not isinstance(node, ast.Call):
                    continue
                callee = _tail(_dotted(node.func))
                takes_key = any(
                    isinstance(a, ast.Name) and a.id == key_name for a in node.args
                )
                if not takes_key:
                    continue
                if callee in {"get", "put", "setdefault"} or (
                    callee is not None and callee.endswith("cache_put")
                ):
                    used_as_key = True
                    if callee == "get":
                        parent = getattr(node, "_srl_parent", None)
                        if (
                            isinstance(parent, ast.Assign)
                            and len(parent.targets) == 1
                            and isinstance(parent.targets[0], ast.Name)
                        ):
                            result_name = parent.targets[0].id
            if not used_as_key:
                continue

            # miss branch: `if <result> is None:` body
            miss_stmts: list[ast.stmt] = []
            if result_name is not None:
                for node in body:
                    if not isinstance(node, ast.If):
                        continue
                    t = node.test
                    if (
                        isinstance(t, ast.Compare)
                        and isinstance(t.left, ast.Name)
                        and t.left.id == result_name
                        and len(t.ops) == 1
                        and isinstance(t.ops[0], ast.Is)
                        and isinstance(t.comparators[0], ast.Constant)
                        and t.comparators[0].value is None
                    ):
                        miss_stmts.extend(node.body)
            if not miss_stmts:
                continue  # no statically-visible miss branch: nothing to diff

            in_key: set[str] = set()
            for sub in ast.walk(assign.value):
                if (
                    isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id in OPTIONS_PARAM_NAMES
                ):
                    in_key.add(sub.attr)

            direct: set[str] = set()
            callees: set[str] = set()
            for stmt in miss_stmts:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id in OPTIONS_PARAM_NAMES
                        and isinstance(sub.ctx, ast.Load)
                    ):
                        direct.add(sub.attr)
                    elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        callees.add(sub.func.id)
            body_reads = direct | _transitive_options_reads(callees, graph)
            missing = sorted(body_reads - in_key)
            if missing:
                findings.append(Finding(
                    "SRL007", path, assign.lineno, assign.col_offset,
                    f"cache key `{key_name}` omits Options field(s) its "
                    f"cached body reads: {', '.join(missing)} — a search "
                    "with a different value silently reuses the stale "
                    "compiled result",
                ))


#: dict methods that mutate in place (reads like .get/.keys are fine — the
#: rule bans forking cache POLICY, not observing the store)
_CACHE_DICT_MUTATORS = {"pop", "popitem", "setdefault", "update", "clear"}


def _check_adhoc_cache_mutation(tree, path, findings):
    """SRL009: module-level ALL-CAPS ``*CACHE*`` names bound to a dict
    literal (``= {}`` / ``= dict()`` / ``: dict = {}``) are ad-hoc program
    caches; any in-place mutation — subscript store, ``del``, or a mutating
    method call — bypasses the unified ProgramCache (lock, budgets,
    counters) and is flagged. Pure reads (membership tests, ``.get``,
    subscript loads) are allowed."""
    cache_names: set[str] = set()
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            target, value = node.target.id, node.value
        else:
            continue
        if "CACHE" not in target or target != target.upper():
            continue
        if isinstance(value, ast.Dict) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id == "dict"
        ):
            cache_names.add(target)
    if not cache_names:
        return
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id in cache_names
            and isinstance(node.ctx, (ast.Store, ast.Del))
        ):
            verb = "del on" if isinstance(node.ctx, ast.Del) else "store into"
            findings.append(Finding(
                "SRL009", path, node.lineno, node.col_offset,
                f"direct {verb} module-level cache dict "
                f"`{node.value.id}` — " + RULES["SRL009"][1].split(" — ")[1],
            ))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in cache_names
            and node.func.attr in _CACHE_DICT_MUTATORS
        ):
            findings.append(Finding(
                "SRL009", path, node.lineno, node.col_offset,
                f"`.{node.func.attr}()` on module-level cache dict "
                f"`{node.func.value.id}` — " + RULES["SRL009"][1].split(" — ")[1],
            ))


# -- driver -------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one source string. Returns ALL findings; suppressed ones carry
    ``suppressed=True`` (callers filter)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SRL000", path, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    _attach_parents(tree)
    findings: list[Finding] = []
    _check_hot_sync(tree, path, findings)
    _check_hot_loop_calls(tree, path, findings)
    _check_global_draws(tree, path, findings)
    _check_cache_keys(tree, path, findings)
    _check_adhoc_cache_mutation(tree, path, findings)

    suppressions = _parse_suppressions(source)
    for f in findings:
        sup = suppressions.get(f.line)
        if sup and (f.rule in sup[0] or "ALL" in sup[0]):
            f.suppressed = True
            f.reason = sup[1]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths) -> list[Finding]:
    """Lint files and/or directory trees (``*.py``, skipping ``__pycache__``
    and the lint fixture corpus, which is violations on purpose)."""
    findings: list[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames
                    if d != "__pycache__" and d != "lint_fixtures"
                ]
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        findings.extend(lint_file(os.path.join(dirpath, fname)))
        else:
            findings.extend(lint_file(p))
    return findings


def render_json(findings) -> str:
    return json.dumps([f.as_dict() for f in findings], indent=2)
