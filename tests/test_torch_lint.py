"""The port's sr-lint (``symbolicregression_jl_tpu_torch/analysis/lint.py``,
the torch rule set) and its CLI (``symbolicregression_jl_tpu_torch/scripts/
sr_lint.py``), on the CPU.

Holds the port's linter to the JAX package's where the concern is the same
(SRL007, SRL009 and the suppression grammar, on JAX's own fixture corpus:
equal findings and equal ``render_json``), checks every torch rule on an
inline violation and its clean twin at the exact lines it must fire on,
the JAX rule's four false positives on the port's engine (``np.asarray`` of
the allgathered host arrays) staying silent, the two known const-opt syncs
found when their suppressions are stripped, the port package linting clean
with a reason on every suppression, and the CLI (exit codes, ``--json``,
``--list-rules``, ``--show-suppressed``) run as a file with torch and jax
blocked.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "symbolicregression_jl_tpu_torch")
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
LINT_PY = os.path.join(PKG, "analysis", "lint.py")
JAX_LINT_PY = os.path.join(REPO, "symbolicregression_jl_tpu", "analysis", "lint.py")
CLI = os.path.join(PKG, "scripts", "sr_lint.py")
ACTIVE = ["SRL003", "SRL005", "SRL007", "SRL008", "SRL009", "SRL010"]
RESERVED = ["SRL001", "SRL002", "SRL004", "SRL006"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


lint = _load(LINT_PY, "sr_lint_torch_test_impl")
jlint = _load(JAX_LINT_PY, "sr_lint_jax_test_impl")


def _key(findings):
    return [(f.rule, f.line, f.col, f.suppressed, f.reason) for f in findings]


def _expected(src):
    """line -> rule id, from ``# EXPECT: SRLnnn`` markers."""
    return {i: m.group(1) for i, line in enumerate(src.splitlines(), 1)
            if (m := re.search(r"#\s*EXPECT:\s*(SRL\d+)", line))}


def _check_case(src, rule):
    src = textwrap.dedent(src)
    want = {ln for ln, r in _expected(src).items() if r == rule}
    found = lint.lint_source(src, "case.py")
    assert {f.line for f in found if f.rule == rule} == want, [f.render() for f in found]
    assert not [f for f in found if f.rule != rule], [f.render() for f in found]


# -- the module itself -----------------------------------------------------------


def test_stdlib_only_and_loads_with_torch_and_jax_blocked():
    tree = ast.parse(open(LINT_PY).read())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            top.add((node.module or "").split(".")[0])
    assert top <= {"ast", "dataclasses", "io", "json", "os", "tokenize", "__future__"}, top
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in ("torch", "jax", "jaxlib", "numpy", "symbolicregression_jl_tpu",
                     "symbolicregression_jl_tpu_torch"):
            sys.modules[name] = None
        spec = importlib.util.spec_from_file_location("l", {LINT_PY!r})
        mod = importlib.util.module_from_spec(spec)
        sys.modules["l"] = mod
        spec.loader.exec_module(mod)
        print(len(mod.lint_source("def _bfgs_lockstep(x):\\n    return x.item()\\n")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


def test_rule_table_keeps_the_ids_and_reserves_the_jax_only_ones():
    assert sorted(lint.RULES) == ACTIVE
    assert set(ACTIVE) <= set(jlint.RULES) and set(RESERVED) <= set(jlint.RULES)
    doc = lint.__doc__
    for rid in RESERVED:
        assert rid in doc
    assert "never reused" in doc
    assert lint.RULES["SRL009"] == jlint.RULES["SRL009"]


# -- parity with the JAX linter ----------------------------------------------------


@pytest.mark.parametrize("name", ["srl007_clean.py", "srl007_violation.py",
                                  "srl009_clean.py", "srl009_violation.py"])
def test_shared_rules_equal_jax_on_its_fixtures(name):
    path = os.path.join(FIXTURES, name)
    src = open(path).read()
    got, want = lint.lint_source(src, path), jlint.lint_source(src, path)
    assert _key(got) == _key(want)
    assert lint.render_json(got) == jlint.render_json(want)
    if name.endswith("violation.py"):
        assert got and {f.rule for f in got} == {name[:6].upper()}


def test_suppressed_fixture_equal_jax_on_the_port_rules():
    """``suppressed.py`` silences SRL001 and SRL004, which the port retires:
    the port reports nothing there, which is JAX's report restricted to the
    port's rules, and the suppression table is JAX's."""
    path = os.path.join(FIXTURES, "suppressed.py")
    src = open(path).read()
    want = [f for f in jlint.lint_source(src, path) if f.rule in lint.RULES]
    assert _key(lint.lint_source(src, path)) == _key(want) == []
    assert lint._parse_suppressions(src) == jlint._parse_suppressions(src)
    assert {f.rule for f in jlint.lint_source(src, path)} == {"SRL001", "SRL004"}


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py")))
def test_suppression_grammar_equals_jax(name):
    src = open(os.path.join(FIXTURES, name)).read()
    assert lint._parse_suppressions(src) == jlint._parse_suppressions(src)


def test_suppression_forms_and_parse_error():
    src = textwrap.dedent("""
        def _bfgs_lockstep(x, y):
            a = x.item()  # srl: disable=SRL003 -- trailing form
            # srl: disable=SRL003,SRL005 -- standalone form
            b = y.item()
            c = x.cpu()
            return a, b, c
    """)
    found = lint.lint_source(src)
    assert [(f.line, f.suppressed, f.reason) for f in found] == [
        (3, True, "trailing form"), (5, True, "standalone form"), (6, False, None)]
    [bad] = lint.lint_source("def f(:\n", "broken.py")
    assert bad.rule == "SRL000" and bad.path == "broken.py"


# -- the torch rules ---------------------------------------------------------------


SRL003_VIOLATION = """
import numpy as np
import torch


def _bfgs_lockstep(x, g, f, frozen, d):
    a = f.item()  # EXPECT: SRL003
    b = g.tolist()  # EXPECT: SRL003
    c = g.cpu().numpy()  # EXPECT: SRL003
    e = x.numpy()  # EXPECT: SRL003
    h = x.to("cpu")  # EXPECT: SRL003
    k = x.to(device=torch.device("cpu"))  # EXPECT: SRL003
    torch.cuda.synchronize()  # EXPECT: SRL003
    if bool(frozen.all()):  # EXPECT: SRL003
        return a
    n = int(g.sum())  # EXPECT: SRL003
    m = float(f.max() - 1)  # EXPECT: SRL003
    if frozen.any():  # EXPECT: SRL003
        return b
    while (f > 0).all():  # EXPECT: SRL003
        f = f - 1
    idx = g.nonzero()  # EXPECT: SRL003
    idx = torch.nonzero(g)  # EXPECT: SRL003
    rows = torch.where(frozen)  # EXPECT: SRL003
    u = torch.unique(g)  # EXPECT: SRL003
    same = torch.equal(f, g)  # EXPECT: SRL003
    pos = x[x > 0]  # EXPECT: SRL003
    ok = torch.isfinite(f)
    kept = f[ok]  # EXPECT: SRL003
    f[~ok] = 0.0  # EXPECT: SRL003
    return a, b, c, e, h, k, n, m, idx, rows, u, same, pos, kept


def device_search_one_output(state, niterations):
    total = 0.0
    for it in range(niterations):
        total += state.loss.mean().item()  # EXPECT: SRL003
    return total, state.loss.cpu()
"""

SRL003_CLEAN = """
import numpy as np
import torch


def _bfgs_lockstep(x, g, f, frozen, d, iters, options):
    n = int(options.optimizer_iterations)
    k = float(iters * 2)
    bad = (g * d).sum(-1) >= 0
    d = torch.where(bad[:, None], -g, d)
    f = torch.where(frozen, f, f - 1)
    cols = g[:, None]
    host = [float(v) for v in range(n)]
    return x, d, f, cols, host, k


def device_search_one_output(state, niterations, g):
    total = state.loss.mean().item()
    for it in range(niterations):
        state = state.step()
    # the final allgather's host arrays (the JAX rule's four false positives)
    for pi in range(np.asarray(g[0]).shape[0]):
        bl = np.asarray(g[0][pi])
        bn = np.asarray(g[1][pi]).astype(np.int32)
        flds = [np.asarray(g[2 + j][pi]) for j in range(6)]
    return total, bl, bn, flds


def decode(buf):
    return buf.cpu().numpy().tolist(), bool(buf.all())
"""

SRL005_VIOLATION = """
import numpy as np
import torch


def draw(shape, p, t, x):
    a = torch.rand(shape)  # EXPECT: SRL005
    b = torch.randn(shape, device="cuda")  # EXPECT: SRL005
    c = torch.randint(0, 5, (3,))  # EXPECT: SRL005
    d = torch.randperm(7)  # EXPECT: SRL005
    e = torch.multinomial(p, 2)  # EXPECT: SRL005
    f = torch.bernoulli(p)  # EXPECT: SRL005
    g = torch.rand_like(x)  # EXPECT: SRL005
    t.uniform_()  # EXPECT: SRL005
    t.normal_(0.0, 1.0)  # EXPECT: SRL005
    t.exponential_()  # EXPECT: SRL005
    torch.manual_seed(0)  # EXPECT: SRL005
    h = np.random.rand(3)  # EXPECT: SRL005
    np.random.seed(0)  # EXPECT: SRL005
    return a, b, c, d, e, f, g, h
"""

SRL005_CLEAN = """
import numpy as np
import torch


def draw(shape, p, t, gen, seed):
    gen.manual_seed(seed)
    a = torch.rand(shape, generator=gen)
    b = torch.randn(shape, generator=gen, device="cuda")
    c = torch.randint(0, 5, (3,), generator=gen)
    d = torch.randperm(7, generator=gen)
    e = torch.multinomial(p, 2, generator=gen)
    t.uniform_(generator=gen)
    t.normal_(0.0, 1.0, generator=gen)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=3)
    q = np.random.Generator(np.random.PCG64(seed))
    return a, b, c, d, e, h, q
"""

SRL007_VIOLATION = """
def _build(options, X):
    return (options.loss, options.batch_size, X)


def cached(options, X, digest):
    key = (digest, options.loss)  # EXPECT: SRL007
    data = PROGRAM_CACHE.get("score_data", key)
    if data is None:
        data = _build(options, X)
        data = PROGRAM_CACHE.put("score_data", key, data)
    return data
"""

SRL007_CLEAN = """
def _build(options, X):
    return (options.loss, options.batch_size, X)


def cached(options, X, digest):
    key = (digest, options.loss, options.batch_size)
    data = PROGRAM_CACHE.get("score_data", key)
    if data is None:
        data = _build(options, X)
        data = PROGRAM_CACHE.put("score_data", key, data)
    return data
"""

SRL008_VIOLATION = """
from ..ops import interp_cuda


def device_search_one_output(flat, X, opset, niterations):
    preds = interp_cuda.eval_trees_kernel(flat, X, opset)
    for it in range(niterations):
        preds = interp_cuda.eval_trees_kernel(flat, X, opset)  # EXPECT: SRL008
    return preds


def run_iteration(state, flat, X, opset, cycles):
    for c in range(cycles):
        state = state + eval_trees_kernel(flat, X, opset)  # EXPECT: SRL008
    return state
"""

SRL008_CLEAN = """
from ..ops import interp_cuda


def device_search_one_output(flat, X, opset, niterations):
    prog, vals = interp_cuda.pack_programs_fused(flat, opset)
    prog, vals = prog.to(X.device), vals.to(X.device)
    for it in range(niterations):
        preds = interp_cuda.eval_preds(prog, vals, X, opset)
    return preds


def check(flat, X, opset, batches):
    return [interp_cuda.eval_trees_kernel(f, X, opset) for f in batches]
"""

SRL010_VIOLATION = """
def run_iteration(state, data, ctx, cycles, opset):
    for c in range(cycles):
        prog, vals = pack_batch(state.members, opset)  # EXPECT: SRL010
    return state


def _event(state, opset, trees, n):
    flat = flatten_trees(trees, n)  # EXPECT: SRL010
    return pack_programs(flat)  # EXPECT: SRL010


def fleet_search(lanes, niterations, opset):
    for it in range(niterations):
        progs = [pack_programs_fused(l.flat, opset) for l in lanes]  # EXPECT: SRL010
    return progs
"""

SRL010_CLEAN = """
def make_fleet_const_opt_fn(options, opset):
    def prepare(state):
        prog_k, _ = pack_batch(state.members, opset)
        return prog_k

    def const_opt(states):
        return [prepare(st) for st in states]

    return const_opt


def fleet_search(lanes, niterations, opset, trees, n):
    flat = flatten_trees(trees, n)
    for it in range(niterations):
        lanes = [l.step() for l in lanes]
    return flat, lanes


def warmup(trees, n, rounds):
    for _ in range(rounds):
        flatten_trees(trees, n)
"""

CASES = {
    "SRL003": (SRL003_VIOLATION, SRL003_CLEAN),
    "SRL005": (SRL005_VIOLATION, SRL005_CLEAN),
    "SRL007": (SRL007_VIOLATION, SRL007_CLEAN),
    "SRL008": (SRL008_VIOLATION, SRL008_CLEAN),
    "SRL010": (SRL010_VIOLATION, SRL010_CLEAN),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_torch_rule_fires_exactly_where_expected(rule):
    _check_case(CASES[rule][0], rule)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_torch_rule_clean_twin_is_silent(rule):
    src = textwrap.dedent(CASES[rule][1])
    assert not lint.lint_source(src, "clean.py"), [
        f.render() for f in lint.lint_source(src, "clean.py")]


def test_srl007_names_the_missing_field_in_the_two_argument_form():
    [f] = lint.lint_source(textwrap.dedent(SRL007_VIOLATION))
    assert "batch_size" in f.message and "loss," not in f.message


# -- the port's own code -----------------------------------------------------------


def _source(rel):
    return open(os.path.join(PKG, rel)).read()


def test_jax_false_positives_on_the_port_stay_silent():
    """JAX's SRL003 flags ``np.asarray`` of the allgathered host arrays in
    the port's final hall-of-fame sync (four findings); the torch rule set
    does not, and finds the port's real syncs instead."""
    path = os.path.join(PKG, "models", "device_search.py")
    src = open(path).read()
    jax_hits = [f for f in jlint.lint_source(src, path) if f.rule == "SRL003"]
    assert len(jax_hits) == 4
    assert all("np.asarray" in f.message for f in jax_hits)
    port = {f.line for f in lint.lint_source(src, path)}
    assert not port & {f.line for f in jax_hits}
    lines = src.splitlines()
    assert {lines[ln - 1].strip() for ln in port} == {
        "payload = (fetch(), *(a.cpu().numpy() for a in pool_dev))"}


def _function_source(rel, name):
    src = _source(rel)
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return "\n".join(src.splitlines()[fn.lineno - 1:fn.end_lineno]) + "\n"


def test_canary_const_opt_syncs_found_without_their_suppressions():
    """``_bfgs_lockstep`` carries no suppression and no SRL003 finding, and
    a stop test on the host injected into its loop is found."""
    body = _function_source("models/device_search.py", "_bfgs_lockstep")
    assert "srl:" not in body
    assert not lint.lint_source(body)
    lines = body.splitlines()
    fn = ast.parse(body).body[0]
    loop = next(n for n in fn.body if isinstance(n, ast.For))
    first = loop.body[0]
    indent = " " * first.col_offset
    lines.insert(first.lineno - 1, f"{indent}if bool(x.all()):")
    lines.insert(first.lineno, f"{indent}    break")
    found = lint.lint_source("\n".join(lines) + "\n")
    assert [(f.rule, f.line, f.suppressed) for f in found] == [("SRL003", first.lineno, False)]


def test_canary_item_injected_into_the_evolve_leg_is_found():
    body = _function_source("ops/evolve.py", "run_iteration")
    assert not lint.lint_source(body)
    lines = body.splitlines()
    # the first statement after the docstring and signature: indent of body
    fn = ast.parse(body).body[0]
    first = fn.body[1] if isinstance(fn.body[0], ast.Expr) else fn.body[0]
    indent = " " * first.col_offset
    lines.insert(first.lineno - 1, f"{indent}_probe = state.loss.sum().item()")
    found = lint.lint_source("\n".join(lines) + "\n")
    assert [(f.rule, f.line) for f in found] == [("SRL003", first.lineno)]


def test_port_package_lints_clean_with_a_reason_on_every_suppression():
    findings = lint.lint_paths([PKG])
    assert not [f for f in findings if not f.suppressed], [
        f.render() for f in findings if not f.suppressed]
    assert findings, "the port's known syncs carry suppressed findings"
    assert all(f.reason for f in findings), [f.render() for f in findings if not f.reason]
    banned = re.compile(r"test|harness|driver", re.I)
    assert not [f.reason for f in findings if banned.search(f.reason)]


# -- the CLI -------------------------------------------------------------------------


def _cli(*args, cwd=None, blocked=True):
    """The CLI run as a file; with ``blocked``, torch, jax and both packages
    cannot be imported in its process."""
    pre = ("import runpy, sys\n"
           + ("for n in ('torch', 'jax', 'jaxlib', 'symbolicregression_jl_tpu', "
              "'symbolicregression_jl_tpu_torch'):\n    sys.modules[n] = None\n"
              if blocked else "")
           + f"sys.argv = [{CLI!r}, *{list(args)!r}]\n"
           + f"runpy.run_path({CLI!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", pre], capture_output=True, text=True,
                          cwd=cwd, timeout=300)


def test_cli_lints_the_port_clean_from_any_cwd_without_torch(tmp_path):
    r = _cli(PKG, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout == ""
    r = subprocess.run([sys.executable, CLI, PKG], capture_output=True, text=True,
                       cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_exit_codes_json_and_show_suppressed(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(SRL005_VIOLATION))
    ok = tmp_path / "ok.py"
    ok.write_text(textwrap.dedent(SRL005_CLEAN))
    r = _cli("--json", str(bad))
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert {f["rule"] for f in payload} == {"SRL005"}
    assert len(payload) == len(_expected(textwrap.dedent(SRL005_VIOLATION)))
    assert set(payload[0]) == {"rule", "path", "line", "col", "message", "suppressed", "reason"}
    r = _cli(str(bad))
    assert r.returncode == 1 and "finding(s)" in r.stderr
    assert _cli(str(ok)).returncode == 0
    r = _cli()
    assert r.returncode == 2 and "usage" in r.stderr
    r = _cli("--json", PKG)
    assert r.returncode == 0 and json.loads(r.stdout) == []
    r = _cli("--json", "--show-suppressed", PKG)
    shown = json.loads(r.stdout)
    assert r.returncode == 0 and shown and all(f["suppressed"] and f["reason"] for f in shown)
    r = _cli("--show-suppressed", PKG)
    assert r.returncode == 0 and "(suppressed)" in r.stdout


def test_cli_list_rules_and_module_form():
    r = _cli("--list-rules")
    assert r.returncode == 0
    listed = re.findall(r"^(SRL\d+)", r.stdout, re.M)
    assert listed == ACTIVE
    r = subprocess.run([sys.executable, "-m", "symbolicregression_jl_tpu_torch.scripts.sr_lint",
                        "--list-rules"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0 and re.findall(r"^(SRL\d+)", r.stdout, re.M) == ACTIVE
