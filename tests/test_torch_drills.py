"""The port's drill CLIs (``symbolicregression_jl_tpu_torch/scripts/``:
``debug_checks_smoke``, ``serve_smoke``, ``fleet_smoke``, ``stream_smoke``,
``net_smoke``, ``fault_smoke``), the counterparts of the JAX package's
``scripts/*.py`` smokes.

Each script imports nothing of JAX, its child templates included, and
without ``--device cpu`` on a machine with no card it exits 2. The fault
smoke's cycles, invariant strings, ``all`` table, ``FAULT_SMOKE=`` line,
unknown-cycle message and exit codes are JAX's, read from
``scripts/fault_smoke.py`` without importing it. The debug-checks drill
runs whole on the CPU with the verifier counted at each gated site, and the
serve drill at a reduced depth. The cancel mid-fleet and the fault smoke's
retry / quarantine escalation are in ``tests/test_torch_drills_serve.py``.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from symbolicregression_jl_tpu_torch.analysis import ir_verify
from symbolicregression_jl_tpu_torch.scripts import debug_checks_smoke, fault_smoke, serve_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("debug_checks_smoke", "serve_smoke", "fleet_smoke", "stream_smoke", "net_smoke",
           "fault_smoke")
JAX_FAULT_SMOKE = os.path.join(ROOT, "scripts", "fault_smoke.py")


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_without_jax_and_needs_a_card(name):
    """In a process where importing jax or the JAX package fails: the script
    imports, so does every module its functions and its child templates
    import (each template formatted and parsed), nothing of JAX is loaded,
    and run as a file without ``--device cpu`` and without a card it exits
    2 (a rig error) before any drill."""
    code = textwrap.dedent(f"""
        import ast, collections, importlib, json, runpy, sys
        for n in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[n] = None
        sys.path.insert(0, {ROOT!r})
        mod = importlib.import_module("symbolicregression_jl_tpu_torch.scripts.{name}")
        sources = [open(mod.__file__).read()]
        blank = collections.defaultdict(lambda: "0")
        sources += [v.format_map(blank) for k, v in vars(mod).items()
                    if k.startswith("_") and not k.startswith("__")
                    and isinstance(v, str) and "import " in v]
        modules = set()
        for src in sources:
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.Import):
                    modules.update(a.name for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    m = importlib.import_module(node.module)
                    for a in node.names:
                        if not hasattr(m, a.name):  # a submodule
                            importlib.import_module(node.module + "." + a.name)
                    modules.add(node.module)
        for m in modules:
            importlib.import_module(m)
        jax = sorted(m for m, v in sys.modules.items() if v is not None and (
            m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))))
        sys.argv = [mod.__file__]
        try:
            runpy.run_path(mod.__file__, run_name="__main__")
            code = 0
        except SystemExit as e:
            code = e.code
        print(json.dumps({{"templates": len(sources) - 1, "modules": sorted(modules),
                           "jax": jax, "code": code}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax"] == [] and got["code"] == 2, (got, out.stderr)
    assert "no CUDA device" in out.stderr
    assert "symbolicregression_jl_tpu_torch" in " ".join(got["modules"])
    # the templates of the children that run the port
    want = {"net_smoke": 1, "fault_smoke": 5}.get(name, 0)
    assert got["templates"] == want


def _jax_drills():
    """JAX's ``_DRILLS`` as (name, function name, invariant), by ``ast``."""
    tree = ast.parse(open(JAX_FAULT_SMOKE).read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "_DRILLS")
    return [(e.elts[0].value, e.elts[1].id, e.elts[2].value) for e in node.value.elts]


def test_fault_smoke_cycles_are_jax_s():
    """The same six cycles in the same order, each pinning the same
    invariant, run by the function of the same name."""
    port = [(name, fn.__name__, inv) for name, fn, inv in fault_smoke._DRILLS]
    assert port == _jax_drills()
    assert [n for n, _, _ in port] == ["checkpoint", "exchange", "elastic", "serve", "net",
                                       "pod"]


def test_fault_smoke_unknown_cycle_is_jax_s():
    """An unknown cycle: JAX's message on stderr and its exit code, before
    any drill (and before the card is looked for)."""
    runs = [subprocess.run([sys.executable, path, "checkpoint", "bogus", "nope"],
                           capture_output=True, text=True, cwd=ROOT, timeout=120,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
            for path in (JAX_FAULT_SMOKE, fault_smoke.__file__)]
    assert runs[0].returncode == runs[1].returncode == 1
    assert runs[0].stderr == runs[1].stderr
    assert runs[1].stderr.startswith("unknown cycle(s): ['bogus', 'nope'] (choose from: "
                                     "checkpoint exchange elastic serve net pod)")
    assert runs[1].stdout == ""


def _jax_run_all(drills):
    """JAX's ``_run_all``, compiled from its source over ``drills``."""
    import time

    tree = ast.parse(open(JAX_FAULT_SMOKE).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_run_all")
    ns = {"time": time, "_DRILLS": drills}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), JAX_FAULT_SMOKE, "exec"), ns)
    return ns["_run_all"]


def _ok(*_):
    pass


def _breach(*_):
    raise SystemExit("FAIL: an invariant broke")


def _crash(*_):
    raise RuntimeError("drill crashed")


@pytest.mark.parametrize("fns, which", [
    ((_ok,) * 6, {"all"}),
    ((_ok, _breach, _ok, _ok, _ok, _ok), {"all"}),
    ((_ok, _ok, _crash, _ok, _ok, _ok), {"elastic", "net", "checkpoint"}),
])
def test_fault_smoke_table_and_exit_code_are_jax_s(monkeypatch, capsys, fns, which):
    """``_run_all`` over stand-in drills (pass, a breach, a crash): the same
    verdict table, ``FAULT_SMOKE=`` line and return code as JAX's."""
    drills = tuple((name, fn, inv) for (name, _, inv), fn in zip(_jax_drills(), fns))
    rc_jax = _jax_run_all(drills)(which)
    out_jax = capsys.readouterr().out
    monkeypatch.setattr(fault_smoke, "_DRILLS", drills)
    rc_port = fault_smoke._run_all(which, "cpu")
    out_port = capsys.readouterr().out
    assert (rc_port, out_port) == (rc_jax, out_jax)
    assert out_port.splitlines()[-1] == ("FAULT_SMOKE=pass" if fns == (_ok,) * 6
                                         else "FAULT_SMOKE=fail")


def _count_verify_calls(monkeypatch):
    """The verifier's calls by site (its ``where`` prefix), through the
    module attribute every gated site calls."""
    calls = {}
    real = ir_verify.verify_flat_trees

    def counting(*a, **kw):
        site = kw.get("where", "").split(":")[0]
        calls[site] = calls.get(site, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(ir_verify, "verify_flat_trees", counting)
    return calls


def test_debug_checks_smoke_on_cpu(monkeypatch, capsys):
    """The whole drill on the CPU: with the gate on, every gated site of
    the port verifies real search traffic (the lockstep scorer, the engine's
    frontier readback and population decode), nothing raises, and the
    drill leaves ``SR_DEBUG_CHECKS`` as it found it."""
    monkeypatch.delenv("SR_DEBUG_CHECKS", raising=False)
    calls = _count_verify_calls(monkeypatch)
    debug_checks_smoke.run("cpu")
    assert "SR_DEBUG_CHECKS" not in os.environ
    for site in ("scorer.loss_many_async", "device_search._bs_to_members",
                 "device_search._decode_state_populations"):
        assert calls.get(site, 0) > 0, calls
    out = capsys.readouterr().out
    assert out.count("resume ok") == 2 and out.endswith("[debug-checks-smoke] PASS\n")

    monkeypatch.setenv("SR_DEBUG_CHECKS", "0")
    calls.clear()
    debug_checks_smoke.run("cpu", niterations=1, resume_iterations=2)
    assert os.environ["SR_DEBUG_CHECKS"] == "0"
    assert calls.get("scorer.loss_many_async", 0) > 0


def test_serve_smoke_on_cpu(monkeypatch):
    """The serve drill at a reduced depth (a 3-iteration preempted job, 10
    cycles): 6 DONE, the doomed job EXPIRED before it started, the low job
    preempted once and resumed to its whole budget, the last frames closing
    each budget, the warm-hit ratio above 0.5; both tenants ran under
    ``default_quota=4`` and every quota slot came back."""
    import symbolicregression_jl_tpu_torch.serve as serve_pkg

    made = []

    class Recorded(serve_pkg.SearchServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(serve_pkg, "SearchServer", Recorded)
    st = serve_smoke.run("cpu", low_iterations=3, cycles=10)
    assert st["jobs"] == {"done": 7, "expired": 1}
    assert st["program_cache"]["misses"] == 3 and st["warm_hit_ratio"] > 0.5
    (srv,) = made
    queue = srv._queue
    assert queue.default_quota == 4
    tenants = {j.spec.tenant: [] for j in srv._jobs.values()}
    for j in srv._jobs.values():
        tenants[j.spec.tenant].append(j.state)
    assert sorted(tenants) == ["acme", "zeta"]
    assert tenants["acme"] == ["done"] * 4
    assert sorted(tenants["zeta"]) == ["done", "done", "done", "expired"]
    assert not any(queue._running_by_tenant.values())
