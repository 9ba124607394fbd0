"""The port's chaos soak (``symbolicregression_jl_tpu_torch/scripts/
chaos_soak.py``) on the CPU, against the JAX package's
``scripts/chaos_soak.py``.

``--emit-schedule`` prints JAX's bytes for every seed, host count and the
``--break`` rewrite; with ``run_soak`` replaced in both scripts by one
stand-in auditor, both ``main``s shrink to the same one-rule repro and write
the same repro file (apart from the script's path); the module imports
nothing of JAX; one real soak runs on the CPU (``--device cpu``) with every
invariant held, and without a card the default device is a rig error.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from symbolicregression_jl_tpu_torch.scripts import chaos_soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "symbolicregression_jl_tpu_torch", "scripts", "chaos_soak.py")
DEMO = ("disk_full@0:clear=1,host=h0,path=journal;ckpt_crash@0:host=h1;"
        "slow_client@1:delay_ms=100,host=net")


def _load_jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_soak_script", os.path.join(REPO, "scripts", "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsoak = _load_jax_soak()


@pytest.mark.parametrize("extra", [[], ["--hosts", "3"], ["--break", "shed_silently"],
                                   ["--duration", "25"]], ids=["h2", "h3", "break", "d25"])
@pytest.mark.parametrize("seed", range(10))
def test_emit_schedule_equals_jax_byte_for_byte(seed, extra, capsys):
    argv = ["--seed", str(seed), "--emit-schedule", *extra]
    assert chaos_soak.main(argv) == 0
    port = capsys.readouterr().out
    assert jsoak.main(argv) == 0
    assert port == capsys.readouterr().out
    assert port.startswith(f"CHAOS seed={seed} ") and "\nSCHEDULE " in port


class _StandIn:
    """An auditor that breaches ``no_lost_jobs`` iff the schedule holds the
    ``disk_full`` rule (what ``--break shed_silently`` makes of it)."""

    def __init__(self, schedule):
        self.ok = not any(r.site == "disk_full" for r in schedule)

    def breach_names(self):
        return set() if self.ok else {"no_lost_jobs"}

    def report(self):
        return "invariants: stand-in\n" + ("OK" if self.ok else "BREACH [no_lost_jobs]")


def test_shrinker_repro_equals_jax(tmp_path, monkeypatch, capsys):
    runs = {"port": [], "jax": []}

    def stand_in(side):
        def run_soak(schedule, duration_s, workdir, **kw):
            runs[side].append(len(schedule))
            return _StandIn(schedule)
        return run_soak

    monkeypatch.setattr(chaos_soak, "run_soak", stand_in("port"))
    monkeypatch.setattr(jsoak, "run_soak", stand_in("jax"))
    outs = {}
    for side, mod in (("port", chaos_soak), ("jax", jsoak)):
        repro = tmp_path / f"{side}.txt"
        rc = mod.main(["--seed", "0", "--duration", "25", "--break", "shed_silently",
                       "--schedule", DEMO, "--repro-out", str(repro)])
        assert rc == 1
        outs[side] = (capsys.readouterr().out, repro.read_text())
    (pout, pfile), (jout, jfile) = outs["port"], outs["jax"]
    line = "CHAOS_REPRO (1 rule(s)) disk_full@0:clear=1,host=h0,path=journal"
    assert line in pout and line in jout

    def lines(out):
        return [ln for ln in out.splitlines() if ln.lstrip().startswith(("shrink", "CHAOS"))]

    assert lines(pout) == lines(jout) and len(lines(pout)) > 4
    assert runs["port"] == runs["jax"] and len(runs["port"]) > 2
    assert pfile.replace("symbolicregression_jl_tpu_torch/scripts/chaos_soak.py",
                         "scripts/chaos_soak.py") == jfile
    assert pfile != jfile


def test_repro_names_the_cpu_device_when_run_there(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(chaos_soak, "run_soak", lambda schedule, *a, **kw: _StandIn(schedule))
    repro = tmp_path / "r.txt"
    assert chaos_soak.main(["--schedule", DEMO, "--break", "shed_silently", "--device", "cpu",
                            "--repro-out", str(repro)]) == 1
    capsys.readouterr()
    rerun = repro.read_text().splitlines()[1]
    assert rerun.startswith("# rerun: python symbolicregression_jl_tpu_torch/scripts/")
    assert rerun.endswith("--break shed_silently --device cpu")


def test_soak_imports_no_jax():
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        from symbolicregression_jl_tpu_torch.scripts import chaos_soak
        assert chaos_soak.main(["--seed", "3", "--emit-schedule"]) == 0
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CHAOS seed=3 ")


def test_real_soak_on_the_cpu_holds_every_invariant(tmp_path):
    """Seed 0's schedule (a kill, disk_full, kv_partition, clock_skew, wire
    faults) over two pod hosts and a NetServer, each a process, on the CPU;
    run as a file, as a user runs it."""
    out = subprocess.run([sys.executable, SCRIPT, "--seed", "0", "--duration", "10",
                          "--no-shrink", "--device", "cpu", "--workdir", str(tmp_path)],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "OK: all invariants held" in out.stdout and "CHAOS_SOAK=pass" in out.stdout
    assert "[chaos] kill h1" in out.stdout and "[chaos] respawn h1" in out.stdout
    [run] = [d for d in os.listdir(tmp_path) if d.startswith("run-")]
    reps = chaos_soak.read_reports(os.path.join(tmp_path, run))
    assert {r["host"] for r in reps} >= {"h0", "h1", "net"}
    assert not any(r["jax"] for r in reps)
    fired = [f for r in reps for f in r["faults"] if f.endswith(" fired")]
    assert any(f.startswith("disk_full") for f in fired), fired


def test_without_a_card_the_default_device_is_a_rig_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the soak would run there")
    out = subprocess.run([sys.executable, "-m", "symbolicregression_jl_tpu_torch.scripts."
                          "chaos_soak", "--seed", "0", "--duration", "5", "--no-shrink"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "CHAOS_SOAK=error" in out.stdout and "no CUDA device" in out.stdout
