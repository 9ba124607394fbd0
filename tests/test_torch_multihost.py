"""PyTorch port vs JAX package: a REAL 2-process search.

Two fresh interpreters join one world through the port's
``parallel/distributed.initialize`` (a TCPStore hosted by rank 0, a gloo
process group) and run the device engine on the CPU, each on half the
islands, exchanging the readback and the migration pool once per
iteration through an ``ExchangeGroup`` on that store. Both must end with
IDENTICAL halls of fame (the lockstep property), and the best loss must
pass the JAX package's bar and sit within a stated band of the JAX
package's own 2-process run of the same script (``tests/test_multihost.py``'s
worker, run once for the module). The uneven split raises on every
process; the pipelined (stale-pool) exchange stays lockstep; per-process
``.p{rank}`` snapshots are written and ``resume_from`` finds them. The
peer-death cases are marked ``slow``, as the JAX package's are.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "_jax_multihost", os.path.join(REPO, "tests", "test_multihost.py"))
_jax_multihost = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_multihost)

_PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
pid = int(sys.argv[1])
from symbolicregression_jl_tpu_torch.parallel.distributed import initialize, is_distributed
initialize(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=pid)
assert is_distributed(), "expected a 2-process world"
import numpy as np
from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch.parallel import distributed as dist
rng = np.random.default_rng(0)
X = rng.normal(size=(2, 100)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
            population_size=16, ncycles_per_iteration=60, maxsize=14, save_to_file=False,
            seed=0, scheduler="device", device="cpu")

def frontier(res, options):
    return ";".join(f"{{m.get_complexity(options)}}:{{m.loss:.6g}}" for m in sorted(
        res.hall_of_fame.pareto_frontier(), key=lambda m: m.get_complexity(options)))
"""

# the JAX package's 2-process worker (tests/test_multihost.py), on the port
_WORKER = _PRELUDE + """
options = Options(**base)
res = equation_search(X, y, options=options, niterations=4, verbosity=0)
best = min(m.loss for m in res.pareto_frontier)
assert len(res.populations) == 2, len(res.populations)
assert tuple(res.engine_stats["islands"]) == ((0, 2) if pid == 0 else (2, 4))
print(f"RESULT p{{pid}} best={{best:.6g}} evals={{res.num_evals:.0f}} "
      f"frontier=[{{frontier(res, options)}}]", flush=True)
"""

_UNEVEN_WORKER = _PRELUDE + """
options = Options(binary_operators=["+"], populations=5, population_size=8,
                  ncycles_per_iteration=2, save_to_file=False, scheduler="device", device="cpu")
try:
    equation_search(X, X[0], options=options, niterations=1, verbosity=0)
except ValueError as e:
    assert "divisible" in str(e), e
    print(f"RAISED p{{pid}}", flush=True)
else:
    print(f"NORAISE p{{pid}}", flush=True)
"""

_STALE_POOL_WORKER = _PRELUDE + """
options = Options(**dict(base, fraction_replaced=0.2, fraction_replaced_hof=0.2,
                         async_readback=True))
res = equation_search(X, y, options=options, niterations=5, verbosity=0)
best = min(m.loss for m in res.pareto_frontier)
print(f"RESULT p{{pid}} best={{best:.6g}} evals={{res.num_evals:.0f}} "
      f"frontier=[{{frontier(res, options)}}]", flush=True)
"""

_SNAPSHOT_WORKER = _PRELUDE + """
from symbolicregression_jl_tpu_torch import load_checkpoint
ckdir = sys.argv[2]
base_path = os.path.join(ckdir, "ck.pkl")
options = Options(**dict(base, ncycles_per_iteration=20, checkpoint_file=base_path,
                         checkpoint_every=1))
res = equation_search(X, y, options=options, niterations=2, verbosity=0)
ck = load_checkpoint(f"{{base_path}}.p{{pid}}")
assert ck.iteration == 2 and len(ck.populations) == 2, (ck.iteration, len(ck.populations))
assert not os.path.exists(base_path)
again = equation_search(X, y, options=options, niterations=3, verbosity=0,
                        resume_from=base_path)
best = min(m.loss for m in again.pareto_frontier)
assert again.engine_stats["iterations"] == 1, again.engine_stats["iterations"]
print(f"RESUMED p{{pid}} from={{ck.iteration}} best={{best:.6g}} "
      f"frontier=[{{frontier(again, options)}}]", flush=True)
"""

_DEGRADED_WORKER = _PRELUDE.replace(
    "pid = int(sys.argv[1])", 'pid = int(sys.argv[1])\nos.environ["SR_KV_TIMEOUT_MS"] = "4000"'
) + """
options = Options(**dict(base, on_peer_loss={policy!r},
                         fault_spec=("peer_death@2" if pid == 1 else None)))
res = equation_search(X, y, options=options, niterations=4, verbosity=0)
best = min(m.loss for m in res.pareto_frontier)
print(f"RESULT p{{pid}} best={{best:.6g}} dead={{sorted(dist.dead_peers())}}", flush=True)
"""

_COMPOUND_WORKER = _PRELUDE.replace(
    "pid = int(sys.argv[1])", 'pid = int(sys.argv[1])\nos.environ["SR_KV_TIMEOUT_MS"] = "4000"'
) + """
from symbolicregression_jl_tpu_torch import load_checkpoint
from symbolicregression_jl_tpu_torch.utils import faults
ckdir = sys.argv[2]
options = Options(**dict(base, on_peer_loss="continue",
                         checkpoint_file=os.path.join(ckdir, "ck.pkl"), checkpoint_every=1,
                         fault_spec=("peer_death@2" if pid == 1 else {survivor_spec!r})))
try:
    res = equation_search(X, y, options=options, niterations=4, verbosity=0)
except faults.CheckpointWriteCrash:
    ck = load_checkpoint(os.path.join(ckdir, "ck.pkl.p0"))
    assert ck.iteration >= 1, ck.iteration
    print(f"CKPT_OK p{{pid}} it={{ck.iteration}}", flush=True)
    os._exit(0)
best = min(m.loss for m in res.pareto_frontier)
finite = all(np.isfinite(m.loss) for m in res.hall_of_fame.pareto_frontier())
print(f"RESULT p{{pid}} best={{best:.6g}} finite={{finite}} dead={{sorted(dist.dead_peers())}}",
      flush=True)
"""


def _run_pair(tmp_path, template, timeout=300, extra_args=(), **fmt):
    """Both ranks of a port world of 2 on the CPU; each child is killed at
    ``timeout``."""
    script = tmp_path / "worker.py"
    script.write_text(template.format(repo=REPO, port=_jax_multihost._free_port(), **fmt))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SR_ELASTIC", "SR_COORD", "SR_FAULT", "SR_KV_"))}
    procs = [subprocess.Popen([sys.executable, str(script), str(i), *map(str, extra_args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def _results(outs, prefix="RESULT"):
    found = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith(f"{prefix} p"):
                found[line.split()[1]] = line
    return found


def _field(line, name):
    return line.split(f"{name}=")[1].split()[0]


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """The JAX package's own 2-process run of the same script, once."""
    tmp = tmp_path_factory.mktemp("jax_pair")
    procs, outs = _jax_multihost._run_pair(tmp, _jax_multihost._WORKER,
                                           _jax_multihost._free_port(), timeout=600)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"JAX process {i} failed:\n{out}"
    res = _results(outs)
    assert set(res) == {"p0", "p1"}, res
    return res


def test_two_process_search_stays_lockstep_and_matches_jax(tmp_path, jax_pair):
    procs, outs = _run_pair(tmp_path, _WORKER)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    res = _results(outs)
    assert set(res) == {"p0", "p1"}, res
    # identical halls of fame: every process merged the same global frontier
    assert _field(res["p0"], "frontier") == _field(res["p1"], "frontier")
    best = float(_field(res["p0"], "best"))
    jax_best = min(float(_field(line, "best")) for line in jax_pair.values())
    # JAX's bar, and the band: the port within 1.0 of JAX's 2-process best
    # (searches of this budget either find the cos term, ~0.1-0.3, or
    # stall near 1.1-1.4; per-seed trajectories differ between packages)
    assert best < 1.5, res["p0"]
    assert best <= jax_best + 1.0, (best, jax_best)
    # evals counted from BOTH processes (the world's, not the local ones)
    assert float(_field(res["p0"], "evals")) > 2000
    assert _field(res["p0"], "evals") == _field(res["p1"], "evals")


def test_uneven_island_split_raises_on_every_process(tmp_path):
    procs, outs = _run_pair(tmp_path, _UNEVEN_WORKER, timeout=120)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} crashed:\n{out}"
        assert f"RAISED p{i}" in out, out


def test_stale_pool_migration_stays_lockstep(tmp_path):
    procs, outs = _run_pair(tmp_path, _STALE_POOL_WORKER)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    res = _results(outs)
    assert set(res) == {"p0", "p1"}, res
    assert _field(res["p0"], "frontier") == _field(res["p1"], "frontier")
    assert float(_field(res["p0"], "best")) < 1.5


def test_per_process_snapshots_and_resume(tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    procs, outs = _run_pair(tmp_path, _SNAPSHOT_WORKER, extra_args=(ckdir,))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    res = _results(outs, "RESUMED")
    assert set(res) == {"p0", "p1"}, res
    assert _field(res["p0"], "frontier") == _field(res["p1"], "frontier")
    for pid in (0, 1):
        assert any(f.startswith(f"ck.pkl.p{pid}.") for f in os.listdir(ckdir))


@pytest.mark.slow
def test_peer_death_continue_completes_on_survivor(tmp_path):
    procs, outs = _run_pair(tmp_path, _DEGRADED_WORKER, policy="continue")
    assert procs[1].returncode == 43, outs[1]
    assert procs[0].returncode == 0, outs[0]
    line = _results(outs)["p0"]
    assert "dead=[1]" in line and float(_field(line, "best")) < 1.5


@pytest.mark.slow
def test_peer_death_raise_names_the_missing_process(tmp_path):
    procs, outs = _run_pair(tmp_path, _DEGRADED_WORKER, policy="raise")
    assert procs[1].returncode == 43, outs[1]
    assert procs[0].returncode != 0
    assert "PeerLossError" in outs[0] and "process(es) 1" in outs[0], outs[0]


@pytest.mark.slow
def test_compound_ckpt_crash_while_degraded(tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    procs, outs = _run_pair(tmp_path, _COMPOUND_WORKER, extra_args=(ckdir,),
                            survivor_spec="ckpt_crash@3")
    assert procs[1].returncode == 43, outs[1]
    assert procs[0].returncode == 0, outs[0]
    assert "CKPT_OK p0" in outs[0], outs[0]


@pytest.mark.slow
def test_compound_nan_flood_on_survivor_after_peer_death(tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    procs, outs = _run_pair(tmp_path, _COMPOUND_WORKER, extra_args=(ckdir,),
                            survivor_spec="nan_flood@3:frac=0.75")
    assert procs[1].returncode == 43, outs[1]
    assert procs[0].returncode == 0, outs[0]
    line = _results(outs)["p0"]
    assert "finite=True" in line and "dead=[1]" in line, line
