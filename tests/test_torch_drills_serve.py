"""The port's fleet and serve-durability drills on the CPU
(``symbolicregression_jl_tpu_torch/scripts/fleet_smoke.py``, ``fault_smoke.py``).

The cancel mid-fleet of ``fleet_smoke`` at a reduced depth (2 iterations x
5 cycles): the fleet is held at an iteration boundary, one lane is
cancelled there, and the two survivors equal their solo runs bit for bit. The in-process half of
``fault_smoke``'s serve cycle (``job_exception`` retried to DONE, then
escalated to QUARANTINED) against the JAX package's ``SearchServer`` given
the same spec and fault strings on the same lockstep job: the same terminal
states, attempts and ``stats()`` counters.
"""

import numpy as np
import pytest

from symbolicregression_jl_tpu_torch.scripts import fault_smoke, fleet_smoke

# the stats() counters both servers keep, compared after each escalation
COUNTERS = ("jobs", "queued", "running", "retries", "quarantined", "shed", "stalls",
            "worker_restarts", "journal_shed", "oom_downshifts", "warm_buckets")


def test_cancel_mid_fleet_on_cpu():
    """Three lanes of 2 iterations x 5 cycles: lane 1 cancelled while the
    fleet is held at its first iteration boundary ends CANCELLED after 1
    iteration; lanes 0 and 2 end DONE, each equal to its solo run."""
    from symbolicregression_jl_tpu_torch.serve import CANCELLED, DONE

    jobs = fleet_smoke.cancel_mid_fleet("cpu", iterations=2, lanes=3, cycles=5)
    assert [j.state for j in jobs] == [DONE, CANCELLED, DONE]
    assert jobs[1].iterations_done == 1
    assert [j.iterations_done for j in (jobs[0], jobs[2])] == [2, 2]
    for i in (0, 2):
        solo = fleet_smoke._solo("cpu", fleet_smoke._problem(seed=i), i, 2, 5)
        assert fleet_smoke._sig(jobs[i].result) == fleet_smoke._sig(solo)
        assert jobs[i].result.num_evals == solo.num_evals


def _jax_escalation(tmp_path):
    """JAX's in-process half of ``smoke_serve_durability`` on its own
    ``SearchServer``: the same specs, fault strings and server settings."""
    from symbolicregression_jl_tpu import Options
    from symbolicregression_jl_tpu.serve import JobSpec, SearchServer
    from symbolicregression_jl_tpu.utils import faults

    X, y = fault_smoke._dataset()
    opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                   population_size=12, ncycles_per_iteration=8, maxsize=12, seed=0,
                   scheduler="lockstep", save_to_file=False)
    out = []
    try:
        for spec, kw in (("job_exception@0", {}),
                         ("job_exception@0;job_exception@1", {"job_retries": 1})):
            faults.install(spec)
            with SearchServer(max_concurrency=1, spool_dir=str(tmp_path / f"sp{len(out)}"),
                              retry_backoff_s=0.02, **kw) as srv:
                job = srv.wait(srv.submit(JobSpec(X, y, options=opts, niterations=2)),
                               timeout=600)
                out.append((job, srv.stats()))
    finally:
        faults.install(None)
    return out


@pytest.fixture
def no_fault_env(monkeypatch):
    monkeypatch.delenv("SR_FAULT_SPEC", raising=False)
    monkeypatch.delenv("SR_JOB_RETRIES", raising=False)


def test_serve_retry_escalation_matches_jax(tmp_path, no_fault_env):
    """``job_exception@0``: DONE at the second attempt; ``job_exception@0;
    job_exception@1`` under ``job_retries=1``: QUARANTINED at the second
    attempt with a traceback. States, attempts, errors and the counters of
    ``stats()`` equal the JAX server's; the port's injector is cleared
    after the drill."""
    from symbolicregression_jl_tpu_torch.utils import faults

    port = fault_smoke.serve_retry_escalation("cpu", str(tmp_path / "port"))
    jax = _jax_escalation(tmp_path / "jax")
    assert [j.state for j, _ in port] == [j.state for j, _ in jax] == ["done", "quarantined"]
    assert [j.attempts for j, _ in port] == [j.attempts for j, _ in jax] == [2, 2]
    assert port[1][0].traceback and jax[1][0].traceback
    assert [j.iterations_done for j, _ in port] == [j.iterations_done for j, _ in jax]
    for (pj, ps), (jj, js) in zip(port, jax):
        assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
        assert (pj.error is None) == (jj.error is None)
    assert port[0][1]["retries"] == 1 and port[1][1]["quarantined"] == 1
    assert not faults.active().armed("job_exception")
    assert np.isfinite(min(m.loss for m in port[0][0].result.pareto_frontier))
