#!/usr/bin/env python
"""Fault-injection CI smoke of the port (tiny config, on the card unless
``--device cpu``).

Six end-to-end cycles through the fault-tolerant runtime, minutes not hours:

1. **Checkpoint/resume**: a serial search is preempted (injected
   ``peer_death``) at iteration 2 of 4 with a snapshot after every
   iteration; ``resume_from`` must reproduce the uninterrupted run's hall
   of fame bit-exactly.
2. **Degraded exchange**: two processes joined by the port's
   ``parallel.distributed.initialize`` (a TCPStore hosted by rank 0 and a
   gloo group) run the device engine on one device; an injected
   ``exchange_timeout`` at the same allgather on both sides partitions
   them. Under ``on_peer_loss="continue"`` each side must record the other
   dead and COMPLETE its search solo instead of raising.
3. **Elastic rejoin**: a 2-process search over the FileCoordStore elastic
   runtime (``SR_COORD_DIR``, no process group); one worker is killed
   mid-run by an injected ``peer_death``, restarted with
   ``SR_ELASTIC_JOIN=1``, and must rejoin at a later membership epoch,
   adopt the leader's checkpoint shard, and finish, with the survivor's
   final frontier matching a no-fault elastic run within tolerance.
4. **Serve durability**: a journaled ``SearchServer`` subprocess loses a
   worker thread to an injected ``worker_crash`` (supervisor restarts it),
   then is SIGKILLed mid-batch with two jobs done and one mid-run with
   spool checkpoints. A recovery server on the same journal dir must
   surface every job (zero lost, zero duplicated), resume the running job
   from its checkpoint, and land a frontier bit-identical to an
   uninterrupted run. Also exercises in-process: transient ``job_exception``
   retried to DONE and a persistent one escalated to QUARANTINED.
5. **Network front door**: a ``NetServer`` subprocess on a fixed port with
   a journaled ``SearchServer``; an ``SRClient`` submits 2 short + 1 long
   job over the wire. A client is killed mid-stream (abrupt socket close;
   the server must shrug); the server is SIGKILLed mid-run and
   restarted on the SAME port + journal with ``torn_frame``/``net_drop``
   faults armed. The surviving client must reconnect across the restart
   (boot change) and both injected connection cuts, and the resumed
   stream must be EXACTLY the server's stored frame list: zero lost,
   zero duplicated jobs, exact frame replay by index.
6. **Pod federation**: two ``PodNode`` subprocesses over a shared
   FileCoordStore serve a mixed queued/running workload; one host is
   SIGKILLed mid-batch with an exact lockstep snapshot on disk. The
   survivor must claim the dead host's journal generation, adopt every
   job (zero lost, zero duplicated: the write-once done ledger is the
   proof), and resume the running lockstep job BIT-IDENTICALLY to an
   uninterrupted run. Then a third host takes jobs and gets SIGTERM:
   graceful drain must checkpoint its lanes, publish a retirement
   marker, exit 0, and hand the jobs off to the survivor.

Exits nonzero on the first violated invariant (1), or 2 when the card is
asked for and there is none. Usage: python
symbolicregression_jl_tpu_torch/scripts/fault_smoke.py
[checkpoint|exchange|elastic|serve|net|pod|all ...] [--device cpu] (no
cycle = all; or python -m symbolicregression_jl_tpu_torch.scripts.fault_smoke).
Every process of a cycle runs its searches on ``--device``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(**kw) -> dict:
    """The environment of a drill's child: this process's, without the
    fault, elastic, coordination, KV and pod settings a caller may have
    set, plus ``kw``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SR_FAULT_SPEC", "SR_ELASTIC", "SR_COORD", "SR_KV_", "SR_POD_"))}
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _dataset(n=64):
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y


def _lockstep_opts(device, seed=0, **kw):
    from symbolicregression_jl_tpu_torch import Options

    base = dict(
        binary_operators=["+", "-", "*"], unary_operators=["cos"],
        populations=2, population_size=12, ncycles_per_iteration=8,
        maxsize=12, seed=seed, scheduler="lockstep", save_to_file=False,
        progress=False, device=str(device),
    )
    base.update(kw)
    return Options(**base)


def _reset_faults() -> None:
    """Clear the process-wide injector, installed or read from the env, so
    that a later drill inherits no fault."""
    from symbolicregression_jl_tpu_torch.utils import faults

    faults.install(None)
    faults.reset_env_injector()


def _frontier(res, options):
    return ";".join(
        f"{m.get_complexity(options)}:{m.loss:.17g}"
        for m in sorted(
            res.hall_of_fame.pareto_frontier(),
            key=lambda m: m.get_complexity(options),
        )
    )


def smoke_checkpoint_resume(device: str = "cuda", niterations: int = 4) -> None:
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.utils import faults

    X, y = _dataset()
    try:
        with tempfile.TemporaryDirectory() as d:
            ck = os.path.join(d, "ck.pkl")

            def opts(**kw):
                return _lockstep_opts(device, checkpoint_file=ck, **kw)

            full = equation_search(X, y, options=opts(), niterations=niterations, verbosity=0)
            try:
                equation_search(
                    X, y,
                    options=opts(checkpoint_every=1, fault_spec="peer_death@2:mode=raise"),
                    niterations=niterations, verbosity=0,
                )
                raise SystemExit("FAIL: injected peer_death did not fire")
            except faults.FaultInjected:
                pass
            resumed = equation_search(X, y, options=opts(), niterations=niterations,
                                      verbosity=0, resume_from=ck)
            o = opts()
            if _frontier(resumed, o) != _frontier(full, o):
                raise SystemExit(
                    "FAIL: resumed hall of fame differs from the uninterrupted "
                    f"run\n  full:    {_frontier(full, o)}"
                    f"\n  resumed: {_frontier(resumed, o)}"
                )
    finally:
        _reset_faults()
    print("OK checkpoint/resume: bit-exact after injected preemption", flush=True)


_EXCHANGE_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
pid = int(sys.argv[1])
from symbolicregression_jl_tpu_torch.parallel.distributed import initialize
initialize(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=pid)

import numpy as np
from symbolicregression_jl_tpu_torch import Options, equation_search

rng = np.random.default_rng(0)
X = rng.normal(size=(2, 64)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
# the SAME injected exchange_timeout on both sides partitions the pair at
# one allgather: each side drops the other immediately (no deadline wait)
# and must finish its remaining iterations solo
options = Options(
    binary_operators=["+", "-", "*"],
    unary_operators=["cos"],
    populations=2, population_size=12,
    ncycles_per_iteration=8, maxsize=12, seed=0,
    scheduler="device", save_to_file=False, progress=False, device={device!r},
    on_peer_loss="continue",
    fault_spec="exchange_timeout@1",
)
res = equation_search(X, y, options=options, niterations={niterations}, verbosity=0)
from symbolicregression_jl_tpu_torch.parallel import distributed as dist
best = min(m.loss for m in res.pareto_frontier)
print(f"RESULT p{{pid}} best={{best:.6g}} dead={{sorted(dist.dead_peers())}}",
      flush=True)
"""


def smoke_degraded_exchange(device: str = "cuda", niterations: int = 3) -> None:
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "worker.py")
        with open(script, "w") as f:
            f.write(_EXCHANGE_WORKER.format(repo=REPO, port=port, device=str(device),
                                            niterations=niterations))
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(i)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=_child_env(), cwd=REPO,
            )
            for i in range(2)
        ]
        try:
            outs = [p.communicate(timeout=780)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(
                f"FAIL: process {i} did not survive the injected "
                f"exchange timeout (rc={p.returncode}):\n{out}"
            )
        other = 1 - i
        line = next(
            (l for l in out.splitlines() if l.startswith(f"RESULT p{i}")), ""
        )
        if f"dead=[{other}]" not in line:
            raise SystemExit(
                f"FAIL: process {i} never recorded peer {other} dead:\n{out}"
            )
    print("OK degraded exchange: both partitions completed solo", flush=True)


_ELASTIC_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
pid = int(os.environ["SR_ELASTIC_ID"])

import numpy as np
from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch.parallel import distributed as dist

rng = np.random.default_rng(0)
X = rng.normal(size=(2, 96)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
options = Options(
    binary_operators=["+", "-", "*"],
    unary_operators=["cos"],
    populations=4, population_size=16,
    ncycles_per_iteration=8, maxsize=12, seed=0,
    scheduler="device", save_to_file=False, progress=False, device={device!r},
    on_peer_loss="rejoin",
    heartbeat_every_seconds=1.0,
)
res = equation_search(X, y, options=options, niterations={niterations}, verbosity=0)
best = min(m.loss for m in res.pareto_frontier)
print(f"RESULT p{{pid}} best={{best:.6g}} dead={{sorted(dist.dead_peers())}}",
      flush=True)
"""


def _launch_elastic(script, coord, pid, fault_spec=None, join=False):
    # the KV deadline: comfortably above the paced 0.6 s/post cadence and
    # initial-boot skew, and long enough for a joiner announcing right after
    # the LEAVE to be admitted at the survivor's next stop sync
    kw = dict(SR_COORD_DIR=coord, SR_ELASTIC_WORLD=2, SR_ELASTIC_ID=pid,
              SR_KV_TIMEOUT_MS=15000, SR_KV_BACKOFF_MS=50)
    if fault_spec:
        kw["SR_FAULT_SPEC"] = fault_spec
    if join:
        kw["SR_ELASTIC_JOIN"] = 1
    return subprocess.Popen(
        [sys.executable, script],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_child_env(**kw), cwd=REPO,
    )


def _elastic_epoch_records(coord):
    import pickle
    import urllib.parse

    out = []
    for fn in os.listdir(coord):
        key = urllib.parse.unquote(fn)
        if key.startswith("srep/"):
            with open(os.path.join(coord, fn), "rb") as f:
                out.append(pickle.load(f))
    return sorted(out, key=lambda r: r["epoch"])


def _result_best(out, pid):
    line = next(
        (l for l in out.splitlines() if l.startswith(f"RESULT p{pid}")), None
    )
    if line is None:
        raise SystemExit(f"FAIL: no RESULT line from process {pid}:\n{out}")
    return float(line.split("best=")[1].split()[0]), line


def smoke_elastic_rejoin(device: str = "cuda", niterations: int = 60) -> None:
    # pace EVERY survivor post (~2 posts/iteration x 60 iterations) so the
    # restarted worker's boot lands well before the run ends, leaving a long
    # joint phase for the frontier to re-converge after rejoin; collectives
    # throttle every other rank to the same cadence, so one paced rank
    # paces the run
    pacing = ";".join(f"slow_peer@{i}:delay_ms=600" for i in range(400))
    procs = []
    try:
        with tempfile.TemporaryDirectory() as d:
            script = os.path.join(d, "worker.py")
            with open(script, "w") as f:
                f.write(_ELASTIC_WORKER.format(repo=REPO, device=str(device),
                                               niterations=niterations))

            # --- no-fault reference run (its own coordination dir) ----------
            coord_ref = os.path.join(d, "coord_ref")
            ref = [
                _launch_elastic(script, coord_ref, 0),
                _launch_elastic(script, coord_ref, 1),
            ]
            procs += ref
            ref_outs = [p.communicate(timeout=600)[0] for p in ref]
            for i, (p, out) in enumerate(zip(ref, ref_outs)):
                if p.returncode != 0:
                    raise SystemExit(
                        f"FAIL: no-fault elastic worker {i} rc={p.returncode}:\n{out}"
                    )
            ref_best, _ = _result_best(ref_outs[0], 0)

            # --- faulted run: kill worker 1 at iteration 3, restart it ------
            coord = os.path.join(d, "coord")
            survivor = _launch_elastic(script, coord, 0, fault_spec=pacing)
            victim = _launch_elastic(script, coord, 1, fault_spec="peer_death@3")
            procs += [survivor, victim]
            victim_out = victim.communicate(timeout=600)[0]
            if victim.returncode != 43:
                raise SystemExit(
                    f"FAIL: victim rc={victim.returncode} (expected injected "
                    f"peer_death exit 43):\n{victim_out}"
                )
            # the survivor formalizes the LEAVE (epoch N) before the restart
            # announces, so the rejoin lands at a strictly later epoch; a
            # port worker boots in seconds, well inside the 15 s KV deadline
            # the leave waits out, so the restart waits for the record
            deadline = time.time() + 300
            while not any(1 in r.get("left", []) for r in _elastic_epoch_records(coord)):
                if time.time() > deadline or survivor.poll() is not None:
                    raise SystemExit("FAIL: the survivor never recorded rank 1's leave")
                time.sleep(0.05)
            rejoiner = _launch_elastic(script, coord, 1, join=True)
            procs.append(rejoiner)
            rejoin_out = rejoiner.communicate(timeout=600)[0]
            surv_out = survivor.communicate(timeout=600)[0]
            if rejoiner.returncode != 0:
                raise SystemExit(
                    f"FAIL: restarted worker rc={rejoiner.returncode}:\n{rejoin_out}"
                )
            if survivor.returncode != 0:
                raise SystemExit(
                    f"FAIL: survivor rc={survivor.returncode}:\n{surv_out}"
                )

            records = _elastic_epoch_records(coord)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    kills = [r for r in records if 1 in r.get("left", [])]
    joins = [r for r in records if 1 in r.get("joined", [])]
    if not kills:
        raise SystemExit(f"FAIL: no epoch record names rank 1 dead: {records}")
    if not joins:
        raise SystemExit(
            f"FAIL: rank 1 never rejoined (epoch records: {records})\n"
            f"survivor:\n{surv_out}\nrejoiner:\n{rejoin_out}"
        )
    if joins[0]["epoch"] <= kills[0]["epoch"]:
        raise SystemExit(
            f"FAIL: rejoin epoch {joins[0]['epoch']} not after the kill "
            f"epoch {kills[0]['epoch']}"
        )
    surv_best, surv_line = _result_best(surv_out, 0)
    if "dead=[]" not in surv_line:
        raise SystemExit(
            f"FAIL: survivor still records rank 1 dead after the rejoin: {surv_line}"
        )
    # tolerance: the faulted run loses a few of rank 1's iterations but
    # must still land a comparable frontier on this easy target
    if not (surv_best <= max(ref_best * 100.0, 0.05)):
        raise SystemExit(
            f"FAIL: faulted-run frontier degraded: best={surv_best:.6g} "
            f"vs no-fault best={ref_best:.6g}"
        )
    print(
        f"OK elastic rejoin: kill epoch {kills[0]['epoch']} -> rejoin epoch "
        f"{joins[0]['epoch']}, best {surv_best:.3g} (no-fault {ref_best:.3g})", flush=True
    )


_SERVE_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})

import numpy as np
from symbolicregression_jl_tpu_torch import Options
from symbolicregression_jl_tpu_torch.serve import JobSpec, SearchServer
from symbolicregression_jl_tpu_torch.utils.checkpoint import latest_checkpoint

jdir = sys.argv[1]
rng = np.random.default_rng(0)
X = rng.normal(size=(2, 64)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
opts = Options(
    binary_operators=["+", "-", "*"], unary_operators=["cos"],
    populations=2, population_size=12, ncycles_per_iteration=8,
    maxsize=12, seed=0, scheduler="lockstep", save_to_file=False,
    progress=False, device={device!r},
)
# SR_FAULT_SPEC=worker_crash@0 (set by the parent) kills the first worker
# thread at its first acquire; the supervisor must restart it for ANY job
# to finish
srv = SearchServer(max_concurrency=1, journal_dir=jdir,
                   ckpt_every_s=0.05).start()
for _ in range(2):
    srv.submit(JobSpec(X, y, options=opts, niterations={short}))
long_id = srv.submit(JobSpec(X, y, options=opts, niterations={long}))
base = os.path.join(srv.spool_dir, long_id + ".engine")
deadline = time.time() + 300
while time.time() < deadline:
    st = srv.stats()
    if (st["jobs"].get("done", 0) >= 2
            and latest_checkpoint(base) is not None):
        print(f"MID {{long_id}} restarts={{st['worker_restarts']}}", flush=True)
        break
    time.sleep(0.05)
time.sleep(600)  # hold mid-run until the parent SIGKILLs this process
"""


def serve_kill_recover(device: str, d: str, long_iterations: int = 40,
                       short_iterations: int = 2) -> int:
    """The kill drill of the serve cycle in ``d``: a journaled server child
    under ``worker_crash@0``, SIGKILLed with two short jobs done and the long
    one mid-run with a spool snapshot, then recovered in this process on
    the same journal. Returns the iteration the long job resumed at."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.serve import DONE, SearchServer

    X, y = _dataset()
    reference = equation_search(X, y, options=_lockstep_opts(device),
                                niterations=long_iterations, verbosity=0)
    script = os.path.join(d, "serve_child.py")
    with open(script, "w") as f:
        f.write(_SERVE_CHILD.format(repo=REPO, device=str(device), short=short_iterations,
                                    long=long_iterations))
    jdir = os.path.join(d, "journal")
    proc = subprocess.Popen(
        [sys.executable, script, jdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_child_env(SR_FAULT_SPEC="worker_crash@0"), cwd=REPO,
    )
    long_id, restarts, lines = None, 0, []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("MID "):
                long_id = line.split()[1]
                restarts = int(line.split("restarts=")[1])
                break
    finally:
        proc.kill()
        proc.wait(timeout=60)
    if long_id is None:
        raise SystemExit("FAIL: serve child never reached mid-run:\n" + "".join(lines))
    if restarts < 1:
        raise SystemExit(f"FAIL: the supervisor restarted no worker after worker_crash@0 "
                         f"(worker_restarts={restarts})")

    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        rec = srv.stats()["journal"]["recovered"]
        if rec["terminal"] != 2 or rec["running"] != 1 or rec["resumed"] < 1:
            raise SystemExit(
                f"FAIL: recovery saw {rec}, expected 2 terminal + 1 "
                "running job resumed from its spool checkpoint"
            )
        with srv._lock:
            ids = sorted(srv._jobs)
        if len(ids) != 3 or len(set(ids)) != 3:
            raise SystemExit(f"FAIL: jobs lost or duplicated: {ids}")
        for jid in ids:
            job = srv.wait(jid, timeout=600)
            if job.state != DONE:
                raise SystemExit(f"FAIL: recovered job not DONE: {job.summary()}")
        long_job = srv.job(long_id)
        if not long_job.resumed_from_iteration:
            raise SystemExit(
                "FAIL: killed running job restarted from scratch instead "
                f"of resuming: {long_job.summary()}"
            )
        o = _lockstep_opts(device)
        if _frontier(long_job.result, o) != _frontier(reference, o):
            raise SystemExit(
                "FAIL: recovered job's frontier differs from the "
                f"uninterrupted run\n  full:      {_frontier(reference, o)}"
                f"\n  recovered: {_frontier(long_job.result, o)}"
            )
    return long_job.resumed_from_iteration


def serve_retry_escalation(device: str, d: str) -> list:
    """The in-process half of the serve cycle in ``d``: ``job_exception@0``
    retried to DONE (2 attempts), then ``job_exception@0;job_exception@1``
    under ``job_retries=1`` escalated to QUARANTINED with a traceback.
    Returns [(job, stats())] of the two servers."""
    from symbolicregression_jl_tpu_torch.serve import DONE, QUARANTINED, JobSpec, SearchServer
    from symbolicregression_jl_tpu_torch.utils import faults

    X, y = _dataset()
    out = []
    try:
        faults.install("job_exception@0")
        with SearchServer(max_concurrency=1, spool_dir=os.path.join(d, "sp1"),
                          retry_backoff_s=0.02) as srv:
            job = srv.wait(srv.submit(JobSpec(X, y, options=_lockstep_opts(device),
                                              niterations=2)), timeout=600)
            out.append((job, srv.stats()))
        if job.state != DONE or job.attempts != 2:
            raise SystemExit(
                f"FAIL: transient job_exception not retried to DONE: {job.summary()}"
            )
        faults.install("job_exception@0;job_exception@1")
        with SearchServer(max_concurrency=1, spool_dir=os.path.join(d, "sp2"),
                          job_retries=1, retry_backoff_s=0.02) as srv:
            job = srv.wait(srv.submit(JobSpec(X, y, options=_lockstep_opts(device),
                                              niterations=2)), timeout=600)
            out.append((job, srv.stats()))
        if job.state != QUARANTINED or not job.traceback:
            raise SystemExit(
                "FAIL: persistent job_exception not quarantined with a "
                f"traceback: {job.summary()}"
            )
    finally:
        _reset_faults()
    return out


def smoke_serve_durability(device: str = "cuda", long_iterations: int = 40) -> None:
    with tempfile.TemporaryDirectory() as d:
        resumed_at = serve_kill_recover(device, d, long_iterations)
        serve_retry_escalation(device, d)
    print(
        "OK serve durability: SIGKILL'd server recovered 3/3 jobs "
        f"(running job resumed at iteration {resumed_at}, frontier "
        "bit-exact); retries escalate to quarantine", flush=True
    )


_NET_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})

from symbolicregression_jl_tpu_torch.serve import NetServer, SearchServer

jdir, port = sys.argv[1], int(sys.argv[2])
srv = SearchServer(max_concurrency=1, journal_dir=jdir,
                   ckpt_every_s=0.05).start()
net = NetServer(srv, port=port).start()
print("READY", flush=True)
time.sleep(3600)  # serve until the parent SIGKILLs this process
"""


def smoke_net_front_door(device: str = "cuda", long_iterations: int = 40) -> None:
    import glob
    import signal

    from symbolicregression_jl_tpu_torch.serve import JobSpec
    from symbolicregression_jl_tpu_torch.serve.net import ConnectionLost, SRClient

    X, y = _dataset()

    def opts():
        return _lockstep_opts(device)

    # the restarted server must reclaim the SAME port so the surviving
    # client's reconnect loop finds it without rediscovery
    port = _free_port()

    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "net_child.py")
        with open(script, "w") as f:
            f.write(_NET_CHILD.format(repo=REPO))
        jdir = os.path.join(d, "journal")

        def launch(fault_spec=None):
            env = _child_env(**({"SR_FAULT_SPEC": fault_spec} if fault_spec else {}))
            p = subprocess.Popen(
                [sys.executable, script, jdir, str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=REPO,
            )
            for line in p.stdout:
                if line.startswith("READY"):
                    return p
            p.wait(timeout=60)
            raise SystemExit("FAIL: net child never came up")

        child = launch()
        try:
            # shorts first so the single worker drains them before the long
            # job starts; the long job then runs alone with a wide kill window
            doomed = SRClient("127.0.0.1", port, auto_reconnect=False)
            shorts = [
                doomed.submit(JobSpec(X, y, options=opts(), niterations=2))
                for _ in range(2)
            ]
            long_id = doomed.submit(JobSpec(X, y, options=opts(), niterations=long_iterations))
            cli = SRClient("127.0.0.1", port, reconnect_deadline_s=120.0)
            st = cli.subscribe(long_id)

            # --- client-kill leg: abrupt close mid-stream -------------------
            it = doomed.iter_frames(long_id, timeout=600)
            got = [next(it), next(it)]
            doomed.close()  # no unsubscribe, no goodbye: just gone
            cli.ping()  # the server must not care
            if got != cli.frames(long_id, 0)[: len(got)]:
                raise SystemExit(
                    "FAIL: killed client's frames are not a prefix of the "
                    "server's stored stream"
                )

            # --- arm the kill: both shorts done, long mid-run + snapshot ----
            for jid in shorts:
                if cli.wait(jid, timeout=600)["state"] != "done":
                    raise SystemExit(f"FAIL: short job {jid} not DONE")
            spool = os.path.join(jdir, "spool", long_id + ".engine.*")
            deadline = time.time() + 300
            while time.time() < deadline:
                if (cli.status(long_id)["iterations_done"] >= 3
                        and glob.glob(spool)):
                    break
                time.sleep(0.05)
            else:
                raise SystemExit(
                    "FAIL: long job never reached mid-run with a spool checkpoint"
                )
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=60)

            # --- restart on the same port/journal, wire faults armed --------
            # torn_frame@1: the restarted server's 2nd pushed frame is cut
            # mid-frame; net_drop@3: a later push vanishes with the conn.
            # Both must be invisible to the client beyond reconnect counts.
            child = launch(fault_spec="torn_frame@1;net_drop@3")
            terminal = None
            deadline = time.time() + 600
            while time.time() < deadline:
                terminal = cli.terminal_summary(long_id)
                if terminal is not None:
                    break
                time.sleep(0.1)
            if terminal is None:
                raise SystemExit(
                    "FAIL: no terminal push for the recovered long job "
                    f"(reconnects={cli.reconnects}, boots={st.boots})"
                )
            if terminal["state"] != "done":
                raise SystemExit(f"FAIL: recovered long job: {terminal}")
            if not terminal.get("resumed_from_iteration"):
                raise SystemExit(
                    f"FAIL: recovered long job restarted from scratch: {terminal}"
                )

            # --- zero lost/duplicated jobs; exact replay by index -----------
            for jid in shorts:
                summary = None
                for _ in range(3):  # a fault may cut an in-flight request
                    try:
                        summary = cli.status(jid)
                        break
                    except (ConnectionLost, KeyError):
                        time.sleep(0.5)
                if summary is None or summary["state"] != "done":
                    raise SystemExit(
                        f"FAIL: short job {jid} lost across the restart: {summary}"
                    )
            stats = cli.stats()
            if stats["server"]["jobs"] != {"done": 3}:
                raise SystemExit(
                    "FAIL: recovered server job census is not 3x DONE: "
                    f"{stats['server']['jobs']}"
                )
            stored = cli.frames(long_id, 0)
            if st.boots != 1:
                raise SystemExit(f"FAIL: expected exactly one boot change, saw {st.boots}")
            if st.dup_dropped != 0:
                raise SystemExit(f"FAIL: {st.dup_dropped} duplicate frame(s) delivered")
            if st.next_index != len(stored):
                raise SystemExit(
                    f"FAIL: stream cursor {st.next_index} != stored frame "
                    f"count {len(stored)}"
                )
            if st.frames[-len(stored):] != stored:
                raise SystemExit(
                    "FAIL: resumed stream differs from the server's stored "
                    "frames (lost or reordered replay)"
                )
            if cli.reconnects < 3:
                raise SystemExit(
                    f"FAIL: expected >=3 reconnects (restart + torn_frame + "
                    f"net_drop), saw {cli.reconnects}"
                )
            if stats["net"]["net_faults"] != 2:
                raise SystemExit(
                    f"FAIL: armed wire faults did not both fire: {stats['net']}"
                )
            cli.close()
        finally:
            child.kill()
            child.wait(timeout=60)
    print(
        "OK network front door: server SIGKILL + torn frame + dropped conn "
        f"survived with {cli.reconnects} reconnects; 3/3 jobs terminal, "
        f"stream replayed exactly ({len(stored)} frames, 0 duplicates)", flush=True
    )


_POD_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
host, coord = sys.argv[1], sys.argv[2]
os.environ["SR_COORD_DIR"] = coord

from symbolicregression_jl_tpu_torch.parallel.membership import FileCoordStore
from symbolicregression_jl_tpu_torch.serve import PodNode

# one lane per host: the bit-exact migrated-frontier check needs the long
# lockstep job to run solo on both sides (concurrent engine runs in one
# process perturb each other's trajectory)
node = PodNode(host, store=FileCoordStore(coord), hb_seconds=0.1,
               suspect_seconds=1.5, max_concurrency=1, poll_seconds=0.02,
               ckpt_every_s=0.1)
node.install_sigterm_drain()
node.start()
print("READY " + host, flush=True)
time.sleep(3600)  # serve until the parent SIGKILLs or SIGTERMs us
"""


def smoke_pod_federation(device: str = "cuda", long_iterations: int = 40) -> None:
    import glob
    import signal

    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.parallel.membership import FileCoordStore
    from symbolicregression_jl_tpu_torch.serve import DONE, JobJournal, JobSpec, PodClient
    from symbolicregression_jl_tpu_torch.serve.queue import decode_spec
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    X, y = _dataset()

    def opts(seed=0):
        return _lockstep_opts(device, seed)

    def frame_frontier(frame, options):
        upd = load_frontier_bytes(frame)
        return ";".join(
            f"{m.get_complexity(options)}:{m.loss:.17g}"
            for m in sorted(upd.members, key=lambda m: m.get_complexity(options))
        )

    o = opts()
    reference = equation_search(X, y, options=opts(), niterations=long_iterations, verbosity=0)
    ref_front = _frontier(reference, o)

    procs = {}
    with tempfile.TemporaryDirectory() as d:
        coord = os.path.join(d, "coord")
        script = os.path.join(d, "pod_child.py")
        with open(script, "w") as f:
            f.write(_POD_CHILD.format(repo=REPO))

        def launch(host):
            p = subprocess.Popen(
                [sys.executable, script, host, coord],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=_child_env(), cwd=REPO,
            )
            procs[host] = p
            for line in p.stdout:
                if line.startswith("READY"):
                    return p
            raise SystemExit(f"FAIL: pod child {host} never came up")

        try:
            store = FileCoordStore(coord)
            client = PodClient(store=store, suspect_seconds=1.5)
            for h in ("h0", "h1"):
                launch(h)
            deadline = time.time() + 60
            while {"h0", "h1"} - set(client.live_hosts()):
                if time.time() > deadline:
                    raise SystemExit("FAIL: hosts never advertised")
                time.sleep(0.05)

            # --- kill drill: mixed queued + running workload on the victim --
            # the long lockstep job is pinned to h1 (the victim) FIRST so it
            # grabs the single worker slot and starts snapshotting (exact
            # frames every 0.1s); three shorts queue behind it so h1 dies
            # with a running AND queued jobs; two more route freely
            long_id = client.submit(JobSpec(X, y, options=opts(), niterations=long_iterations),
                                    host="h1")
            free = [
                client.submit(JobSpec(X, y, options=opts(seed=s), niterations=2))
                for s in (1, 2)
            ]
            pinned = [
                client.submit(JobSpec(X, y, options=opts(seed=10 + s), niterations=4),
                              host="h1")
                for s in range(3)
            ]
            all_ids = free + pinned + [long_id]

            # map the long pod job to the victim's LOCAL job id through its
            # journal (shared fs), then wait for one of ITS exact snapshots:
            # killing before the long job runs would degrade the drill to a
            # queued-job migration
            jdir = os.path.join(coord, "_pod", "h1", "gen-0001")
            spool = os.path.join(jdir, "spool")
            local_long = None
            deadline = time.time() + 300
            while time.time() < deadline:
                if local_long is None and os.path.isdir(jdir):
                    jr = JobJournal(jdir)
                    try:
                        for jid, st in jr.replay().items():
                            if st.get("spec") is None:
                                continue
                            if getattr(decode_spec(st["spec"]), "label", "") == long_id:
                                local_long = jid
                    finally:
                        jr.close()
                if local_long is not None and glob.glob(
                    os.path.join(spool, local_long + ".engine.*")
                ):
                    break
                time.sleep(0.05)
            else:
                raise SystemExit(
                    "FAIL: victim's long job never wrote an exact engine snapshot"
                )
            procs["h1"].send_signal(signal.SIGKILL)
            procs["h1"].wait(timeout=60)

            recs = client.wait_all(all_ids, timeout=600)
            ledger = client.results()
            if set(ledger) != set(all_ids):
                raise SystemExit(
                    f"FAIL: done ledger {sorted(ledger)} != submitted "
                    f"{sorted(all_ids)} (lost or phantom jobs)"
                )
            bad = {p: r["state"] for p, r in recs.items() if r["state"] != DONE}
            if bad:
                raise SystemExit(f"FAIL: non-DONE after migration: {bad}")
            lrec = recs[long_id]
            if lrec["host"] != "h0":
                raise SystemExit(
                    f"FAIL: long job finished on {lrec['host']}, not the survivor"
                )
            if not lrec["resumed_from_iteration"]:
                raise SystemExit(
                    "FAIL: migrated running job restarted from scratch instead "
                    f"of resuming: {lrec}"
                )
            front = frame_frontier(lrec["final_frame"], o)
            if front != ref_front:
                raise SystemExit(
                    "FAIL: migrated lockstep job's frontier differs from the "
                    f"uninterrupted run\n  full:     {ref_front}"
                    f"\n  migrated: {front}"
                )
            survivor_ad = client.hosts()["h0"]
            if survivor_ad["duplicate_results"] != 0:
                raise SystemExit(
                    f"FAIL: {survivor_ad['duplicate_results']} duplicate "
                    "result(s) published after migration"
                )
            resumed_at = lrec["resumed_from_iteration"]

            # --- drain drill: SIGTERM hands lanes off, exit 0, fast adoption
            launch("h2")
            deadline = time.time() + 60
            while "h2" not in client.live_hosts():
                if time.time() > deadline:
                    raise SystemExit("FAIL: h2 never advertised")
                time.sleep(0.05)
            drain_ids = [
                client.submit(JobSpec(X, y, options=opts(seed=20 + s), niterations=4),
                              host="h2")
                for s in range(2)
            ]
            # wait until h2 owns them (inbox consumed into its journal)
            deadline = time.time() + 120
            while True:
                ad = client.hosts().get("h2", {})
                owned = ad.get("queue_depth", 0) + ad.get("running", 0)
                settled = sum(1 for p in drain_ids if client.done(p) is not None)
                if owned + settled >= len(drain_ids):
                    break
                if time.time() > deadline:
                    raise SystemExit("FAIL: h2 never consumed its inbox")
                time.sleep(0.02)
            t_term = time.time()
            procs["h2"].send_signal(signal.SIGTERM)
            if procs["h2"].wait(timeout=120) != 0:
                raise SystemExit("FAIL: SIGTERM drain exited nonzero")
            claim_key = "srpod/pod0/claim/h2/gen-0001"
            retire_key = "srpod/pod0/retire/h2/gen-0001"
            if store.try_get(retire_key) is None:
                raise SystemExit("FAIL: drained host left no retirement marker")
            deadline = time.time() + 60
            while store.try_get(claim_key) is None:
                if time.time() > deadline:
                    raise SystemExit("FAIL: survivor never adopted the drained gen")
                time.sleep(0.01)
            handoff_s = time.time() - t_term
            recs = client.wait_all(drain_ids, timeout=600)
            bad = {p: r["state"] for p, r in recs.items() if r["state"] != DONE}
            if bad:
                raise SystemExit(f"FAIL: non-DONE after drain handoff: {bad}")
            if client.hosts()["h0"]["duplicate_results"] != 0:
                raise SystemExit("FAIL: duplicate result(s) after drain handoff")
            if set(client.results()) != set(all_ids + drain_ids):
                raise SystemExit("FAIL: done ledger drifted after drain")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
    print(
        f"OK pod federation: SIGKILL'd host's {len(pinned) + 1} jobs migrated "
        f"(running lockstep job resumed at iteration {resumed_at}, frontier "
        f"bit-exact), {len(all_ids)}/{len(all_ids)} terminal with zero "
        f"duplicates; SIGTERM drain handed off {len(drain_ids)} jobs in "
        f"{handoff_s:.2f}s", flush=True
    )


# drill registry: (name, fn, invariants the drill pins). "all" mode runs
# every drill, prints the summary table, and exits nonzero if ANY failed.
_DRILLS = (
    ("checkpoint", smoke_checkpoint_resume,
     "resume bit-exact after preemption"),
    ("exchange", smoke_degraded_exchange,
     "partitioned exchange completes solo"),
    ("elastic", smoke_elastic_rejoin,
     "killed worker rejoins at later epoch"),
    ("serve", smoke_serve_durability,
     "journal recovery: zero lost/dup, bit-exact resume"),
    ("net", smoke_net_front_door,
     "reconnect across restart, exact frame replay"),
    ("pod", smoke_pod_federation,
     "migration: zero lost/dup, bit-exact lane resume"),
)


def _run_all(which: set, device: str = "cuda") -> int:
    rows = []
    failed = False
    for name, fn, invariant in _DRILLS:
        if not (which & {"all", name}):
            continue
        if failed:  # first breach stops the run; the table still shows it
            rows.append((name, invariant, "skip", 0.0, ""))
            continue
        t0 = time.time()
        try:
            fn(device)
            verdict, detail = "pass", ""
        except SystemExit as e:
            failed = True
            verdict, detail = "FAIL", str(e.code if e.code is not None else e)
        except Exception as e:  # noqa: BLE001 -- a drill crash is a failure too
            failed = True
            verdict, detail = "FAIL", repr(e)
        rows.append((name, invariant, verdict, time.time() - t0, detail))
    w_name = max(len(r[0]) for r in rows)
    w_inv = max(len(r[1]) for r in rows)
    print("\n" + "=" * (w_name + w_inv + 18))
    for name, invariant, verdict, dt, detail in rows:
        print(f"{name:<{w_name}}  {invariant:<{w_inv}}  {verdict:<4} "
              f"{dt:6.1f}s")
        if detail:
            print(f"{'':<{w_name}}  {detail}")
    print("=" * (w_name + w_inv + 18))
    if failed:
        print("FAULT_SMOKE=fail", flush=True)
        return 1
    print("FAULT_SMOKE=pass", flush=True)
    return 0


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    ap = _drill.parser(__doc__)
    ap.add_argument("cycles", nargs="*", metavar="cycle",
                    help="checkpoint, exchange, elastic, serve, net, pod or all (default)")
    args = ap.parse_args(argv)
    which = set(args.cycles) or {"all"}
    unknown = which - ({"all"} | {name for name, _, _ in _DRILLS})
    if unknown:
        sys.exit(f"unknown cycle(s): {sorted(unknown)} "
                 "(choose from: " + " ".join(n for n, _, _ in _DRILLS) + ")")
    _drill.check_device("fault_smoke", args.device)
    if args.device == "cuda":
        # the children load the kernels from the package's build directory;
        # build them once here, so that no child pays the build in a drill
        from symbolicregression_jl_tpu_torch.ops import interp_cuda

        interp_cuda.build_all()
    return _run_all(which, args.device)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
