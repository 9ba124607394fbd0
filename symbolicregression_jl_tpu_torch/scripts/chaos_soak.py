#!/usr/bin/env python
"""Seeded chaos soak of the port: one integer seed -> a deterministic
multi-fault schedule over the full serving stack, audited against global
invariants.

Counterpart of the JAX package's ``scripts/chaos_soak.py`` over the port's
modules, with its flags, output lines, repro file and exit codes.

The rig (local subprocesses, each on the card unless ``--device cpu``):

- two or three ``PodNode`` children over one coordination store, a
  ``TorchCoordStore`` on a TCPStore this process hosts (the pod's journal
  root, ``{workdir}/pod``, passed as ``root=``), each with its own CRC
  journal + spool checkpoints;
- one ``NetServer`` child fronting a journaled ``SearchServer`` on a TCP
  port (the wire/stream layer);
- this parent process as orchestrator: it submits a solo/fleet/stream job
  mix via ``PodClient`` and ``SRClient``, fires the schedule's ``kill``
  events (SIGKILL + respawn), and feeds every observation to
  :class:`~symbolicregression_jl_tpu_torch.utils.invariants.InvariantAuditor`.

The jobs run on ``--device`` (``Options.device``): the card by default,
where the orchestrator builds the kernels once and every child loads them.
A rig that finds no card there is a rig error (exit 2); the CPU is used
only when ``--device cpu`` asks for it.

Faults are routed per process: each child boots with the
``SR_FAULT_SPEC`` slice of the schedule addressed to it (see
``utils.chaos.host_env_spec``). A respawned child re-arms its slice —
call counts reset with the process, which is exactly what a real
recurring fault does. Every child writes a report under
``{workdir}/reports`` every 0.2 s (:func:`read_reports`): its kernel
launches, the kernel libraries it loaded, whether it imported JAX, each
armed fault fired or idle.

Invariants audited (see ``utils/invariants.py``): exactly-once done
ledger, zero lost jobs, exact stream replay by index, every frame
decodes, every journal replays idempotently post-mortem, resumed jobs
finish their full budget, queue depth and the read-only journal buffer
stay bounded.

On a breach the soak exits 1 and — unless ``--no-shrink`` — delta-debugs
the schedule (``utils.chaos.ddmin``) by re-running short soaks, then
emits a minimal ``SR_FAULT_SPEC``-grammar repro string (stdout + artifact
file) that reproduces the breach.

Demo of the whole loop (deliberately reverted degradation):

    python symbolicregression_jl_tpu_torch/scripts/chaos_soak.py --seed 0 \\
        --duration 25 --break shed_silently \\
        --schedule 'disk_full@0:clear=1,host=h0,path=journal;ckpt_crash@0:host=h1;slow_client@1:delay_ms=100,host=net'

``--break shed_silently`` makes ``SearchServer.submit`` swallow the
disk-full shed instead of refusing it — the auditor must report
``no_lost_jobs`` and the shrinker must reduce the schedule to the single
``disk_full`` rule.

Usage: python symbolicregression_jl_tpu_torch/scripts/chaos_soak.py --seed S --duration 60
       (or python -m symbolicregression_jl_tpu_torch.scripts.chaos_soak ...)
Exit codes: 0 = all invariants held, 1 = breach, 2 = rig error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCRIPT = "symbolicregression_jl_tpu_torch/scripts/chaos_soak.py"

# every rig process runs this file: a pod host ("pod") or the NetServer
# ("net"), as its JSON spec says
_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from symbolicregression_jl_tpu_torch.scripts.chaos_soak import rig_child
rig_child(sys.argv[1])
"""

#: the kernel wrappers whose launches a child reports: B1, B2, B3, B4, B2v
KERNELS = ("fused_loss", "fused_loss_grad", "evolve_block", "eval_trees_kernel", "preds_vjp")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_imported() -> bool:
    return any(m in ("jax", "symbolicregression_jl_tpu")
               or m.startswith(("jax.", "symbolicregression_jl_tpu.")) for m in sys.modules)


def _dataset():
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y


def _opts(seed=0, device="cuda"):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"], unary_operators=["cos"],
        populations=2, population_size=12, ncycles_per_iteration=8,
        maxsize=12, seed=seed, scheduler="lockstep", save_to_file=False,
        progress=False, device=device,
    )


def rig_child(spec_json: str) -> None:
    """One rig process: a ``PodNode`` ("pod") over the orchestrator's
    TCPStore (wrapped in a ``PartitionedCoordStore`` when ``kv_partition``
    is armed in this process), or ("net") a ``NetServer`` over a journaled
    ``SearchServer``. Writes its report every 0.2 s; serves until killed."""
    import datetime

    import torch

    spec = json.loads(spec_json)
    if spec["device"] == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"chaos_soak: rig child {spec['host']} found no CUDA device "
                             "(pass --device cpu to run the soak on the CPU)")
        torch.zeros(1, device="cuda")  # the card's context, before READY

    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.parallel.membership import (
        PartitionedCoordStore, TorchCoordStore,
    )
    from symbolicregression_jl_tpu_torch.serve import NetServer, PodNode, SearchServer
    from symbolicregression_jl_tpu_torch.utils import faults

    wrappers = (interp_cuda.fused_loss, interp_cuda.fused_loss_grad, evolve_block,
                interp_cuda.eval_trees_kernel, interp_cuda.preds_vjp)
    host = spec["host"]
    path = os.path.join(spec["reports"], f"{host}-{os.getpid()}.json")
    node = None
    if spec["role"] == "net":
        srv = SearchServer(max_concurrency=1, journal_dir=spec["journal"],
                           ckpt_every_s=0.05).start()
        NetServer(srv, port=spec["port"]).start()
    else:
        import torch.distributed as tdist

        addr, port = spec["store"].rsplit(":", 1)
        store = TorchCoordStore(tdist.TCPStore(
            addr, int(port), None, False, timeout=datetime.timedelta(seconds=60)))
        if faults.active().armed("kv_partition"):
            store = PartitionedCoordStore(store)
        node = PodNode(host, store=store, root=spec["root"], hb_seconds=0.1,
                       suspect_seconds=2.0, max_concurrency=1, poll_seconds=0.02,
                       ckpt_every_s=0.1)
        node.install_sigterm_drain()
        node.start()
    print("READY " + host, flush=True)
    while True:  # serve until the parent kills us
        inj = faults.active()
        out = {
            "host": host, "pid": os.getpid(), "t": time.time(),
            "launches": {name: w.launches for name, w in zip(KERNELS, wrappers)},
            "libraries": {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()},
            "jax": _jax_imported(),
            # each armed rule of this process: fired once its site's calls
            # passed its count
            "faults": [f"{r.site}@{r.at} "
                       + ("fired" if inj._counts.get(r.site, 0) > r.at else "idle")
                       for r in inj._rules],
        }
        if node is not None:
            out["stats"] = {k: v for k, v in node.stats().items() if k != "server"}
            if hasattr(node.store, "partition_stats"):
                out["partition"] = node.store.partition_stats()
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
        time.sleep(0.2)


def read_reports(workdir: str) -> list[dict]:
    """Each rig process's last report (one per process: a SIGKILLed child's
    is the last it wrote before the kill), in file-name order."""
    d = os.path.join(workdir, "reports")
    out = []
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
    return out


class _Rig:
    """Child process bookkeeping: spawn, SIGKILL, respawn, logs."""

    def __init__(self, workdir: str, schedule, hosts, break_mode, device, store_addr):
        from symbolicregression_jl_tpu_torch.utils import chaos

        self.workdir = workdir
        self.schedule = schedule
        self.hosts = tuple(hosts)
        self.break_mode = break_mode
        self.device = device
        self.store_addr = store_addr
        self.root = os.path.join(workdir, "pod")
        self.net_journal = os.path.join(workdir, "net_journal")
        self.reports = os.path.join(workdir, "reports")
        os.makedirs(self.reports, exist_ok=True)
        self.port = _free_port()
        self.procs: dict[str, subprocess.Popen] = {}
        self._logs: dict[str, object] = {}
        self.script = os.path.join(workdir, "rig_child.py")
        with open(self.script, "w") as f:
            f.write(_CHILD.format(repo=REPO))
        self._chaos = chaos

    def _env(self, name: str) -> dict:
        env = {k: v for k, v in os.environ.items()
               if k not in ("SR_FAULT_SPEC", "SR_CHAOS_BREAK", "SR_COORD_DIR")
               and not k.startswith("SR_POD_")}
        env["SR_QUEUE_MAX_DEPTH"] = "32"
        spec = self._chaos.host_env_spec(self.schedule, name)
        if spec:
            env["SR_FAULT_SPEC"] = spec
        if self.break_mode:
            env["SR_CHAOS_BREAK"] = self.break_mode
        return env

    def spawn(self, name: str) -> None:
        if name in self._logs:  # a respawn: the dead child's handle
            self._logs[name].close()
        log = open(os.path.join(self.workdir, f"{name}.log"), "ab")
        self._logs[name] = log
        spec = {"host": name, "device": self.device, "reports": self.reports}
        if name == self._chaos.NET_HOST:
            spec.update(role="net", journal=self.net_journal, port=self.port)
        else:
            spec.update(role="pod", store=self.store_addr, root=self.root)
        self.procs[name] = subprocess.Popen(
            [sys.executable, self.script, json.dumps(spec)], stdout=log,
            stderr=subprocess.STDOUT, env=self._env(name), cwd=REPO,
        )

    def check_alive(self, names) -> None:
        """Raise if a child of ``names`` has exited on its own (it never
        came up: a rig error, not a breach)."""
        for name in names:
            rc = self.procs[name].poll()
            if rc is not None:
                raise RuntimeError(f"rig child {name} exited with code {rc} before it "
                                   f"came up:\n{self.tail_logs()}")

    def kill(self, name: str) -> None:
        p = self.procs.get(name)
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=60)

    def teardown(self) -> None:
        for name in list(self.procs):
            try:
                self.kill(name)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        for log in self._logs.values():
            try:
                log.close()
            except Exception:  # noqa: BLE001
                pass

    def tail_logs(self, n: int = 30) -> str:
        out = []
        for name in self.procs:
            path = os.path.join(self.workdir, f"{name}.log")
            try:
                with open(path, "r", errors="replace") as f:
                    lines = f.readlines()[-n:]
                out.append(f"--- {name} ---\n" + "".join(lines))
            except OSError:
                pass
        return "\n".join(out)


def run_soak(
    schedule,
    duration_s: float,
    workdir: str,
    hosts=("h0", "h1"),
    break_mode: str | None = None,
    verbose: bool = True,
    device: str = "cuda",
):
    """Drive one soak; returns the finalized InvariantAuditor. The jobs run
    on ``device``: "cuda" needs a card (a RuntimeError, the CLI's rig error,
    without one), "cpu" runs them on the CPU."""
    import datetime

    import torch
    import torch.distributed as tdist

    from symbolicregression_jl_tpu_torch.parallel.membership import TorchCoordStore
    from symbolicregression_jl_tpu_torch.serve import JobSpec, PodClient
    from symbolicregression_jl_tpu_torch.serve.net import SRClient
    from symbolicregression_jl_tpu_torch.utils.chaos import NET_HOST, kill_events
    from symbolicregression_jl_tpu_torch.utils.invariants import InvariantAuditor

    def say(msg: str) -> None:
        if verbose:
            print(f"[chaos] {msg}", flush=True)

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the soak runs its jobs on the card "
                               "(--device cpu runs them on the CPU)")
        from symbolicregression_jl_tpu_torch.ops import interp_cuda

        interp_cuda.build_all()  # once, here: every child loads the libraries
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")

    X, y = _dataset()
    auditor = InvariantAuditor(queue_max_depth=32)
    master = tdist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=60),
                            wait_for_workers=False)
    rig = _Rig(workdir, schedule, hosts, break_mode, device, f"127.0.0.1:{master.port}")
    kills = kill_events(schedule)
    pending_respawn: list[tuple[float, str]] = []
    net_ids: list[str] = []
    long_id = None
    stream = None
    cli = None

    try:
        for h in rig.hosts:
            rig.spawn(h)
        rig.spawn(NET_HOST)

        client = PodClient(store=TorchCoordStore(master), suspect_seconds=2.0)
        deadline = time.time() + 180
        while set(rig.hosts) - set(client.live_hosts()):
            rig.check_alive(rig.hosts)
            if time.time() > deadline:
                raise RuntimeError(
                    f"pod hosts never advertised: {client.live_hosts()}"
                )
            time.sleep(0.1)
        cli = None
        while cli is None:
            try:
                cli = SRClient("127.0.0.1", rig.port,
                               reconnect_deadline_s=120.0)
                cli.ping()
            except Exception:  # noqa: BLE001 — net child still booting
                cli = None
                rig.check_alive([NET_HOST])
                if time.time() > deadline:
                    raise RuntimeError("net child never came up") from None
                time.sleep(0.2)
        say(f"rig up: hosts={list(rig.hosts)} net port={rig.port} device={device}")

        # --- initial mix: pinned solos, a fleet-bait burst, net stream ------
        seed_seq = iter(range(1, 10_000))
        for h in rig.hosts:
            pjid = client.submit(
                JobSpec(X, y, options=_opts(next(seed_seq), device), niterations=3),
                host=h,
            )
            auditor.note_submit(pjid, niterations=3)
        for _ in range(3):  # compatible burst: coalesces into a fleet
            pjid = client.submit(
                JobSpec(X, y, options=_opts(next(seed_seq), device), niterations=2)
            )
            auditor.note_submit(pjid, niterations=2)
        short_net = cli.submit(JobSpec(X, y, options=_opts(0, device), niterations=2))
        long_id = cli.submit(JobSpec(X, y, options=_opts(0, device), niterations=25))
        net_ids = [short_net, long_id]
        for jid in net_ids:
            auditor.note_submit(f"net/{jid}")
        stream = cli.subscribe(long_id)

        # --- soak loop ------------------------------------------------------
        t0 = time.time()
        submit_stop = t0 + 0.6 * duration_s
        next_submit = t0 + 4.0
        pod_jobs = 5
        seen_done: set[str] = set()
        while time.time() - t0 < duration_s:
            now = time.time()
            while kills and now - t0 >= kills[0]["at_s"]:
                ev = kills.pop(0)
                say(f"kill {ev['host']} at t+{now - t0:.1f}s "
                    f"(down {ev['down_s']:.1f}s)")
                rig.kill(ev["host"])
                pending_respawn.append((now + ev["down_s"], ev["host"]))
            for t_up, h in list(pending_respawn):
                if now >= t_up:
                    pending_respawn.remove((t_up, h))
                    say(f"respawn {h}")
                    rig.spawn(h)
            if now >= next_submit and now < submit_stop and pod_jobs < 14:
                next_submit = now + 4.0
                pod_jobs += 1
                pjid = client.submit(
                    JobSpec(X, y, options=_opts(next(seed_seq), device),
                            niterations=2)
                )
                auditor.note_submit(pjid, niterations=2)
            try:
                for h, ad in client.hosts().items():
                    auditor.observe_host_stats(h, ad)
            except Exception:  # noqa: BLE001 — store mid-rotation
                pass
            try:
                for pjid, rec in client.results().items():
                    if pjid not in seen_done:
                        seen_done.add(pjid)
                        auditor.observe_done(pjid, rec)
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.25)

        # any kill still pending past the soak window fires nothing; but a
        # host killed and not yet respawned must come back for the drain
        for _, h in pending_respawn:
            say(f"respawn {h} (post-soak)")
            rig.spawn(h)
        pending_respawn.clear()

        # --- drain: every accepted job must land in the done ledger ---------
        drain_deadline = time.time() + max(240.0, 4 * duration_s)
        say("drain: waiting for the done ledger to cover all submits")
        while time.time() < drain_deadline:
            try:
                results = client.results()
            except Exception:  # noqa: BLE001
                time.sleep(0.5)
                continue
            for pjid, rec in results.items():
                if pjid not in seen_done:
                    seen_done.add(pjid)
                    auditor.observe_done(pjid, rec)
            if auditor._submitted - {f"net/{j}" for j in net_ids} <= set(
                results
            ):
                break
            time.sleep(0.5)
        try:
            for h, ad in client.hosts().items():
                auditor.observe_host_stats(h, ad)
        except Exception:  # noqa: BLE001
            pass

        # --- net drain + stream audit ---------------------------------------
        # own budget: the pod drain above may have burned its whole deadline
        # on a genuinely lost pod job, and that must not cascade into
        # false "never finished" verdicts for healthy net jobs
        net_deadline = time.time() + max(120.0, 2 * duration_s)
        for jid in net_ids:
            state = None
            while time.time() < net_deadline:
                try:
                    summary = cli.terminal_summary(jid) or {}
                    state = summary.get("state")
                    if state is None:
                        st2 = cli.status(jid)
                        state = (
                            st2["state"]
                            if st2["state"] in
                            ("done", "failed", "expired", "cancelled",
                             "quarantined")
                            else None
                        )
                    if state is not None:
                        break
                except Exception:  # noqa: BLE001 — reconnect window
                    pass
                time.sleep(0.5)
            auditor.observe_done(
                f"net/{jid}", {"state": state if state else "running"}
            )
        try:
            stored = cli.frames(long_id, 0)
            auditor.check_stream(
                f"net/{long_id}", stream.dup_dropped, stream.next_index,
                stored, stream.frames,
            )
        except Exception as e:  # noqa: BLE001
            auditor._breach(
                "frame_monotonic",
                f"stream audit impossible (net unreachable at drain): {e!r}",
            )
        try:
            cli.close()
        except Exception:  # noqa: BLE001
            pass

        # --- post-mortem: every journal generation must replay --------------
        rig.teardown()  # SIGKILL everything first: no live writers
        for jdir in sorted(glob.glob(os.path.join(rig.root, "*", "gen-*"))):
            auditor.check_journal(jdir, context="pod gen")
        if os.path.isdir(rig.net_journal):
            auditor.check_journal(rig.net_journal, context="net journal")

        auditor.finalize()
        for rep in read_reports(workdir):
            launched = [f"{k} {v}" for k, v in rep["launches"].items() if v]
            say(f"child {rep['host']} (pid {rep['pid']}): kernel launches "
                f"{', '.join(launched) or 'none'}; faults {rep['faults']}")
        if not auditor.ok and verbose:
            print(rig.tail_logs(), flush=True)
        return auditor
    except Exception:
        if verbose:
            print(rig.tail_logs(), flush=True)
        raise
    finally:
        rig.teardown()


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.utils import chaos
    from symbolicregression_jl_tpu_torch.utils.faults import FaultRule

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--hosts", type=int, default=2, choices=(2, 3))
    ap.add_argument("--schedule", default=None,
                    help="explicit schedule spec (overrides --seed)")
    ap.add_argument("--emit-schedule", action="store_true",
                    help="print the generated schedule spec and exit")
    ap.add_argument("--break", dest="break_mode", default=None,
                    choices=("shed_silently",),
                    help="deliberately revert one degradation (demo: the "
                         "auditor must catch it and the shrinker must "
                         "minimize the schedule)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="on breach, skip delta-debugging the schedule")
    ap.add_argument("--shrink-duration", type=float, default=25.0,
                    help="soak seconds per shrink attempt")
    ap.add_argument("--shrink-runs", type=int, default=12,
                    help="max soak re-runs the shrinker may spend")
    ap.add_argument("--workdir", default=None,
                    help="keep rig state here instead of a temp dir")
    ap.add_argument("--repro-out", default=None,
                    help="write the (shrunk) failing schedule spec here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the rig's jobs run: the card (default; no card "
                         "is a rig error) or, when asked for, the CPU")
    args = ap.parse_args(argv)

    host_names = tuple(f"h{i}" for i in range(args.hosts))
    if args.schedule:
        schedule = chaos.parse_schedule(args.schedule)
    else:
        schedule = chaos.generate_schedule(
            args.seed, args.duration, hosts=host_names
        )
        if args.break_mode:
            # the demo needs the shed window to hit a SUBMIT append
            # deterministically: first journal append of h0 goes read-only
            schedule = tuple(
                FaultRule("disk_full", 0, (("clear", 1), ("host", "h0"),
                                           ("path", "journal")))
                if r.site == "disk_full" else r
                for r in schedule
            )
    spec = chaos.schedule_spec(schedule)
    print(f"CHAOS seed={args.seed} duration={args.duration:.0f}s "
          f"hosts={args.hosts}\nSCHEDULE {spec}", flush=True)
    if args.emit_schedule:
        return 0

    def soak_once(rules, duration, verbose) -> object:
        if args.workdir:
            os.makedirs(args.workdir, exist_ok=True)
            run_dir = tempfile.mkdtemp(dir=args.workdir, prefix="run-")
            return run_soak(rules, duration, run_dir, hosts=host_names,
                            break_mode=args.break_mode, verbose=verbose,
                            device=args.device)
        with tempfile.TemporaryDirectory() as d:
            return run_soak(rules, duration, d, hosts=host_names,
                            break_mode=args.break_mode, verbose=verbose,
                            device=args.device)

    auditor = soak_once(schedule, args.duration, verbose=True)
    print(auditor.report(), flush=True)
    if auditor.ok:
        print("CHAOS_SOAK=pass", flush=True)
        return 0

    target = auditor.breach_names()
    minimal = schedule
    if not args.no_shrink and len(schedule) > 1:
        print(f"shrinking schedule against breaches {sorted(target)} "
              f"({args.shrink_runs} runs x {args.shrink_duration:.0f}s max)",
              flush=True)
        budget = {"left": args.shrink_runs}

        def failing(candidate) -> bool:
            if budget["left"] <= 0:
                return False  # budget exhausted: treat as non-failing
            budget["left"] -= 1
            try:
                a = soak_once(candidate, args.shrink_duration, verbose=False)
            except Exception as e:  # noqa: BLE001 — rig error != breach
                print(f"  shrink run errored ({e!r}); treating as pass",
                      flush=True)
                return False
            hit = bool(a.breach_names() & target)
            print(f"  shrink: {len(candidate)} rule(s) -> "
                  f"{'FAIL (kept)' if hit else 'pass (discarded)'}",
                  flush=True)
            return hit

        minimal = chaos.ddmin(schedule, failing)
    repro = chaos.schedule_spec(minimal)
    out = args.repro_out or os.path.join(
        args.workdir or tempfile.gettempdir(), "chaos_repro.txt"
    )
    with open(out, "w") as f:
        f.write(
            f"# chaos repro (seed={args.seed}, breaches="
            f"{sorted(target)})\n"
            f"# rerun: python {SCRIPT} --schedule '{repro}' "
            f"--duration {args.shrink_duration:.0f}"
            + (f" --break {args.break_mode}" if args.break_mode else "")
            + (f" --device {args.device}" if args.device != "cuda" else "")
            + "\n"
            f"{repro}\n"
        )
    print(f"CHAOS_REPRO ({len(minimal)} rule(s)) {repro}\n"
          f"repro written to {out}\nCHAOS_SOAK=fail", flush=True)
    return 1


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(130)
    except Exception as e:  # noqa: BLE001 — rig error, not a breach
        print(f"CHAOS_SOAK=error {e!r}", flush=True)
        raise SystemExit(2)
