#!/usr/bin/env python
"""Network front-door smoke: a real server subprocess + the SDK over
localhost TCP, the CI gate for the port's ``serve/net/``.

A child process runs ``SearchServer`` + ``NetServer`` on an ephemeral
port; the parent drives it purely through ``SRClient`` (no shared
memory), the way an external user would.

Asserts (the CI gate):
- a mixed batch completes over one socket: two lockstep search jobs plus
  one device-scheduler subscription job;
- pushed frame streams decode as format-2 frontiers, and the pull-path
  ``frames`` op replays byte-identically what was pushed;
- ``push_rows`` over the wire lands in the live subscription (the stream
  keeps producing frames afterwards);
- ``cancel`` over the wire ends the subscription cleanly: terminal DONE
  with stop_reason "cancelled";
- ``stats`` round-trips the wire with the server and net counter blocks.

Run: python symbolicregression_jl_tpu_torch/scripts/net_smoke.py [--device cpu]
(or python -m symbolicregression_jl_tpu_torch.scripts.net_smoke). The jobs
run on the card unless ``--device cpu``; no card is exit 2.
"""

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = """
import sys
sys.path.insert(0, {root!r})
if {device!r} != "cpu":
    import torch
    torch.zeros(1, device={device!r})  # the card's context, before PORT
from symbolicregression_jl_tpu_torch.serve import NetServer, SearchServer

srv = SearchServer(max_concurrency=2).start()
net = NetServer(srv, port=0).start()
print("PORT", net.port, flush=True)
try:
    while sys.stdin.readline():
        pass
finally:
    net.shutdown()
    srv.shutdown()
"""


def _problem(n=60, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _search_opts(device):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=2,
        population_size=8,
        ncycles_per_iteration=8,
        maxsize=10,
        save_to_file=False,
        seed=0,
        scheduler="lockstep",
        progress=False,
        device=str(device),
    )


def _sub_opts(device):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=4,
        population_size=16,
        ncycles_per_iteration=40,
        maxsize=14,
        save_to_file=False,
        seed=0,
        scheduler="device",
        progress=False,
        device=str(device),
    )


def run(device: str = "cuda", iterations: int = 3) -> None:
    """The drill against a server child; ``iterations`` is each lockstep
    search's budget."""
    from symbolicregression_jl_tpu_torch.serve import JobSpec
    from symbolicregression_jl_tpu_torch.serve.net import SRClient
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="sr-net-smoke-") as d:
        script = os.path.join(d, "server.py")
        with open(script, "w") as fh:
            fh.write(_CHILD.format(root=REPO, device=str(device)))
        child = subprocess.Popen([sys.executable, script], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=None, text=True)
        try:
            line = child.stdout.readline()
            if not line.startswith("PORT "):
                raise AssertionError(f"server child said {line!r}")
            port = int(line.split()[1])
            print(f"[net_smoke] server child up on :{port} -- {time.time() - t0:.1f}s",
                  flush=True)

            X, y = _problem(60)
            with SRClient("127.0.0.1", port, tenant="smoke") as cli:
                boot = cli.ping()["boot"]
                # subscription first: it sets up its device lane on one
                # worker while the lockstep searches run on the other
                sub = cli.submit(JobSpec(X=X, y=y, options=_sub_opts(device),
                                         kind="subscription",
                                         stream_config={"row_bucket": 64}))
                searches = [
                    cli.submit(JobSpec(X=X, y=y, options=_search_opts(device),
                                       niterations=iterations, stream_every=1))
                    for _ in range(2)
                ]

                # -- search legs: streamed frames decode + replay exactly -----
                for jid in searches:
                    frames = list(cli.iter_frames(jid, timeout=600))
                    if not frames:
                        raise AssertionError(f"{jid}: no frames streamed")
                    if not load_frontier_bytes(frames[-1]).members:
                        raise AssertionError(f"{jid}: empty frontier frame")
                    if cli.frames(jid, 0) != frames:
                        raise AssertionError(f"{jid}: replay mismatch")
                    summary = cli.wait(jid, timeout=120)
                    if summary["state"] != "done":
                        raise AssertionError(summary)
                print(f"[net_smoke] 2 search jobs streamed + replayed exactly over "
                      f"the wire -- {time.time() - t0:.1f}s", flush=True)

                # -- subscription leg: first frame, live rows, more frames ----
                stream = cli.iter_frames(sub, timeout=900)
                first = next(stream)
                best0 = min(m.loss for m in load_frontier_bytes(first).members)
                print(f"[net_smoke] subscription first frame: best loss "
                      f"{best0:.4f} -- {time.time() - t0:.1f}s", flush=True)
                Xn, yn = _problem(4, seed=5)
                cli.push_rows(sub, Xn, yn)  # 60 -> 64 rows, in-bucket
                after_push = next(stream)  # the lane keeps producing frames
                if not load_frontier_bytes(after_push).members:
                    raise AssertionError("empty frame after push_rows")
                print(f"[net_smoke] push_rows over the wire accepted; stream still "
                      f"live -- {time.time() - t0:.1f}s", flush=True)

                # -- clean cancel over the wire -------------------------------
                cli.cancel(sub)
                summary = cli.wait(sub, timeout=600)
                if summary["state"] != "done" or summary["stop_reason"] != "cancelled":
                    raise AssertionError(summary)
                print(f"[net_smoke] subscription cancelled cleanly after "
                      f"{summary['iterations_done']} iterations, "
                      f"{summary['frames']} frames -- {time.time() - t0:.1f}s", flush=True)

                stats = cli.stats()
                if stats["net"]["boot"] != boot or stats["net"]["frames_pushed"] < 3:
                    raise AssertionError(stats["net"])
                if stats["server"]["jobs"].get("done", 0) < 3:
                    raise AssertionError(stats["server"]["jobs"])
                if cli.reconnects != 0:
                    raise AssertionError("smoke should not need reconnects")
        finally:
            try:
                child.stdin.close()
                child.wait(timeout=30)
            except Exception:  # noqa: BLE001 -- a child that will not stop is killed
                child.kill()
                child.wait(timeout=30)
    print(f"[net_smoke] OK in {time.time() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    args = _drill.parser(__doc__).parse_args(argv)
    _drill.check_device("net_smoke", args.device)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
