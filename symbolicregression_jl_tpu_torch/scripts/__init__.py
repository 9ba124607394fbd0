"""The port's command-line tools, each runnable as a file or with
``python -m symbolicregression_jl_tpu_torch.scripts.<name>``:
``sr_lint`` (the port's static analysis, ``analysis/lint.py``) and
``chaos_soak`` (the seeded chaos soak with its shrinker); and the drills,
the JAX package's smoke scripts on the port, each a function of the device
(the card unless ``--device cpu``; no card is exit 2) that ``chip_smoke.py``
and the tests call too: ``debug_checks_smoke`` (``SR_DEBUG_CHECKS=1`` on
both schedulers, then a checkpoint and a resume), ``serve_smoke`` (one
server, two tenants, an expiry in the queue, a preemption and resume, the
warm-hit ratio), ``fleet_smoke`` (8 jobs coalesced into fleets bitwise
equal to their solo runs, a cancel mid-fleet), ``stream_smoke`` (a
subscription: pushes, a drifted replace, a cancel), ``net_smoke`` (a server
child driven through ``SRClient``) and ``fault_smoke`` (six fault cycles:
checkpoint, exchange, elastic, serve, net, pod; ``all`` prints a verdict
table and ``FAULT_SMOKE=pass|fail``). ``_drill`` holds what the drills
share: the ``--device`` flag and its rig check."""
