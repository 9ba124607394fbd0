#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (the kernels are built from the checkout's
sources at first use) and the packages of the port; it imports nothing of
JAX or of the JAX package. Phases, each of which raises on failure:

1. the card's name and power limit; build every kernel (one ``nvcc`` per
   source, all started together), asked for by two threads at once as a
   server's workers do: each library is built once, and report the builds;
2. kernel check of B1, the fused eval+loss kernel (``fused_loss``), against
   its plain PyTorch version on the card, at the main paths' shapes
   (config3: 10,000 rows x 5 features, maxsize 20), weighted and
   unweighted, on minibatches, on a corpus touching every built-in
   operator, and for every built-in real loss; timings with CUDA events at
   the lockstep scoring shape (1024 programs) and the device engine's
   constant-optimization shape (4,200), with slot evaluations per second;
3. kernel check of B2, the fused loss+gradient kernel
   (``fused_loss_grad``), the same way, at the device engine's
   constant-optimization shape (4,200 instances x 10,000 rows), where two
   launches must give identical bits and rows that are not stack-sound
   must score inf with zero gradients; its timing there and at a 50-row
   minibatch (1024 programs), each with the device's time alone; then one
   tree per built-in operator on U(-2, 2) and U(-20, 20) rows through B4
   and its plain version, which must give equal values on every row;
   kernel check of B3, the evolve block (``evolve_block``): after 1 and 8
   cycles from one seed its integer outputs equal its plain version's and
   its float outputs agree, at config3 width (100 islands x 100 members),
   at the quick-start shape, on the all-operator corpus and for every loss;
   a block of ENGINE_CYCLES cycles checked for its own consistency; its
   timing at 1 and ENGINE_CYCLES cycles on 256, 2,500 and 10,000 rows, whose
   fitted line splits a cycle into what scales with rows (scoring) and what
   does not (stages 1-2, replacement, syncs); and
   kernel check of B4, the prediction matrix (``eval_trees_kernel``),
   every tree of both corpora held;
4. the lockstep main path at full width: ``equation_search`` on config3
   (100 populations x 100 members), with every scoring dispatch counted as a
   B1 launch;
5. the device-engine main path at full width, after the port's own lint
   (``symbolicregression_jl_tpu_torch/scripts/sr_lint.py``, the torch rule
   set, over the port package; every finding suppressed with a reason, each
   printed): ``equation_search(..., scheduler="device")`` on config3, first
   with ``SR_ENGINE_BLOCK=0`` (the event leg; no B3 launch), then by
   default (the evolve leg is one B3 launch per iteration); every B1 launch
   counted against the engine's scoring calls and every B2 launch against
   its gradient calls, the first iteration's evolve leg run with host syncs
   made errors, its const-opt leg under the sync census (torch's sync debug
   mode "warn"; every sync located at its line in the port, which must
   carry an SRL003 finding of the lint; the engine's own count of the leg's
   syncs, ``engine_stats["host_syncs"]``'s g_tol and Armijo sites, must
   equal the census's), every leg timed between
   synchronizations and the last iteration's legs traced with
   torch.profiler (kernel time by name, the device's idle share);
6. the README quick start through ``SRRegressor`` on the card, under the
   lockstep scheduler, then twice under ``scheduler="device"`` with one
   seed, through B3 (the two frontiers must be identical);
7. ``resume``, kill and resume on the card: (a) lockstep at the quick
   start's size run twice uninterrupted (identical frontiers), then killed
   at iteration 2 by ``peer_death`` and resumed from its snapshot: the
   frontier must equal the uninterrupted run's string for string, and
   num_evals too; (b) the device engine at config3 width on the block,
   killed at iteration 2 and resumed from its ``exact=False`` snapshot: no
   frontier lost, more evaluations, the block's kernel, and each
   snapshot's host ms; (c) the engine with ``nan_flood@1:frac=0.75`` and a
   snapshot after every iteration: a finite frontier; (d) ``ckpt_crash@1`` on lockstep: the first snapshot
   stays loadable and a resume from it finishes. The resumed runs' launches
   are the kernels' ``resume`` path;
8. ``engine_options``, the device engine's single-card options: (a) config3
   on the block with ``profile=True`` (every iteration profiled, top-level
   fractions summing to 1, the frontier equal to the unprofiled run's in
   the synchronous readback the profile forces; each stage beside the leg
   timers, the iteration wall beside the unprofiled ones); (b) units on the
   planted y = x0 x1^2 / x2 (kg, m/s, m -> N, 10,000 rows) on lockstep and
   on the engine's event leg: every frontier member the host oracle flags
   carries the penalty, and the engine's batched check equals the oracle on
   every member of its final populations; (c) the quick start on the
   engine with the recorder: every evolve leg free of host syncs, the
   replay's mirror equal to the engine's populations after every
   iteration, the record's mutation count exact; (d) the quick start on
   the engine with NelderMead: no B2 launch, a finite frontier. Each run's
   launches are the kernels' path of the same name;
9. ``fleet``, many searches as one (``fleet_search``): (a) B1, B2 and B3 on
   the lane axis, 3 lanes over config3's X with a y each, against their
   plain versions and, bit for bit, against one solo launch per lane (B1
   and B2 at 4,200 programs a lane, where the solo cuts each program's rows
   into 2 chunks, and at 64), then timed at 1 and 4 lanes; whether one
   ``torch.bmm`` over the lanes gives each lane the bits of its own call is
   printed (the reason the fleet's BFGS calls it per lane); (b)
   ``multitarget_search`` of four targets on config3's X (config3's y and
   three planted laws) at config3 width, 3 iterations x ENGINE_CYCLES on
   the block, beside the four solo runs at seeds s + t: every lane's
   frontier and num_evals equal its solo's, B3 once per iteration for the
   fleet, B2 no more than one solo; the legs per iteration against the
   solos' sums and the const-opt leg's idle share; (c) a 6,000-row lane of
   3 iterations beside a 10,000-row lane of 1, each equal to its solo on the
   padded, weighted data; (d) two lanes on the event leg
   (``SR_ENGINE_BLOCK=0``) at the quick start's size, each equal to its
   solo. The fleet runs' launches are the path ``fleet``, their solo
   references' ``fleet solos``; the kernels line's ``lane_axis`` holds the
   lane-axis check's error and times;
10. ``stream``, a ``StreamSession`` (one fleet lane whose rows change
   between iterations), gated at every iteration boundary: (a) at config3
   width on a 10,240-row bucket (the block) from config3's rows 0-7,999,
   rows 8,000-8,999 and 9,000-9,999 pushed: after each swap the lane's X, y,
   w and norm keep their pointers, no kernel is built, B3 ran once per
   iteration and the resident y and w equal the padded host rows bit for
   bit, with the iteration times around the swaps and the hook's host ms;
   after the second push B1 and B2 on the lane's 10,240 resident rows (the
   frontier's trees, and 4,200 programs at the BFGS's shape), B1 on the
   probe's 1,000 incoming rows, and B3 on the engine's last launch's
   inputs (8 cycles) against their plain versions, within the smoke's
   tolerances;
   (b) a replace with the same X and another law at iteration 5: drift, a
   rescore whose best loss is above twice the fitted one, two more
   iterations with a finite frontier, the probe's and rescore's host ms;
   (c) rows 10,000-10,999 pushed: one restart on a 16,384-row bucket with
   the same hall of fame, one iteration there, and which evolve leg each
   epoch ran; B1 and B2 on its 16,384 rows against their plain versions as
   in (a); (d) every frame decodes with ``niterations`` 0 and the stop
   is a callback stop; (e) the quick start's size on a 256-row bucket twice
   with one seed, one run re-staging its identical rows at iteration 1:
   identical frontiers. Its launches are the path ``stream``;
11. ``serve``, the ``SearchServer`` on the card: (a) one server with two
   workers and fleet coalescing; with admission paused, the four jobs of
   phase 9 (b) (config3 width, the same seeds and iterations, one bucket)
   and (b) two identical jobs at the quick start's size are submitted, then
   admission resumes: the four run as one fleet (B3 once per block
   iteration, each job's frontier and num_evals bit for bit phase 9 (b)'s
   lane, one frame per iteration and a last frame that decodes to its
   frontier) while the pair runs as one search on the other worker (both
   DONE with the frontier of the same search run directly); a third
   quick-start job with another seed hits the program cache's
   ``score_data`` entry; (c) one worker: a priority-0 config3 job of 6
   iterations held at its first iteration boundary until a priority-1
   quick-start job arrives is snapshotted into the spool (host ms),
   requeued and resumed, and ends DONE with 6 iterations and more
   evaluations than at its snapshot; (d) a subscription on config3's first
   8,000 rows (``row_bucket=10_240``), rows 8,000-9,999 pushed after its
   first frame, then cancelled: DONE with at least two frames, B3 once per
   block iteration, no kernel built; (e) B3 on the fleet's last launch's
   inputs against its plain version. Each job's queue wait, time to first
   frame and submit-to-terminal time, and the server's stats, are printed.
   Its launches are the path ``serve``;
12. ``net``, the network front door (``NetServer`` and the ``SRClient`` /
   ``AsyncSRClient`` SDK over 127.0.0.1) in front of a
   ``SearchServer(max_concurrency=2)``, clients holding a token: (a) phase
   9 (b)'s seed-0 config3 job submitted and streamed over the wire beside a
   quick-start job on the async client: pushed frames equal pulled ones
   byte for byte, a subscription from index 1 gets the suffix, the last
   frame's frontier and num_evals equal phase 9 (b)'s lane bit for bit, an
   unknown token is refused, B3 once per block iteration; the ping's round
   trip (median of 50), the submit's for the config3 spec, and each job's
   first frame at the client beside the server's ``ttff_seconds``; (b)
   ``torn_frame@1;net_drop@3`` on a quick-start stream: every frame
   delivered once after at least two reconnects; (c) kill and recover over
   the wire: a server child with a journal on a fixed port runs two
   quick-start jobs and a config3-width job of 8 iterations on the card, is
   SIGKILLed mid-run and restarted with the two wire faults armed: 3 of 3
   jobs DONE, the long one resumed from its spool snapshot, the stream
   replayed exactly across the new boot, no kernel built; the restarted
   child's time to READY, journal replay and adoption; (d) a subscription
   on config3's rows 0-7,999, rows 8,000-9,999 pushed and a cancel, all over
   the wire: DONE, cancelled, B3 once per block iteration, no kernel built.
   The launches of (a), (b) and (d) are the path ``net``; the children's
   are not counted;
13. ``features``, the slice-2 features at config3 width: (a) 4,200 random
   config3 programs on 10,000 rows: a weighted-MSE full objective through
   B4 (``objective_losses``) against B1, and B2's seeded mode (B2v,
   ``preds_vjp``, the objective's gradient) against its plain version on a
   random seed (also at 1024 x 50 rows and with unsound rows), then both
   timed; (b) config3 under the objective 1 - corr(preds, y)^2 on the
   device engine for ENGINE_ITERATIONS x ENGINE_CYCLES (the event leg, the
   first evolve leg with host syncs made errors, the last const-opt leg
   traced for its idle share) and on lockstep for 1 x
   FEATURES_LOCKSTEP_CYCLES: B4 launches equal the scoring calls (plus, on
   the engine, one forward per gradient call), B2v the engine's gradient
   calls, no B1, B2 or B3, and every frontier member's
   loss is the objective of its decoded tree; (c) config3 on lockstep with
   ``graph_nodes=True``: the rows that carried sharing, 0 unsound rows
   after re-pointing, and B1 on the re-pointed programs against the plain
   version on the raw ones; (d) the planted complex64 equation at 10,000
   rows on lockstep on the card to JAX's 1e-2 bar, every complex operator
   on the card against the CPU, ``SRRegressor.predict`` on a complex X.
   Its launches are the paths ``objective device``, ``objective
   lockstep``, ``graph nodes`` and ``complex``;
14. ``scale_out``, slice 4's multi-process search (``parallel/``): (a) a
   world of 2 over ``initialize()`` (a TCPStore on 127.0.0.1 hosted by
   rank 0, gloo), both children on the one card, each the device engine on
   50 of config3's 100 islands, ENGINE_ITERATIONS x ENGINE_CYCLES on the
   block: identical halls of fame, B3 once per iteration in each, B1 and
   B2 counted against each engine's calls, B3 on rank 0's last launch and
   B1 and B2 on its frontier against their plain versions; per process the
   leg ms per iteration, the payload bytes, evals/s and the card's busy
   share under torch.profiler, phase 5's solo run beside them; (b) the
   elastic drill (``SR_COORD_DIR``, ``on_peer_loss="rejoin"``) at config3
   width, ELASTIC_ITERATIONS x ELASTIC_CYCLES: a no-fault run, then rank 1
   killed by ``peer_death`` (exit 43) while rank 0 is paced by
   ``slow_peer``, restarted with ``SR_ELASTIC_JOIN=1``: the leave and the
   rejoin land on distinct, ordered epochs, the survivor ends with no dead
   peer, both sides' best within 100x of the no-fault run's (JAX's drill's
   bar); the detection ms, epochs and the joiner's admission-to-first-
   exchange ms; (c) ``scheduler="async"`` on config3, 100 x 100, 1 x
   ASYNC_CYCLES, in a child started first that runs beside (a), (b) and
   (d) (its cost is one constant optimization per work unit, which no cut
   of cycles removes): B1 launches equal the scorer's dispatches, the head
   occupancy; (d) ``make_sharded_loss`` over [cuda:0, cuda:0] at
   ROWS_SHARDED rows x 1,024 programs, weighted and not, against one B1
   call and the plain version, both timed, and lockstep with
   ``data_sharding="rows"`` equal to the unsharded search bit for bit. The
   children load the libraries phase 1 built and import nothing of JAX
   (``_check_child_builds``); each prints its launches, which are the
   paths ``scale_out``, ``elastic`` and ``async``; the parent's are
   ``rows``;
15. ``pod``, federated serving (``serve/pod.py``) with chaos and the
   invariant auditor (``utils/chaos.py``, ``utils/invariants.py``): (a)
   two ``PodNode`` children, h0 and h1, over one ``FileCoordStore``; pinned
   to h1 and running at once, a lockstep job at the quick start's size
   with exact spool snapshots and a config3-width engine job on the block,
   three short jobs queued behind them and two routed freely; h1 SIGKILLed
   once both have a spool snapshot: every job DONE in the done ledger, no
   duplicate result, the migrated lockstep frontier equal to an
   uninterrupted run's string for string, the config3 job resumed on h0
   with its last snapshot's frontier kept, more evaluations and B1, B2 and
   B3 launched in h0; the kill-to-claim ms, the suspect window, the
   adoption ms and each job's submit-to-DONE time; (b) a third host, h2,
   given two jobs and SIGTERMed: exit 0, a retirement marker, h0's claim
   of its generation, both jobs DONE, no duplicate, the handoff s; (c) in
   a child started first, beside (a) and (b): one seeded soak through the
   port's ``run_soak`` (``symbolicregression_jl_tpu_torch/scripts/
   chaos_soak.py``; ``generate_schedule(CHAOS_SEED, CHAOS_DURATION_S)``,
   printed as its ``schedule_spec``) over two pod children and a
   ``NetServer`` child on a ``TorchCoordStore`` (a TCPStore the orchestrator
   hosts), kills as SIGKILL and respawn, a mixed workload through
   ``PodClient`` and ``SRClient``, every observation audited by
   ``InvariantAuditor``: any breach fails. The
   children load the libraries phase 1 built and import nothing of JAX;
   each reports its launches every 0.2 s (a SIGKILLed child's count is its
   last report's): the paths ``pod`` ((a) and (b)) and ``chaos``; the
   lockstep reference run in this process is ``pod reference``.
16. ``mesh``: the device engine's in-process mesh (``parallel/mesh.py``,
   the sharded iteration of ``ops/evolve.py``, the mesh decision of
   ``models/device_search.py``) over every card of the machine. (a) config3
   at full width (100 x 100, 10,000 rows x 5 features, maxsize 20),
   MESH_ITERATIONS x MESH_CYCLES cycles, on a pop mesh of four shards: the
   search's ``Options(mesh_devices=...)`` names the four cards, or cuda:0
   four times on one card, and the engine's own rule shards the islands;
   evolve ms per cycle, the const-opt legs,
   the evolve leg's gathers per cycle and their ms, B1 and B2 launches per
   card; the first evolve leg under ``set_sync_debug_mode("error")``; after
   every iteration the replicated leaves of every shard equal shard 0's;
   every frontier loss its tree's host f64 loss (rel 1e-3, abs 1e-4);
   num_evals > 0; no B3. (b) ``data_sharding="rows"`` on the same four
   shards and config3's first 9,998 rows, where the engine's rule picks a
   (2, 2) mesh (rows 4 does not divide 9,998), MESH_ROWS_ITERATIONS x
   MESH_ROWS_CYCLES, checked the same way. (d) ``Options(device="cuda")``
   with no ``mesh_devices`` at (a)'s depth: one card on the evolve block,
   whatever the machine holds; its evals/s beside (a)'s. (c) with
   two cards or more: (a) again with the four shards on cuda:0, its
   frontier and num_evals bit for bit (a)'s; B1 and B2 against their plain
   versions on every card; phase 14 (d)'s row-sharded B1 at 1M rows over
   the cards against one B1 call. Paths ``mesh``, ``mesh rows``,
   ``mesh solo`` and ``mesh rows B1``. The earlier phases run on ``cuda:0`` (their Options
   name it).
17. ``drills``: the port's drill CLIs (``symbolicregression_jl_tpu_torch/
   scripts/``), their functions called in this process on cuda:0, at the
   JAX smokes' sizes. (a) ``debug_checks_smoke`` on both schedulers with
   ``SR_DEBUG_CHECKS=1`` for this step only: the verifier
   (``analysis.ir_verify.verify_flat_trees``, counted through the module
   attribute every gated site calls) runs at the lockstep scorer and at
   both engine decode sites and raises nothing; then a checkpoint and a
   resume. (b) ``serve_smoke`` whole: two tenants at ``default_quota=4``,
   a deadline that expires in the queue, a preemption and resume (the
   low job held at its first iteration boundary until the preempting one
   is queued), the warm-hit ratio. (c) ``fleet_smoke``'s cancel mid-fleet:
   four lanes, lane 1 cancelled while the fleet is held at a boundary,
   the survivors bit for bit their solo runs. (d) ``fault_smoke``'s
   ``serve`` cycle: a journaled server child under ``worker_crash@0``
   (the supervisor restarts its worker), SIGKILLed mid-batch and recovered
   on the same journal with no job lost or duplicated and the running job
   resumed bit-exactly; ``job_exception`` retried to DONE and escalated
   to QUARANTINED. (e) ``fault_smoke``'s ``exchange`` cycle: two children
   joined by ``initialize`` on the one card, each recording the other dead
   under ``exchange_timeout@1`` and finishing solo. Path ``drills`` (this
   process's launches; the children of (d) and (e) are not counted).
18. ``native``, the port's C tree flattening (``native/srcore.c``, taken
   by ``ops/flat.flatten_trees`` for f32 and by ``FlatSlab.set_trees``) on
   the card's host. (a) The compiler, flags and include directory (Python.h
   must be there), the library the run's first flatten built or loaded and
   a fresh build of the same source into a temporary directory, timed. (e)
   config3 lockstep, 1 x NATIVE_LOCKSTEP_CYCLES cycles with constant
   optimization off, seed 0, four times: with the C flatten, the plain one
   (``flatten_trees_plain``), the plain one, the C one, patched into the
   scorer and const-opt modules; per run ms per cycle and the flatten's
   host ms per cycle and at set-up; the four halls of fame (strings, loss
   bits) and num_evals identical. (b) C against plain, every array as
   bytes, and ``FlatSlab.set_trees`` against its ``set_tree`` loop and
   ``pack_programs_fused``, on a config3 population of 10,000 trees, the
   largest batch (e)'s first run flattened in a cycle, and graph-node DAGs
   with constants of +-1e39, +-inf, NaN, -0.0 and 1e-45. (c)
   ``interp_cuda.make_packed_loss_fn`` on the population's slab x 10,000
   rows, one B1 launch, bit for bit ``fused_loss`` on the packed batch. (d)
   host ms per call, median and range of 20, C and plain, at the cycle's
   batch and at 10,000 trees, and the slab's ``set_trees`` against its
   ``set_tree`` loop. Paths ``native`` ((c)) and ``native lockstep``
   ((e)'s four runs).

Every launch count in the kernels line is measured: each path sets the
counts of B1-B4 and B2v to 0 just before it runs and reads all five just
after (``zero_launches``, ``read_launches``); launches that hold a kernel
against its plain version are not counted. Beside each kernel's
``max_abs_err``, ``max_tol_ratio`` is the worst error of the same checks as
a share of that check's own tolerance (atol + rtol |ref| for losses and
block fields; rtol |ref| + 1e-6 x the tree's largest gradient for
gradients): at most 1, since every check passed.

The last lines are the kernels JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` (``count`` is the number of cards the
run used: 1). Without a CUDA card, or without the
port beside this file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

# config3 (the reference benchmark-suite configuration the repo measures):
# 10k rows x 5 features, binary + - * /, unary cos exp abs, L2, 100 x 100,
# maxsize 20. Only depth is cut: one iteration of CONFIG3_CYCLES cycles
# (the configuration's ncycles_per_iteration is 550).
CONFIG3_ROWS, CONFIG3_FEATURES = 10_000, 5
CONFIG3_CYCLES = 100
CONFIG3_OPS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"])
# the device engine at config3 width: depth cut to ENGINE_ITERATIONS
# iterations of ENGINE_CYCLES cycles (the configuration's 550)
ENGINE_ITERATIONS, ENGINE_CYCLES = 3, 100
# B1 is timed at the lockstep scoring shape and at the device engine's
# constant-optimization shape (K*S = 1,400 x 3 instances); B3's row sweep
# times the same config3 block at these widths: the fitted intercept is the
# per-cycle cost that does not scale with rows, the slope the scoring
B1_TIMED_P = (1024, 4200)
# B2 (P programs, rows) at the engine's constant-optimization shape and at a
# minibatch of the default batch_size (50 rows)
B2_TIMED = ((4200, CONFIG3_ROWS), (1024, 50))
B3_SWEEP_ROWS = (256, 2500, 10_000)
# README quick start: 200 x 2, + - *, cos; README budget is 20 iterations,
# cut to QUICKSTART_ITERATIONS (lockstep) and DEVICE_QUICKSTART_ITERATIONS
# (each of the two device-engine runs) to fit the time limit.
QUICKSTART_ITERATIONS = 6
DEVICE_QUICKSTART_ITERATIONS = 3
# the resume phase's lockstep runs: the quick start's size (200 x 2, 15 x 33)
# at RESUME_ITERATIONS iterations of RESUME_CYCLES cycles
RESUME_ITERATIONS, RESUME_CYCLES = 3, 10
# the fleet phase's kernel check: lanes of one lane-axis launch
FLEET_CHECK_LANES = 3
# phase 13 (features), cut in depth only, to keep the phase under 90 s: the
# lockstep runs of (b) and (c) at config3 width take 1 iteration of
# FEATURES_LOCKSTEP_CYCLES cycles (of the 550; at phase 4's 100 the phase
# took 96 s on one host); (d)'s complex search stops at JAX's 1e-2 bar or
# after COMPLEX_ITERATIONS iterations (seed COMPLEX_SEED)
FEATURES_LOCKSTEP_CYCLES = 50
COMPLEX_ITERATIONS, COMPLEX_SEED = 8, 0
# phase 14 (scale_out), cut in depth only: (b) the elastic drill runs
# ELASTIC_ITERATIONS x ELASTIC_CYCLES (of 550 cycles) with rank 1 killed at
# ELASTIC_KILL_AT and the survivor paced ELASTIC_PACE_MS a post, so that a
# restart lands mid-run; (c) the async scheduler runs 1 x ASYNC_CYCLES; (d)
# the row-sharded loss on ROWS_SHARDED rows (BASELINE.json config 5's
# scale), the data_sharding lockstep check 1 x ROWS_LOCKSTEP_CYCLES
ELASTIC_ITERATIONS, ELASTIC_CYCLES, ELASTIC_KILL_AT = 20, 20, 2
ELASTIC_PACE_MS, ELASTIC_KV_TIMEOUT_MS = 300, 5000
ASYNC_CYCLES = 10
ROWS_SHARDED, ROWS_LOCKSTEP_CYCLES = 1_000_000, 3
# phase 18 (native): config3 lockstep, 1 x NATIVE_LOCKSTEP_CYCLES (of 550),
# run four times with constant optimization off (its ~16 s a run does not
# depend on the cycles), to keep the phase under 60 s
NATIVE_LOCKSTEP_CYCLES = 20

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the port package beside this script (its lint and its sync census)
PORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "symbolicregression_jl_tpu_torch")

# tolerances of the kernel check: kernel and plain version compute the same
# f32 elementwise values; sums are f64 in both, in different orders
RTOL, ATOL = 1e-5, 1e-6
# B2's constant gradients: rtol, plus this factor times the largest finite
# gradient of the same tree (a sum over rows that cancels is held to its
# tree's scale); non-finite positions must be equal
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-4, 1e-6


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _jax_imported():
    """Whether this process imported jax or anything of the JAX package."""
    return any(m in ("jax", "symbolicregression_jl_tpu")
               or m.startswith(("jax.", "symbolicregression_jl_tpu.")) for m in sys.modules)


def config3_data(n_rows=CONFIG3_ROWS, n_features=CONFIG3_FEATURES, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_features, n_rows)).astype(np.float32)
    y = (
        np.cos(2.13 * X[0]) + 0.5 * X[1] * np.abs(X[2]) ** 0.9 - 0.3 * np.abs(X[3]) ** 1.5
    ).astype(np.float32)
    return X, y


def random_programs(opset, n_trees, max_nodes, n_features, seed, max_len=10):
    """A packed batch of random trees over ``opset`` (numpy; fresh copies of
    a batch made once per argument tuple)."""
    prog, vals = _random_programs(opset, n_trees, max_nodes, n_features, seed, max_len)
    return prog.copy(), vals.copy()


@functools.lru_cache(maxsize=None)
def _random_programs(opset, n_trees, max_nodes, n_features, seed, max_len):
    import numpy as np

    from symbolicregression_jl_tpu_torch.models.mutation_functions import gen_random_tree
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import pack_programs_fused

    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        t = gen_random_tree(int(rng.integers(1, max_len + 1)), opset, n_features, rng)
        if t.count_nodes() <= max_nodes:
            trees.append(t)
    return pack_programs_fused(flatten_trees(trees, max_nodes), opset)


def time_ms(fn, warmup=3, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_time_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() queued behind a sleeping
    kernel, so that the host's part (the wrapper's Python) is hidden: the
    device time alone."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)  # ~2.5 ms: the host enqueues the launch meanwhile
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Err(float):
    """A check's max abs error that carries ``ratio``, its worst error as a
    share of its own tolerance (at most 1 when the check passed): the
    kernels line's ``max_tol_ratio``."""

    def __new__(cls, err, ratio=0.0):
        out = float.__new__(cls, err)
        out.ratio = float(ratio)
        return out


def worst_err(*errs):
    """The largest abs error of several checks, carrying their worst ratio."""
    return Err(max(float(e) for e in errs), max(getattr(e, "ratio", 0.0) for e in errs))


def _tol_ratio(err, lim):
    """max(err / lim) over the checked positions (0 / 0 counts 0)."""
    import torch

    if not err.numel():
        return 0.0
    r = torch.where(lim > 0, err / torch.where(lim > 0, lim, 1.0),
                    torch.where(err > 0, torch.inf, 0.0))
    return float(r.max())


def compare(name, got, ref, atol=ATOL):
    """Max abs error over finite losses (an ``Err``); raises on a mismatch of
    the ok flags or an error above atol + RTOL * |ref|."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    fin_g, fin_r = torch.isfinite(got), torch.isfinite(ref)
    if not torch.equal(fin_g, fin_r):
        bad = torch.nonzero(fin_g != fin_r).flatten()[:5].tolist()
        _fail(f"{name}: ok flags differ at trees {bad}")
    if not bool(fin_r.any()):
        return Err(0.0)
    err = (got[fin_r] - ref[fin_r]).abs()
    lim = atol + RTOL * ref[fin_r].abs()
    if bool((err > lim).any()):
        k = int(torch.argmax(err - lim))
        _fail(f"{name}: loss {got[fin_r][k]:.9g} vs plain {ref[fin_r][k]:.9g}")
    return Err(float(err.max()), _tol_ratio(err, lim))


def compare_grads(name, got, ref):
    """Max abs error over finite gradients (an ``Err``); raises on unequal non-finite
    positions or an error above GRAD_RTOL * |ref| + GRAD_SCALE_ATOL * (the
    largest finite |ref| of the same tree)."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    for what, fn in (("NaN", torch.isnan), ("inf", torch.isinf)):
        if not torch.equal(fn(got), fn(ref)):
            bad = torch.nonzero(fn(got) != fn(ref))[:5].tolist()
            _fail(f"{name}: {what} positions differ at (tree, slot) {bad}")
    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0.0).amax(dim=1, keepdim=True)
    err = torch.where(fin, (got - ref).abs(), 0.0)
    lim = GRAD_RTOL * ref.abs() + GRAD_SCALE_ATOL * scale
    if bool((fin & (err > lim)).any()):
        k = tuple(torch.nonzero(fin & (err > lim))[0].tolist())
        _fail(f"{name}: gradient {got[k]:.9g} vs plain {ref[k]:.9g} at (tree, slot) {k}")
    return Err(float(err.max()) if err.numel() else 0.0, _tol_ratio(err[fin], lim[fin]))


def kernel_check(device):
    """Phase 2. Returns the kernel record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_reference
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    w = torch.from_numpy(
        np.random.default_rng(1).uniform(0.1, 2.0, CONFIG3_ROWS).astype(np.float32)
    ).to(device)
    l2 = L.L2DistLoss
    max_err = 0.0
    n_cases = 0

    def check(tag, prog_np, vals_np, Xc, yc, wc, ops, loss, atol=ATOL):
        nonlocal max_err, n_cases
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        got = fused_loss(prog, vals, Xc, yc, wc, ops, loss)
        ref = fused_loss_reference(prog, vals, Xc, yc, wc, ops, loss)
        torch.cuda.synchronize()
        max_err = worst_err(max_err, compare(tag, got, ref, atol))
        n_cases += 1

    # main shapes: full data, unweighted and weighted
    for P in (16, 256, 1024):
        prog, vals = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
        check(f"config3 P={P}", prog, vals, X, y, None, opset, l2)
        check(f"config3 P={P} weighted", prog, vals, X, y, w, opset, l2)
    # minibatches (with-replacement row indices, as BatchScorer draws them)
    prog, vals = random_programs(opset, 1024, N, CONFIG3_FEATURES, seed=7)
    for Rb in (50, 2048):
        idx = torch.from_numpy(
            np.random.default_rng(Rb).integers(0, CONFIG3_ROWS, Rb)
        ).to(device)
        check(f"minibatch R={Rb}", prog, vals, X[:, idx].contiguous(), y[idx].contiguous(),
              None, opset, l2)
        check(f"minibatch R={Rb} weighted", prog, vals, X[:, idx].contiguous(),
              y[idx].contiguous(), w[idx].contiguous(), opset, l2)
    # a corpus touching every built-in operator
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    prog_a, vals_a = random_programs(all_ops, 2048, N, CONFIG3_FEATURES, seed=11)
    codes = set(np.unique(prog_a[:, :N]).tolist())
    missing = set(range(2, 2 + all_ops.n_unary + all_ops.n_binary)) - codes
    if missing:
        _fail(f"operator corpus misses codes {sorted(missing)}")
    check("every operator", prog_a, vals_a, X, y, None, all_ops, l2)
    check("every operator weighted", prog_a, vals_a, X, y, w, all_ops, l2)
    # every built-in real loss at one small shape: shallow + - * trees on
    # rows in [-1, 1] keep predictions moderate, so the comparison tests the
    # loss code and not the conditioning of exp/sin at huge arguments
    rng = np.random.default_rng(5)
    Xs = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32)).to(device)
    ys = torch.from_numpy(np.sign(rng.uniform(-1, 1, 257)).astype(np.float32)).to(device)
    ws = torch.from_numpy(rng.uniform(0.1, 2.0, 257).astype(np.float32)).to(device)
    small_ops = resolve_operators(["add", "sub", "mult"], [])
    prog_s, vals_s = random_programs(small_ops, 64, N, 3, seed=13, max_len=4)
    zoo = dict(L.LOSSES)
    for spec in ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)",
                 "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)"):
        zoo[spec] = L.resolve_loss(spec)
    for name, loss in zoo.items():
        # a ZeroOne decision flips when an f32 prediction sits on the boundary:
        # allow one row's weight of difference
        atol = float(ws.max() / ws.sum()) if name == "ZeroOneLoss" else ATOL
        check(f"loss {name}", prog_s, vals_s, Xs, ys, None, small_ops, loss, atol)
        check(f"loss {name} weighted", prog_s, vals_s, Xs, ys, ws, small_ops, loss, atol)
    print(f"kernel check: {n_cases} cases, max abs err {max_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL})", flush=True)

    # timing at the lockstep scoring shape (1024 candidates x 10k rows) and
    # at the device engine's constant-optimization shape (K*S = 4,200)
    t1024, t4200 = (b1_timing(device, P, plain=P == 1024) for P in B1_TIMED_P)
    return {
        "name": "fused_loss",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:258",
        "max_abs_err": max_err,
        "ms": t1024["ms"],
        "plain_ms": t1024["plain_ms"],
        "bound_ms": t1024["bound_ms"],
        "bound_by": t1024["bound_by"],
        "library_ms": None,
        "ms_p4200": t4200["ms"],
    }


def b1_timing(device, P, plain=False):
    """B1 on P random config3 programs (seed P) x 10k rows, unweighted: the
    median kernel ms (as ``time_ms`` takes it, the wrapper's host time
    included) and the device's alone (``device_time_ms``), slot evaluations
    per second, the bound and, with ``plain``, the plain version's ms.
    Timing launches are not counted."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_reference, optab_tensor, work_counts,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    l2 = L.L2DistLoss
    # the operator table uploaded once, as a search's scorer holds it
    tab = optab_tensor(opset, device)
    saved = fused_loss.launches
    ms = time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, l2, tab))
    dev_ms = device_time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, l2, tab))
    plain_ms = (time_ms(lambda: fused_loss_reference(prog, vals, X, y, None, opset, l2),
                        warmup=1, reps=20) if plain else None)
    fused_loss.launches = saved  # timing launches are not the main path's
    work = work_counts(prog_np, CONFIG3_ROWS, CONFIG3_FEATURES, weighted=False)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"fused_loss timing (P={P}, R={CONFIG3_ROWS}, N={N}): kernel {ms:.4f} ms (device "
          f"alone {dev_ms:.4f} ms)" + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms, slot evals {work['slot_evals']}, "
          f"{rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def main_path(device, cycles=CONFIG3_CYCLES, rows=CONFIG3_ROWS, populations=100,
              population_size=100):
    """Phase 4: lockstep equation_search at config3 width. Host clocks time
    the evolution cycles and the constant optimization; CUDA events around
    every kernel call sum the kernel's device time on the path. Returns the
    launches of B1 and B2 in the run, and the ms per cycle and evals/s."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
    import symbolicregression_jl_tpu_torch.search as search_mod
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss

    X, y = config3_data(n_rows=rows)
    options = Options(
        populations=populations, population_size=population_size, maxsize=20,
        ncycles_per_iteration=cycles, seed=0, save_to_file=False, progress=False,
        device=str(device), **CONFIG3_OPS,
    )
    spent = {"s_r_cycle_lockstep": 0.0, "optimize_and_simplify_populations": 0.0}
    saved = {name: getattr(search_mod, name) for name in spent}
    events = []

    def host_timed(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    def device_timed(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fused_loss(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    for name in spent:
        setattr(search_mod, name, host_timed(name))
    scorer_mod.fused_loss = device_timed
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=1, verbosity=0)
        wall = time.perf_counter() - t0
        counts = read_launches()
    finally:
        for name, fn in saved.items():
            setattr(search_mod, name, fn)
        scorer_mod.fused_loss = fused_loss
    launches = counts[0]
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) * 1e-3
    if not res.use_kernel:
        _fail("config3 scorer did not select the fused loss kernel")
    if launches != res.scoring_dispatches or launches == 0:
        _fail(f"{launches} kernel launches for {res.scoring_dispatches} scoring dispatches")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("config3 frontier is empty or not finite")
    best = min(m.loss for m in front)
    cycle_s = spent["s_r_cycle_lockstep"]
    const_s = spent["optimize_and_simplify_populations"]
    print(f"config3 lockstep: {populations}x{population_size}, {rows} rows, 1 iteration x "
          f"{cycles} cycles (cut from 550): wall {wall:.3f} s (set-up "
          f"{wall - res.iteration_seconds:.3f} s, main loop {res.iteration_seconds:.3f} s), "
          f"cycles {cycle_s:.3f} s = {cycle_s / cycles * 1e3:.2f} ms/cycle, "
          f"const-opt+simplify {const_s:.3f} s, "
          f"{res.num_evals / res.iteration_seconds:.4g} evals/s, "
          f"{launches} kernel launches = {res.scoring_dispatches} scoring dispatches, "
          f"kernel device time {kernel_s:.4f} s ({kernel_s / wall:.3%} of wall), "
          f"frontier {len(front)} members, best loss {best:.6g}", flush=True)
    return counts, {"ms_per_cycle": cycle_s / cycles * 1e3,
                    "evals_per_s": res.num_evals / res.iteration_seconds}


def quick_start(device, niterations=QUICKSTART_ITERATIONS):
    """Phase 6a: README quick start through SRRegressor (lockstep)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import SRRegressor

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    t0 = time.perf_counter()
    model = SRRegressor(
        niterations=niterations, binary_operators=["+", "-", "*"],
        unary_operators=["cos"], seed=0, save_to_file=False, progress=False,
        device=str(device),
    )
    model.fit(X, y)
    wall = time.perf_counter() - t0
    rows = model.equations_
    best = min(rows, key=lambda r: r["loss"])
    baseline = float(np.mean((y - y.mean()) ** 2))
    pred = model.predict(X)
    if not np.all(np.isfinite(pred)) or pred.shape != y.shape:
        _fail("quick start predictions are not finite")
    if not best["loss"] < baseline:
        _fail(f"quick start best loss {best['loss']} not below baseline {baseline}")
    print(f"quick start: {niterations} iterations (README: 20) in {wall:.3f} s, best loss "
          f"{best['loss']:.6g} (mean predictor {baseline:.6g}): {best['equation']}",
          flush=True)


def grad_kernel_check(device, n_instances=4200):
    """Phase 3: B2 against its plain version. Returns its record (without
    launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    w = torch.from_numpy(
        np.random.default_rng(1).uniform(0.1, 2.0, CONFIG3_ROWS).astype(np.float32)
    ).to(device)
    errs = {"loss": 0.0, "grad": 0.0}
    n_cases = 0

    def check(tag, prog_np, vals_np, Xc, yc, wc, ops, loss, atol=ATOL):
        nonlocal n_cases
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        lk, gk = fused_loss_grad(prog, vals, Xc, yc, wc, ops, loss)
        lr, gr = fused_loss_grad_reference(prog, vals, Xc, yc, wc, ops, loss)
        b1 = fused_loss(prog, vals, Xc, yc, wc, ops, loss)
        torch.cuda.synchronize()
        errs["loss"] = worst_err(errs["loss"], compare(tag, lk, lr, atol),
                                 compare(tag + " (B2 vs B1 losses)", lk, b1, atol))
        errs["grad"] = worst_err(errs["grad"], compare_grads(tag, gk, gr))
        n_cases += 1

    # the engine's shape: K*S instances x 10k rows, plain and weighted
    prog, vals = random_programs(opset, n_instances, N, CONFIG3_FEATURES, seed=4200)
    check(f"engine shape P={n_instances}", prog, vals, X, y, None, opset, L.L2DistLoss)
    check(f"engine shape P={n_instances} weighted", prog, vals, X, y, w, opset, L.L2DistLoss)
    # a minibatch of the default batch_size
    idx = torch.from_numpy(np.random.default_rng(50).integers(0, CONFIG3_ROWS, 50)).to(device)
    prog_m, vals_m = random_programs(opset, 1024, N, CONFIG3_FEATURES, seed=8)
    check("minibatch R=50", prog_m, vals_m, X[:, idx].contiguous(), y[idx].contiguous(),
          None, opset, L.L2DistLoss)
    check("minibatch R=50 weighted", prog_m, vals_m, X[:, idx].contiguous(),
          y[idx].contiguous(), w[idx].contiguous(), opset, L.L2DistLoss)
    # a corpus touching every built-in operator, on B1's corpus data
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    prog_a, vals_a = random_programs(all_ops, 2048, N, CONFIG3_FEATURES, seed=11)
    codes = set(np.unique(prog_a[:, :N]).tolist())
    missing = set(range(2, 2 + all_ops.n_unary + all_ops.n_binary)) - codes
    if missing:
        _fail(f"operator corpus misses codes {sorted(missing)}")
    check("every operator", prog_a, vals_a, X, y, None, all_ops, L.L2DistLoss)
    check("every operator weighted", prog_a, vals_a, X, y, w, all_ops, L.L2DistLoss)
    # every built-in real loss at a small shape
    rng = np.random.default_rng(5)
    Xs = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32)).to(device)
    ys = torch.from_numpy(np.sign(rng.uniform(-1, 1, 257)).astype(np.float32)).to(device)
    ws = torch.from_numpy(rng.uniform(0.1, 2.0, 257).astype(np.float32)).to(device)
    small_ops = resolve_operators(["add", "sub", "mult"], [])
    prog_s, vals_s = random_programs(small_ops, 64, N, 3, seed=13, max_len=4)
    zoo = dict(L.LOSSES)
    for spec in ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)",
                 "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)"):
        zoo[spec] = L.resolve_loss(spec)
    for name, loss in zoo.items():
        atol = float(ws.max() / ws.sum()) if name == "ZeroOneLoss" else ATOL
        check(f"loss {name}", prog_s, vals_s, Xs, ys, None, small_ops, loss, atol)
        check(f"loss {name} weighted", prog_s, vals_s, Xs, ys, ws, small_ops, loss, atol)
    # two launches on the same inputs give identical bits: the engine's shape
    # (row chunks and the finalize kernel) and the minibatch (several trees
    # per block)
    for tag, p_np, v_np, Xc, yc, wc in (
            ("engine shape", prog, vals, X, y, w),
            ("minibatch R=50", prog_m, vals_m, X[:, idx].contiguous(), y[idx].contiguous(),
             w[idx].contiguous())):
        pt, vt = torch.from_numpy(p_np).to(device), torch.from_numpy(v_np).to(device)
        first = fused_loss_grad(pt, vt, Xc, yc, wc, opset, L.L2DistLoss)
        again = fused_loss_grad(pt, vt, Xc, yc, wc, opset, L.L2DistLoss)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again)):
            _fail(f"B2 {tag}: two launches on the same inputs differ")
    # rows that are not stack-sound score inf with zero gradients; the
    # batch's other rows keep the plain version's values
    bad, rows = unsound_rows(prog_m, opset)
    pt, vt = torch.from_numpy(bad).to(device), torch.from_numpy(vals_m).to(device)
    lk, gk = fused_loss_grad(pt, vt, X, y, None, opset, L.L2DistLoss)
    lr, gr = fused_loss_grad_reference(torch.from_numpy(prog_m).to(device), vt, X, y, None,
                                       opset, L.L2DistLoss)
    torch.cuda.synchronize()
    if not (bool(torch.isinf(lk[rows]).all()) and bool((gk[rows] == 0).all())):
        _fail(f"B2 on unsound rows {rows}: losses {lk[rows].tolist()}, not inf with zero "
              "gradients")
    keep = torch.ones(len(bad), dtype=torch.bool, device=device)
    keep[rows] = False
    compare("unsound batch, other rows", lk[keep], lr[keep])
    compare_grads("unsound batch, other rows", gk[keep], gr[keep])
    print(f"grad kernel check: {n_cases} cases, max abs err losses {errs['loss']:.3e}, "
          f"gradients {errs['grad']:.3e} (losses rtol {RTOL}, atol {ATOL}; gradients rtol "
          f"{GRAD_RTOL} + {GRAD_SCALE_ATOL} x tree scale); two launches bit-identical at the "
          f"engine shape and R=50; unsound rows {rows} inf with zero gradients", flush=True)

    # timing at the engine's shape and at a minibatch of the default batch_size
    t = b2_timing(device, n_instances, CONFIG3_ROWS, plain=True)
    for P, rows in B2_TIMED[1:]:
        b2_timing(device, P, rows)
    return {
        "name": "fused_loss_grad",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss_grad.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:725",
        "max_abs_err": worst_err(*errs.values()),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def unsound_rows(prog, opset):
    """A copy of a packed batch (numpy) with two rows made not stack-sound:
    the first binary-rooted row's root children swapped, the second's root
    cut off. Returns (copy, [the two rows])."""
    import numpy as np

    N = (prog.shape[1] - 1) // 4
    length = prog[:, 4 * N]
    root = prog[np.arange(len(prog)), np.maximum(length - 1, 0)]
    a, b = np.nonzero((length > 1) & (root >= 2 + opset.n_unary))[0][:2].tolist()
    bad = prog.copy()
    i = length[a] - 1
    bad[a, N + i], bad[a, 2 * N + i] = prog[a, 2 * N + i], prog[a, N + i]
    bad[b, 4 * N] = length[b] - 1
    return bad, [a, b]


def b2_timing(device, P, rows, plain=False):
    """B2 on P random config3 programs (seed P), unweighted, on config3's
    10k rows or, for fewer ``rows``, on a minibatch of them drawn with
    replacement (seed ``rows``), as the engine's batching draws them: the
    median kernel ms (as ``time_ms`` takes it, the wrapper's host time
    included) and the device's alone (``device_time_ms``), slot evaluations
    (forward + reverse) per second, the bound and, with ``plain``, the plain
    version's ms. Timing launches are not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss_grad, fused_loss_grad_reference, grad_work_counts, optab_tensor,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    if rows < CONFIG3_ROWS:
        idx = np.random.default_rng(rows).integers(0, CONFIG3_ROWS, rows)
        Xn, yn = np.ascontiguousarray(Xn[:, idx]), np.ascontiguousarray(yn[idx])
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    l2 = L.L2DistLoss
    tab = optab_tensor(opset, device)  # once, as a search's scorer holds it
    saved = fused_loss_grad.launches
    ms = time_ms(lambda: fused_loss_grad(prog, vals, X, y, None, opset, l2, tab))
    dev_ms = device_time_ms(lambda: fused_loss_grad(prog, vals, X, y, None, opset, l2, tab))
    plain_ms = (time_ms(lambda: fused_loss_grad_reference(prog, vals, X, y, None, opset, l2),
                        warmup=1, reps=20) if plain else None)
    fused_loss_grad.launches = saved  # timing launches are not the main path's
    work = grad_work_counts(prog_np, rows, CONFIG3_FEATURES, weighted=False)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"fused_loss_grad timing (P={P}, R={rows}, N={N}): kernel {ms:.4f} ms (device alone "
          f"{dev_ms:.4f} ms)" + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms, slot evals (forward + reverse) "
          f"{work['slot_evals']}, {rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "rows": rows, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def block_setup(device, options, X, y, w, n_islands, ncycles, seed=0):
    """The evolve block's inputs at ``options``' widths: a packed population
    of random trees scored by B1, a size-frequency snapshot with ties and
    uneven weights, births with ties, and the scalars on the card. Returns
    (cfg, pop, scalars) with scalars = (fnorm, seed, step0, curmaxsize,
    norm)."""
    import dataclasses

    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config
    from symbolicregression_jl_tpu_torch.ops.evolve_block import pack_state_words
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, unpack_programs_fused,
    )

    F, R = X.shape
    cfg = build_evo_config(options, n_features=F, baseline_loss=1.0, use_baseline=True,
                           niterations=1, n_islands=n_islands, n_rows=R)
    cfg = dataclasses.replace(cfg, ncycles=ncycles)
    I, P, N, S1 = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    opset = options.operators
    prog_np, vals_np = random_programs(opset, I * P, N, F, seed=seed, max_len=10)
    flat = unpack_programs_fused(prog_np, vals_np, opset)
    kind, op, feat, val = (torch.from_numpy(np.asarray(a)).to(device)
                           for a in (flat.kind, flat.op, flat.feat, flat.val))
    words, consts = pack_state_words(kind, op, feat, val)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    loss = fused_loss(prog, vals, X, y, w, opset, options.loss).reshape(I, P)
    length = torch.from_numpy(np.asarray(flat.length, np.int32)).to(device).reshape(I, P)
    rng = np.random.default_rng(seed)
    norm = torch.full((), float(np.float32(max(float(y.double().var()), 0.01))),
                      dtype=torch.float32, device=device)
    score = loss / norm + length.to(torch.float32) * cfg.parsimony
    birth = torch.from_numpy(rng.integers(0, P // 2, (I, P)).astype(np.int32)).to(device)
    fnorm = torch.from_numpy(rng.dirichlet(np.ones(S1) * 0.5).astype(np.float32)).to(device)
    pop = (words.reshape(I, P, N).contiguous(), consts.reshape(I, P, N).contiguous(),
           length.contiguous(), loss.contiguous(), score.contiguous(), birth)
    scalars = (fnorm, torch.tensor(0x9E3779B1 ^ seed, dtype=torch.int64, device=device),
               torch.tensor(P, dtype=torch.int32, device=device),
               torch.tensor(cfg.maxsize, dtype=torch.int32, device=device), norm)
    return cfg, pop, scalars


def compare_block(tag, got, ref):
    """Integer outputs equal, float outputs within RTOL/ATOL with equal
    non-finite positions; on a mismatch name the island and the field.
    Returns the largest abs error of the float fields (an ``Err``)."""
    import torch

    from symbolicregression_jl_tpu_torch.convert import BLOCK_FIELDS

    err = ratio = 0.0
    for name, g, r in zip(BLOCK_FIELDS, got, ref):
        g, r = g.cpu(), r.cpu()
        if not r.dtype.is_floating_point:
            bad = (g != r).reshape(g.shape[0], -1).any(1)
        else:
            g64, r64 = g.double(), r.double()
            fin = torch.isfinite(r64)
            diff = torch.where(fin, (g64 - r64).abs(), 0.0)
            lim = ATOL + RTOL * r64.abs()
            over = fin & (diff > lim)
            nonfin = (torch.isnan(g64) != torch.isnan(r64)) | (torch.isinf(g64) != torch.isinf(r64))
            nonfin |= torch.isinf(g64) & torch.isinf(r64) & (torch.sign(g64) != torch.sign(r64))
            bad = (over | nonfin).reshape(g.shape[0], -1).any(1)
            if diff.numel():
                err = max(err, float(diff.max()))
                ratio = max(ratio, _tol_ratio(diff[fin], lim[fin]))
        if bool(bad.any()):
            isl = int(torch.nonzero(bad)[0])
            _fail(f"{tag}: field {name} differs from the plain version on island {isl} "
                  f"({int(bad.sum())} islands)")
    return Err(err, ratio)


def block_kernel_check(device, islands=100, rows=CONFIG3_ROWS):
    """Phase 3: B3 against its plain version on the card, at config3 width
    (``islands`` x 100 members, ``rows`` rows). Integer equality needs
    bit-identical scores, which rest on every built-in operator alone giving
    equal values (operator_isolation). Returns the record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.analysis.ir_verify import verify_packed_programs
    from symbolicregression_jl_tpu_torch.convert import BLOCK_FIELDS
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.evolve_block import unpack_pointers
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees, PackedPrograms
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, pack_programs_fused
    from symbolicregression_jl_tpu_torch.ops.operators import BINARY_OPS, UNARY_OPS

    Xn, yn = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    c3 = Options(maxsize=20, populations=islands, population_size=100, device=str(device),
                 **CONFIG3_OPS)
    max_err = 0.0
    n_cases = 0

    def check(tag, options, Xc, yc, wc, n_islands, cycles=(1, 8), seed=0, flood=None):
        nonlocal max_err, n_cases
        for ncyc in cycles:
            cfg, pop, scal = block_setup(device, options, Xc, yc, wc, n_islands, ncyc, seed)
            if flood is not None:
                # what a nan_flood fault leaves: the losses of the leading
                # islands NaN, and a third of their scores (the NaN members
                # the const-opt leg tuned)
                k = max(1, int(round(n_islands * flood)))
                loss, score = pop[3].clone(), pop[4].clone()
                loss[:k] = float("nan")
                score[:k, ::3] = float("nan")
                pop = pop[:3] + (loss, score) + pop[5:]
            args = (*pop, *scal, Xc, yc, wc, cfg, options.operators, options.loss)
            got = evolve_block(*args)
            ref = evolve_block_reference(*args)
            torch.cuda.synchronize()
            max_err = worst_err(max_err, compare_block(f"{tag}, {ncyc} cycles", got, ref))
            n_cases += 1

    # (a) config3 width: 100 islands x 100 members, 10k rows x 5 features;
    # and after a nan_flood fault over 75% of the islands
    check("config3", c3, X, y, None, islands)
    check("config3 nan_flood", c3, X, y, None, islands, seed=5, flood=0.75)
    # (c) the quick-start shape, weighted and unweighted; the all-operator
    # corpus; every built-in real loss at a small shape
    rng = np.random.default_rng(0)
    Xq = torch.from_numpy(rng.normal(size=(2, 200)).astype(np.float32)).to(device)
    yq = 2 * torch.cos(Xq[1]) + Xq[0] ** 2 - 2
    wq = torch.from_numpy(rng.uniform(0.5, 2.0, 200).astype(np.float32)).to(device)
    qs = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], device=str(device))
    check("quick start", qs, Xq, yq, None, qs.populations)
    check("quick start weighted", qs, Xq, yq, wq, qs.populations)
    all_ops = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                      maxsize=20, populations=islands // 5, population_size=100,
                      device=str(device))
    check("every operator", all_ops, X, y, None, islands // 5, seed=11)
    Xs = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32)).to(device)
    ys = torch.from_numpy(np.sign(rng.uniform(-1, 1, 257)).astype(np.float32)).to(device)
    ws = torch.from_numpy(rng.uniform(0.1, 2.0, 257).astype(np.float32)).to(device)
    zoo = dict(L.LOSSES)
    for spec in ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)",
                 "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)"):
        zoo[spec] = L.resolve_loss(spec)
    for name, loss in zoo.items():
        lo = Options(binary_operators=["add", "sub", "mult"], unary_operators=[],
                     elementwise_loss=loss,
                     populations=4, population_size=16, maxsize=12, device=str(device))
        check(f"loss {name}", lo, Xs, ys, ws, 4, cycles=(8,), seed=13)
    print(f"block kernel check: {n_cases} cases equal to the plain version on every integer "
          f"output, max abs err of float outputs {max_err:.3e} (rtol {RTOL}, atol {ATOL}; "
          f"all {len(BINARY_OPS) + len(UNARY_OPS)} operators in the all-operator corpus; "
          f"config3 with 75% of the islands' losses NaN)", flush=True)

    # (b) a whole block of ENGINE_CYCLES cycles at config3 width: the
    # kernel's own consistency
    cfg, pop, scal = block_setup(device, c3, X, y, None, islands, ENGINE_CYCLES, seed=3)
    args = (*pop, *scal, X, y, None, cfg, c3.operators, c3.loss)
    out = evolve_block(*args)
    again = evolve_block(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(BLOCK_FIELDS, out, again):
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b):
            _fail(f"block consistency: two launches differ in {name}")
    I, P, N, S1 = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    words, consts, length, loss, score = (t.cpu() for t in out[:5])
    norm = scal[4]
    if bool((length > cfg.maxsize).any()) or bool((length < 1).any()):
        _fail("block consistency: a length is outside [1, curmaxsize]")
    want_score = (out[3] / norm + out[2].to(torch.float32) * cfg.parsimony).cpu()
    fin = torch.isfinite(score)
    if not torch.equal(fin, torch.isfinite(want_score)) or bool(
            ((score - want_score).abs() > 1e-6 * want_score.abs())[fin].any()):
        _fail("block consistency: a score is not _score_of(loss, length)")

    def b1_of(w_, c_, ln_):
        kind, op, lhs, rhs, feat = (a.cpu().numpy() for a in unpack_pointers(w_, ln_))
        flat = FlatTrees(kind, op, lhs, rhs, feat, c_.cpu().numpy(), ln_.cpu().numpy())
        prog, vals = pack_programs_fused(flat, c3.operators)
        return fused_loss(torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device),
                          X, y, None, c3.operators, c3.loss)

    compare("block consistency: member losses vs B1", loss.reshape(-1),
            b1_of(out[0].reshape(I * P, N), out[1].reshape(I * P, N), out[2].reshape(I * P)))
    bs_fin = torch.isfinite(out[7].reshape(-1))
    if not bool(bs_fin.any()):
        _fail("block consistency: no best-seen entry")
    bw, bc, bl = (t.reshape(I * S1, -1)[bs_fin] for t in (out[8], out[9], out[10][..., None]))
    compare("block consistency: best-seen losses vs B1", out[7].reshape(-1)[bs_fin],
            b1_of(bw, bc, bl[:, 0]))
    for name, (wd, cs, ln) in (("population", (words.reshape(I * P, N), consts.reshape(I * P, N),
                                               length.reshape(I * P))),
                               ("best seen", (bw.cpu(), bc.cpu(), bl[:, 0].cpu()))):
        verify_packed_programs(
            PackedPrograms(wd.numpy().astype(np.int16), cs.numpy(), ln.numpy()), c3.operators,
            n_features=CONFIG3_FEATURES, allow_empty=False, where=f"block {name}: ")
    print(f"block consistency ({ENGINE_CYCLES} cycles, {I} x {P}): losses and best-seen losses "
          f"equal B1's, scores equal _score_of, programs stack-sound with zero pads, lengths "
          f"<= {cfg.maxsize}, two launches bit-identical", flush=True)

    t = b3_timing(device, islands, sweep=tuple(r for r in B3_SWEEP_ROWS if r <= rows))
    return {
        "name": "evolve_block",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/evolve_block.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:1114",
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "ms_per_cycle": t["ms_per_cycle"],
        "row_sweep": t["sweep"],
    }


def b3_timing(device, islands=100, sweep=B3_SWEEP_ROWS, plain=True):
    """B3 timed at config3 width (``islands`` x 100 members) from one seed's
    population: 1 cycle and ENGINE_CYCLES cycles at each row count of
    ``sweep`` (the first rows of config3's data), the per-cycle time
    (ENGINE_CYCLES - 1 cycles' difference) at each, and a least-squares line
    through them: its intercept is the per-cycle cost that does not scale
    with rows (stages 1-2, replacement, histogram, syncs), its slope the
    scoring. The record (1 cycle at the widest sweep, beside the plain
    version with ``plain``, and the bound) is that of the widest sweep.
    Timing launches are not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        block_work_counts, evolve_block, evolve_block_reference,
    )

    Xn, yn = config3_data(n_rows=max(sweep))
    c3 = Options(maxsize=20, populations=islands, population_size=100, device=str(device),
                 **CONFIG3_OPS)
    saved = evolve_block.launches
    points = []
    for rows in sweep:
        X = torch.from_numpy(np.ascontiguousarray(Xn[:, :rows])).to(device)
        y = torch.from_numpy(np.ascontiguousarray(yn[:rows])).to(device)
        runs = {}
        for ncyc in (1, ENGINE_CYCLES):
            cfg, pop, scal = block_setup(device, c3, X, y, None, islands, ncyc, seed=5)
            runs[ncyc] = (cfg, (*pop, *scal, X, y, None, cfg, c3.operators, c3.loss))
        ms1 = time_ms(lambda: evolve_block(*runs[1][1]))
        msk = time_ms(lambda: evolve_block(*runs[ENGINE_CYCLES][1]))
        points.append({"rows": rows, "ms_1": ms1, "ms_k": msk,
                       "ms_per_cycle": (msk - ms1) / (ENGINE_CYCLES - 1)})
    evolve_block.launches = saved
    r = np.array([p["rows"] for p in points], np.float64)
    c = np.array([p["ms_per_cycle"] for p in points], np.float64)
    slope, intercept = np.polyfit(r, c, 1) if len(points) > 1 else (0.0, float("nan"))
    top = points[-1]
    cfg1, args1 = runs[1]
    counts = {}
    evolve_block_reference(*args1, counts=counts)
    plain_ms = time_ms(lambda: evolve_block_reference(*args1), warmup=1, reps=20) if plain else None
    work = block_work_counts(cfg1, top["rows"], CONFIG3_FEATURES, False, counts["candidates"],
                             counts["slots"])
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    for p in points:
        print(f"evolve_block timing (config3: {islands} islands x 100, "
              f"E={cfg1.events_per_cycle}, R={p['rows']}, N={cfg1.n_slots}): 1 cycle "
              f"{p['ms_1']:.4f} ms, {ENGINE_CYCLES} cycles {p['ms_k']:.4f} ms, "
              f"{p['ms_per_cycle']:.4f} ms per cycle", flush=True)
    share = intercept / top["ms_per_cycle"] if top["ms_per_cycle"] > 0 else float("nan")
    print(f"evolve_block row sweep: per-cycle ms = {intercept:.5f} + {slope * 1e3:.5f} x "
          f"(rows / 1000); the intercept is {share:.1%} of a cycle at {top['rows']} rows; "
          + (f"plain 1 cycle {plain_ms:.4f} ms; " if plain else "")
          + f"bound (1 cycle, {counts['candidates']} candidates) "
          f"{max(bound_ops, bound_bytes):.5f} ms", flush=True)
    return {"ms": top["ms_1"], "ms_per_cycle": top["ms_per_cycle"], "plain_ms": plain_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "sweep": {"points": points, "intercept_ms": float(intercept),
                      "slope_ms_per_1k_rows": float(slope * 1e3)}}


def preds_kernel_check(device, rows=CONFIG3_ROWS):
    """Phase 3: B4 (the prediction matrix) against ops/interp.eval_trees at
    1024 trees x ``rows`` rows, every prediction within RTOL/ATOL with equal
    non-finite positions; then ``b4_timing`` at P = 1024. Returns the
    record (without launches)."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_trees_kernel, unpack_programs_fused,
    )
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    Xn, _ = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    N = opts.max_nodes
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    max_err = 0.0
    for tag, ops, seed in (("config3", opts.operators, 1024), ("every operator", all_ops, 11)):
        prog, vals = random_programs(ops, 1024, N, CONFIG3_FEATURES, seed=seed)
        flat = unpack_programs_fused(prog, vals, ops)
        got = eval_trees_kernel(flat, X, ops)
        ref = eval_trees(flat, X, ops)
        torch.cuda.synchronize()
        max_err = worst_err(max_err, compare(f"eval_preds {tag}", got.reshape(-1),
                                             ref.reshape(-1)))
    t = b4_timing(device, 1024, rows, plain=True)
    print(f"eval_preds check: config3 and every-operator corpora (1024 trees x "
          f"{rows} rows) equal eval_trees within rtol {RTOL}, atol {ATOL}, every tree held, "
          f"max abs err {max_err:.3e}", flush=True)
    return {
        "name": "eval_preds",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/eval_preds.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:73",
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def b4_timing(device, P, rows=CONFIG3_ROWS, plain=False):
    """B4 on P random config3 programs (seed P) x ``rows`` rows: the median
    ms of the launch alone (``eval_preds`` on programs already on the card;
    also the device's time alone, ``device_time_ms``), of the entry point (``eval_trees_kernel``, with its host packing and
    upload), the bound and, with ``plain``, the plain version's ms. Timing
    launches are not counted."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_preds, eval_trees_kernel, optab_tensor, preds_work_counts, unpack_programs_fused,
    )

    Xn, _ = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    prog, vals = random_programs(opts.operators, P, opts.max_nodes, CONFIG3_FEATURES, seed=P)
    flat = unpack_programs_fused(prog, vals, opts.operators)
    prog_t, vals_t = torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device)
    tab = optab_tensor(opts.operators, device)  # the entry point below uploads its own
    saved = eval_trees_kernel.launches
    ms = time_ms(lambda: eval_preds(prog_t, vals_t, X, opts.operators, tab))
    dev_ms = device_time_ms(lambda: eval_preds(prog_t, vals_t, X, opts.operators, tab))
    entry_ms = time_ms(lambda: eval_trees_kernel(flat, X, opts.operators))
    plain_ms = (time_ms(lambda: eval_trees(flat, X, opts.operators), warmup=1, reps=20)
                if plain else None)
    eval_trees_kernel.launches = saved
    work = preds_work_counts(prog, rows, CONFIG3_FEATURES)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"eval_preds timing (P={P}, R={rows}): kernel {ms:.4f} ms (programs on the card; "
          f"device alone {dev_ms:.4f} ms), "
          f"entry point {entry_ms:.4f} ms (with host packing and upload)"
          + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms "
          f"({'bytes' if bound_bytes >= bound_ops else 'operations'}), "
          f"{rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "ms": ms, "device_ms": dev_ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def operator_isolation(device, n_rows=10_000, spans=(2.0, 20.0)):
    """Phase 3: one-operator trees (each built-in operator on features drawn
    from U(-a, a), for each a in ``spans``) through B4 and through the plain
    version. Every operator must give equal values on every row (NaN where
    NaN): the kernels' exact comparisons (B3's integer outputs) rest on it.
    Prints the largest relative difference per operator of any that
    differs, and fails."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import eval_trees_kernel
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    nu, nb = ops.n_unary, ops.n_binary
    P, N = nu + nb, 3
    kind = np.zeros((P, N), np.int32)
    op = np.zeros((P, N), np.int32)
    lhs = np.zeros((P, N), np.int32)
    rhs = np.zeros((P, N), np.int32)
    feat = np.zeros((P, N), np.int32)
    length = np.zeros(P, np.int32)
    kind[:, 0] = 2
    kind[:nu, 1], op[:nu, 1], length[:nu] = 3, np.arange(nu), 2
    kind[nu:, 1], feat[nu:, 1] = 2, 1
    kind[nu:, 2], op[nu:, 2], lhs[nu:, 2], rhs[nu:, 2], length[nu:] = 4, np.arange(nb), 0, 1, 3
    flat = FlatTrees(kind, op, lhs, rhs, feat, np.zeros((P, N), np.float32), length)
    names = [o.name for o in ops.unary] + [o.name for o in ops.binary]
    for a in spans:
        X = torch.from_numpy(
            np.random.default_rng(2).uniform(-a, a, (2, n_rows)).astype(np.float32)).to(device)
        got = eval_trees_kernel(flat, X, ops).cpu()
        ref = eval_trees(flat, X, ops).cpu()
        same = (got == ref) | (got.isnan() & ref.isnan())
        bad = []
        for k in torch.nonzero(~same.all(1)).flatten().tolist():
            g, r = got[k].double(), ref[k].double()
            fin = torch.isfinite(g) & torch.isfinite(r)
            rel = ((g - r).abs() / r.abs().clamp_min(1e-30))[fin]
            bad.append(f"{names[k]} ({int((~same[k]).sum())} rows, largest relative difference "
                       f"{float(rel.max()) if rel.numel() else float('nan'):.3g})")
        if bad:
            _fail(f"operator isolation on U(-{a:g}, {a:g}) rows: B4 differs from the plain "
                  f"version in {', '.join(bad)}")
        print(f"operator isolation: all {P} built-in operators alone on {n_rows} rows from "
              f"U(-{a:g}, {a:g}) equal the plain version on every row",
              flush=True)


@contextlib.contextmanager
def engine_block_env(block):
    """SR_ENGINE_BLOCK unset (the default: the block where eligible) or "0"
    (the event leg) inside the context, restored after."""
    saved = os.environ.get("SR_ENGINE_BLOCK")
    if block:
        os.environ.pop("SR_ENGINE_BLOCK", None)
    else:
        os.environ["SR_ENGINE_BLOCK"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("SR_ENGINE_BLOCK", None)
        else:
            os.environ["SR_ENGINE_BLOCK"] = saved


def lint_port():
    """Phase 5, first: the port's own lint (``sr_lint.py``, the torch rule
    set) over the port package, run as a file in a process of its own (it
    imports neither torch nor the port). Every finding must be suppressed on
    its line with a reason; each is printed. Returns the lines that carry an
    SRL003 finding, suppressed or not, as {(real path, line)}: the sync
    census holds the card's syncs to them."""
    import collections

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(PORT_DIR, "scripts", "sr_lint.py"),
                          "--json", "--show-suppressed", PORT_DIR],
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    try:
        findings = json.loads(out.stdout)
    except ValueError:
        _fail(f"lint: no JSON from sr_lint (exit code {out.returncode}):\n{out.stderr[-3000:]}")
    bare = [f for f in findings if not f["suppressed"] or not f["reason"]]
    by_rule = collections.Counter(f["rule"] for f in findings)
    print(f"lint: sr_lint (the torch rule set) over the port package, exit code "
          f"{out.returncode}, {wall:.2f} s: {len(findings)} findings ("
          + ", ".join(f"{r} {n}" for r, n in sorted(by_rule.items())) + f"), "
          f"{len(findings) - len(bare)} suppressed with a reason: "
          + "; ".join(f"{os.path.relpath(f['path'], PORT_DIR)}:{f['line']} {f['rule']} -- "
                      f"{f['reason']}" for f in findings if f["suppressed"])
          + f"; {len(bare)} unsuppressed or without a reason", flush=True)
    if out.returncode != 0 or bare:
        _fail("lint: " + "; ".join(f"{f['path']}:{f['line']} {f['rule']} {f['message']}"
                                   for f in bare))
    return {(os.path.realpath(f["path"]), f["line"]) for f in findings if f["rule"] == "SRL003"}


@contextlib.contextmanager
def sync_census(found):
    """Torch's sync debug mode "warn" inside; every synchronizing operation's
    warning is recorded in ``found`` as (the warning's own (file, line), the
    innermost frame of the port package on the stack (file, line), or None):
    the line in the port that made the sync."""
    import traceback
    import warnings

    import torch

    pkg = os.path.realpath(PORT_DIR) + os.sep

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            print(f"warning in the census's leg: {category.__name__}: {message}",
                  file=sys.stderr, flush=True)
            return
        port = [fr for fr in traceback.extract_stack()[:-1]
                if os.path.realpath(fr.filename).startswith(pkg)]
        found.append(((os.path.realpath(filename), lineno),
                      (os.path.realpath(port[-1].filename), port[-1].lineno) if port else None))

    # record=True puts the default showwarning back; ``show`` then records
    # each warning with the stack it was raised on
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _census_report(tag, syncs, srl003, engine_counts):
    """Phase 5's sync census line for one engine run; fails on a sync at a
    line the lint does not flag SRL003, and where the engine's own count of
    the leg's syncs (``engine_counts``: the leg's additions to
    ``engine_stats["host_syncs"]``, by site) differs from the census's."""
    import collections

    where = collections.Counter(port for _, port in syncs)
    own = sum(1 for w, port in syncs if w == port)
    text = ", ".join(f"{os.path.relpath(f, os.path.realpath(PORT_DIR))}:{ln} ({n})"
                     for (f, ln), n in sorted(where.items(), key=lambda kv: str(kv[0])))
    unflagged = [p for p in where if p is None or p not in srl003]
    counted = engine_counts.get("g_tol", 0) + engine_counts.get("armijo", 0)
    print(f"sync census, config3 engine ({tag}), iteration 1: const_opt {len(syncs)} syncs at "
          f"{text or 'no line'}, "
          + ("every one flagged SRL003" if not unflagged else "NOT ALL flagged SRL003")
          + f" (the warning's own frame was the caller's line for {own} of {len(syncs)}); "
          f"the engine's host_syncs for the leg {counted} (g_tol "
          f"{engine_counts.get('g_tol', 0)}, armijo {engine_counts.get('armijo', 0)}); "
          "evolve 0 (under sync debug mode \"error\")", flush=True)
    if unflagged:
        _fail("sync census: a sync at a line the lint does not flag SRL003: " + ", ".join(
            "no frame of the port on the stack" if p is None else f"{p[0]}:{p[1]}"
            for p in unflagged))
    if counted != len(syncs):
        _fail(f"sync census: the engine counted {counted} syncs in the leg, the census "
              f"{len(syncs)}")


def engine_path(device, lockstep=None, block=True, iterations=ENGINE_ITERATIONS,
                cycles=ENGINE_CYCLES, rows=CONFIG3_ROWS, populations=100, population_size=100,
                census=None):
    """Phase 5: the device engine at config3 width, with the evolve block
    (the default: B3 runs the evolve leg, one launch per iteration) or with
    ``SR_ENGINE_BLOCK=0`` (the event leg). Every evolve and const-opt leg is
    timed on the host clock between two synchronizations; the first evolve
    leg runs with host syncs made errors; the last iteration's legs run
    under torch.profiler (CUDA activity only), which gives the device time
    of their kernels by name and the device's idle share inside the leg
    (1 - device time / wall; the engine runs one stream, so its kernels do
    not overlap). With ``census`` (``lint_port``'s SRL003 lines) the first
    const-opt leg runs under ``sync_census``, and each of its syncs must lie
    on a line the lint flags; the engine's own count of the leg's syncs
    (its search's ``SpanRecord``, kept through ``device_search.SpanRecord``)
    must equal the census's. Returns the launches of B1-B4 in the run, and
    the ms per cycle, evals/s and each leg's host ms per iteration.
    ``lockstep``: phase 4's numbers, printed beside the engine's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data(n_rows=rows)
    options = Options(
        populations=populations, population_size=population_size, maxsize=20,
        ncycles_per_iteration=cycles, seed=0, save_to_file=False, progress=False,
        device=str(device), scheduler="device", **CONFIG3_OPS,
    )
    legs = []
    checked = []
    seen = {}
    walls = {}
    traces = {}
    syncs = []
    engine_counts = {}
    records = []
    on_card = device.type == "cuda"

    class KeptRecord(ds.SpanRecord):
        """The search's span record, kept so the census leg can read the
        engine's own sync counts."""

        __slots__ = ()

        def __init__(self, enabled=False):
            super().__init__(enabled)
            records.append(self)

    def leg_wrap(name):
        seen[name] = nth = seen.get(name, 0) + 1
        if name == "readback":
            return contextlib.nullcontext()
        no_sync = on_card and name == "evolve" and nth == 1
        counted = on_card and census is not None and name == "const_opt" and nth == 1
        traced = nth == iterations

        @contextlib.contextmanager
        def timed():
            acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
            with (profile(activities=acts) if traced else contextlib.nullcontext()) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if no_sync:
                    checked.append(name)
                    torch.cuda.set_sync_debug_mode("error")
                if counted:
                    checked.append(name)
                    before = dict(records[-1].syncs)
                try:
                    with sync_census(syncs) if counted else contextlib.nullcontext():
                        yield
                finally:
                    if no_sync:
                        torch.cuda.set_sync_debug_mode(0)
                if counted:
                    engine_counts.update({k: v - before.get(k, 0)
                                          for k, v in records[-1].syncs.items()})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls.setdefault(name, []).append(wall)
            if traced:
                traces[name] = (wall, prof)
        return timed()

    saved = ds._DISPATCH_HOOK, ds._LEG_WRAP, ds.SpanRecord
    ds._DISPATCH_HOOK, ds._LEG_WRAP, ds.SpanRecord = legs.append, leg_wrap, KeptRecord
    try:
        with engine_block_env(block):
            zero_launches()
            t0 = time.perf_counter()
            res = equation_search(X, y, options=options, niterations=iterations, verbosity=0)
            wall = time.perf_counter() - t0
            counts = read_launches()
    finally:
        ds._DISPATCH_HOOK, ds._LEG_WRAP, ds.SpanRecord = saved
    b1, b2, b3 = counts[:3]
    st = res.engine_stats
    leg_name = "block" if block else "event leg"
    if not res.use_kernel:
        _fail("the device engine did not select the kernels")
    if st["block"] != ("kernel" if block else None):
        _fail(f"the evolve leg ran {st['block']!r}, not the {leg_name}")
    if on_card and "evolve" not in checked:
        _fail("the evolve leg ran without the host-sync check")
    if on_card and census is not None:
        if "const_opt" not in checked:
            _fail("the const-opt leg ran without the sync census")
        _census_report(leg_name, syncs, census, engine_counts)
    if b1 != st["score_calls"] or b1 == 0:
        _fail(f"{b1} B1 launches for {st['score_calls']} engine scoring calls")
    if b2 != st["grad_calls"] or b2 == 0:
        _fail(f"{b2} B2 launches for {st['grad_calls']} engine gradient calls")
    if b3 != (st["iterations"] if block else 0):
        _fail(f"{b3} B3 launches in {st['iterations']} iterations ({leg_name})")
    if legs != ["evolve", "const_opt", "readback"] * iterations:
        _fail(f"legs per iteration: {legs}")
    if sorted(traces) != ["const_opt", "evolve"]:
        _fail(f"the last iteration's legs were not all traced: {sorted(traces)}")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("device-engine frontier is empty or not finite")
    dev_s = st["device_seconds"]
    host_s = st["host_seconds"]
    n_cycles = iterations * cycles
    evolve_s = dev_s.get("evolve", host_s["evolve"])
    stats = {"ms_per_cycle": evolve_s / n_cycles * 1e3,
             "evals_per_s": res.num_evals / res.iteration_seconds,
             "main_loop_s": res.iteration_seconds,
             "best": min(m.loss for m in front),
             "leg_walls_ms": {n: [w * 1e3 for w in ws] for n, ws in walls.items()}}
    print(f"config3 device engine, {leg_name}: {populations}x{population_size}, {rows} rows, "
          f"{iterations} iterations x {cycles} cycles (cut from 550; the last under "
          f"torch.profiler): wall {wall:.3f} s (set-up "
          f"{res.setup_seconds:.3f} s, main loop {res.iteration_seconds:.3f} s); per leg, "
          f"device s (CUDA events) / host s: evolve {dev_s.get('evolve', 0):.4f} / "
          f"{host_s['evolve']:.4f}, const-opt {dev_s.get('const_opt', 0):.3f} / "
          f"{host_s['const_opt']:.3f}, readback + host work {dev_s.get('readback', 0):.3f} / "
          f"{host_s['readback']:.3f}; evolve {stats['ms_per_cycle']:.4f} ms/cycle; "
          f"{stats['evals_per_s']:.4g} evals/s; B1 {b1} launches = {st['score_calls']} scoring "
          f"calls, B2 {b2} launches = {st['grad_calls']} gradient calls, B3 {b3} launches; "
          f"first evolve leg made no host sync; frontier {len(front)} members, best loss "
          f"{min(m.loss for m in front):.6g}", flush=True)
    print(f"legs, config3 device engine ({leg_name}), host ms between synchronizations per "
          "iteration: " + "; ".join(f"{n} " + ", ".join(f"{w * 1e3:.3f}" for w in ws)
                                    for n, ws in walls.items()), flush=True)
    for name, (lwall, prof) in traces.items():
        kern = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                kern[ev.key] = kern.get(ev.key, 0.0) + dev_us * 1e-6
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
        idle = f"{1 - busy / lwall:.1%}" if busy > 0 else "not measured (no device time traced)"
        print(f"profile, config3 device engine ({leg_name}), iteration {iterations} {name} leg: "
              f"wall {lwall * 1e3:.3f} ms, device time {busy * 1e3:.3f} ms in {len(kern)} "
              f"kernel names, device idle {idle}; largest: "
              + ", ".join(f"{k[:48]} {v * 1e3:.3f} ms" for k, v in top), flush=True)
    if lockstep is not None:
        print(f"config3, device engine ({leg_name}) vs lockstep: "
              f"{stats['ms_per_cycle']:.4f} vs {lockstep['ms_per_cycle']:.2f} ms/cycle, "
              f"{stats['evals_per_s']:.4g} vs {lockstep['evals_per_s']:.4g} evals/s", flush=True)
    return counts, stats


def quick_start_device(device, niterations=DEVICE_QUICKSTART_ITERATIONS):
    """Phase 6b: the README quick start under scheduler="device", twice with
    one seed."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import SRRegressor
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    baseline = float(np.mean((y - y.mean()) ** 2))
    fronts = []
    evolve_block.launches = 0
    for run in range(2):
        t0 = time.perf_counter()
        model = SRRegressor(
            niterations=niterations, binary_operators=["+", "-", "*"],
            unary_operators=["cos"], seed=0, save_to_file=False, progress=False,
            device=str(device), scheduler="device",
        )
        model.fit(X, y)
        wall = time.perf_counter() - t0
        rows = model.equations_
        best = min(rows, key=lambda r: r["loss"])
        pred = model.predict(X)
        if not np.all(np.isfinite(pred)) or pred.shape != y.shape:
            _fail("device quick start predictions are not finite")
        if not best["loss"] < baseline:
            _fail(f"device quick start best loss {best['loss']} not below baseline {baseline}")
        fronts.append([(r["complexity"], r["loss"], r["equation"]) for r in rows])
        print(f"quick start, scheduler='device', run {run + 1}: {niterations} iterations "
              f"(README: 20) in {wall:.3f} s, best loss {best['loss']:.6g} (mean predictor "
              f"{baseline:.6g}): {best['equation']}", flush=True)
    if fronts[0] != fronts[1]:
        _fail("two device quick starts with one seed gave different frontiers")
    if evolve_block.launches != 2 * niterations:
        _fail(f"{evolve_block.launches} B3 launches in two device quick starts of "
              f"{niterations} iterations")
    print(f"quick start, scheduler='device': the two frontiers are identical; the evolve leg "
          f"ran on B3 ({evolve_block.launches} launches)", flush=True)


def _frontier(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def resume_lockstep(device, tmp):
    """Phase 7 (a) and (d): lockstep at the quick start's size. (a) Run
    uninterrupted twice (identical frontiers), then with a snapshot after
    every iteration and ``peer_death@2:mode=raise``, then resumed from the
    snapshot: the frontier string for string and the evaluation count equal
    the uninterrupted run's. (d) ``ckpt_crash@1``: the first snapshot stays
    loadable and a resume from it finishes. Returns the launches of B1-B4 in the
    resumed run of (a)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search, load_checkpoint
    from symbolicregression_jl_tpu_torch.utils.faults import CheckpointWriteCrash, FaultInjected

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    base = os.path.join(tmp, "lockstep.pkl")

    def opts(checkpoint_file=base, **kw):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       ncycles_per_iteration=RESUME_CYCLES, seed=0, save_to_file=False,
                       progress=False, device=str(device), checkpoint_file=checkpoint_file,
                       **kw)

    n = RESUME_ITERATIONS
    t0 = time.perf_counter()
    full = [equation_search(X, y, options=opts(), niterations=n, verbosity=0)
            for _ in range(2)]
    if _frontier(full[0]) != _frontier(full[1]):
        _fail("two uninterrupted lockstep runs with one seed gave different frontiers")
    try:
        equation_search(X, y, options=opts(checkpoint_every=1,
                                           fault_spec="peer_death@2:mode=raise"),
                        niterations=n, verbosity=0)
        _fail("the peer_death fault did not stop the lockstep run")
    except FaultInjected:
        pass
    ck = load_checkpoint(base)
    if (ck.iteration, ck.exact, ck.scheduler) != (2, True, "lockstep"):
        _fail(f"lockstep snapshot: iteration {ck.iteration}, exact {ck.exact}, {ck.scheduler}")
    zero_launches()
    resumed = equation_search(X, y, options=opts(), niterations=n, verbosity=0,
                              resume_from=base)
    counts = read_launches()
    b1 = counts[0]
    if _frontier(resumed) != _frontier(full[0]):
        _fail("the resumed lockstep frontier differs from the uninterrupted run's")
    if resumed.num_evals != full[0].num_evals:
        _fail(f"resumed num_evals {resumed.num_evals} != {full[0].num_evals}")
    if b1 == 0 or b1 != resumed.scoring_dispatches:
        _fail(f"{b1} B1 launches in the resumed lockstep run for "
              f"{resumed.scoring_dispatches} scoring dispatches")
    print(f"resume (a), lockstep: 200 x 2, 15 x 33, {n} iterations x {RESUME_CYCLES} cycles: "
          f"two uninterrupted runs identical; killed at iteration 2 (peer_death), resumed "
          f"from the snapshot of iteration {ck.iteration}: frontier identical string for "
          f"string ({len(full[0].pareto_frontier)} members), num_evals {resumed.num_evals:.0f} "
          f"equal; B1 {b1} launches in the resumed run; {time.perf_counter() - t0:.3f} s",
          flush=True)

    t0 = time.perf_counter()
    crash = os.path.join(tmp, "crash.pkl")
    try:
        equation_search(X, y, options=opts(checkpoint_every=1, fault_spec="ckpt_crash@1",
                                           checkpoint_file=crash),
                        niterations=n, verbosity=0)
        _fail("the ckpt_crash fault did not stop the lockstep run")
    except CheckpointWriteCrash:
        pass
    orphans = [f for f in os.listdir(tmp) if f.startswith("crash.pkl.") and f.endswith(".tmp")]
    ck = load_checkpoint(crash)
    if ck.iteration != 1 or not orphans:
        _fail(f"after ckpt_crash: snapshot of iteration {ck.iteration}, orphans {orphans}")
    after = equation_search(X, y, options=opts(checkpoint_file=crash), niterations=n,
                            verbosity=0, resume_from=crash)
    if not all(np.isfinite(m.loss) for m in after.pareto_frontier) or not after.pareto_frontier:
        _fail("the resume after ckpt_crash gave no finite frontier")
    print(f"resume (d), ckpt_crash@1 on lockstep: the second write died before its rename "
          f"({orphans[0]} left), the snapshot of iteration 1 loaded and the resume from it "
          f"finished (best loss {min(m.loss for m in after.pareto_frontier):.6g}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return counts


def resume_engine(device, tmp, iterations=4, cycles=ENGINE_CYCLES, rows=CONFIG3_ROWS):
    """Phase 7 (b) and (c): the device engine at config3 width on the block.
    (b) A snapshot after every iteration and ``peer_death@2:mode=raise``;
    the snapshot of iteration 2 (exact=False, scheduler "device") resumes as
    a warm start on the block without losing its frontier. (c)
    ``nan_flood@1:frac=0.75``, with a snapshot after every iteration: the
    search ends with a finite frontier.
    Returns the launches of B1, B2 and B3 in the resumed run of (b)."""
    import numpy as np

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search, load_checkpoint
    from symbolicregression_jl_tpu_torch.utils.faults import FaultInjected

    X, y = config3_data(n_rows=rows)
    base = os.path.join(tmp, "engine.pkl")

    def opts(checkpoint_file=base, **kw):
        return Options(populations=100, population_size=100, maxsize=20,
                       ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                       progress=False, device=str(device), scheduler="device",
                       checkpoint_file=checkpoint_file, **CONFIG3_OPS, **kw)

    # a snapshot's host time splits into the decode of the live state (its
    # readback and unflattening) and the write (flatten, pickle, fsync)
    decode_s = []
    decode = ds._decode_state_populations

    def timed_decode(*args, **kwargs):
        t = time.perf_counter()
        out = decode(*args, **kwargs)
        decode_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    with engine_block_env(True):
        try:
            equation_search(X, y, options=opts(checkpoint_every=1,
                                               fault_spec="peer_death@2:mode=raise"),
                            niterations=iterations, verbosity=0)
            _fail("the peer_death fault did not stop the engine")
        except FaultInjected:
            pass
        ck = load_checkpoint(base)
        if (ck.iteration, ck.exact, ck.scheduler) != (2, False, "device"):
            _fail(f"engine snapshot: iteration {ck.iteration}, exact {ck.exact}, "
                  f"{ck.scheduler}")
        # the resumed run snapshots every iteration too: its engine_stats
        # time each snapshot on the host
        zero_launches()
        ds._decode_state_populations = timed_decode
        try:
            res = equation_search(X, y, options=opts(checkpoint_every=1),
                                  niterations=iterations, verbosity=0, resume_from=base)
        finally:
            ds._decode_state_populations = decode
        counts = read_launches()
    b1, b2, b3 = counts[:3]
    st = res.engine_stats
    ck_best = min(m.loss for m in ck.pareto_frontier)
    best = min(m.loss for m in res.pareto_frontier)
    if st["block"] != "kernel" or st["iterations"] != iterations - 2:
        _fail(f"resumed engine: block {st['block']!r}, {st['iterations']} iterations")
    if not best <= ck_best + 1e-5:
        _fail(f"resumed engine best loss {best} above the snapshot's {ck_best}")
    if not res.num_evals > ck.num_evals:
        _fail(f"resumed engine num_evals {res.num_evals} <= the snapshot's {ck.num_evals}")
    if b1 != st["score_calls"] or b2 != st["grad_calls"] or b3 != st["iterations"] or not b2:
        _fail(f"resumed engine launches B1 {b1}, B2 {b2}, B3 {b3} for {st['score_calls']} "
              f"scoring calls, {st['grad_calls']} gradient calls, {st['iterations']} iterations")
    ck_ms = [round(t * 1e3, 3) for t in st["checkpoint_seconds"]]
    dec_ms = [round(t * 1e3, 3) for t in decode_s[:len(ck_ms)]]
    legs_ms = {k: round(v / st["iterations"] * 1e3, 3) for k, v in st["host_seconds"].items()}
    print(f"resume (b), device engine on the block: 100x100, {rows} rows, {iterations} "
          f"iterations x {cycles} cycles, killed at iteration 2 (peer_death); snapshot of "
          f"iteration {ck.iteration} (exact {ck.exact}, {sum(p.n for p in ck.populations)} "
          f"members, best {ck_best:.6g}, num_evals {ck.num_evals:.0f}); resumed for "
          f"{st['iterations']} iterations: best {best:.6g}, num_evals {res.num_evals:.0f}; "
          f"launches B1 {b1}, B2 {b2}, B3 {b3}; snapshot host ms per iteration "
          f"{ck_ms} (decode of the live state {dec_ms}, the rest the write); the "
          f"iteration's legs, host ms per iteration: {legs_ms}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    with engine_block_env(True):
        flooded = equation_search(X, y, options=opts(
            checkpoint_file=os.path.join(tmp, "flood.pkl"), checkpoint_every=1,
            fault_spec="nan_flood@1:frac=0.75"), niterations=3, verbosity=0)
    fst = flooded.engine_stats
    front = flooded.pareto_frontier
    if fst["block"] != "kernel" or fst["nan_flooded_islands"] != 75:
        _fail(f"nan_flood engine: block {fst['block']!r}, "
              f"{fst['nan_flooded_islands']} islands flooded")
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("the nan_flood engine run gave no finite frontier")
    finite = np.mean([np.isfinite(m.loss) for p in flooded.populations for m in p.members])
    print(f"resume (c), nan_flood@1:frac=0.75 on the engine (block): "
          f"{fst['nan_flooded_islands']} of 100 islands flooded at iteration 2 of 3; finite "
          f"frontier of {len(front)} members, best {min(m.loss for m in front):.6g}; "
          f"{finite:.1%} of the final members finite; snapshot host ms per iteration "
          f"{[round(t * 1e3, 3) for t in fst['checkpoint_seconds']]}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return counts


def resume_path(device):
    """Phase 7: kill and resume of both schedulers, and the two faults of
    the checkpoint writer and the NaN storm. Returns the launches of B1-B4
    on the resumed runs."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lock = resume_lockstep(device, tmp)
        eng = resume_engine(device, tmp)
    print(f"resume phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return tuple(a + b for a, b in zip(lock, eng))


# the engine_options phase's units run: x0 kg, x1 m/s, x2 m, all U(1, 5), and
# y = x0 * x1^2 / x2 in N, at the quick start's width with 100-cycle
# iterations
UNITS_ROWS, UNITS_X, UNITS_Y = 10_000, ["kg", "m/s", "m"], "N"
OPTIONS_ITERATIONS, OPTIONS_CYCLES = 3, 100


def _kernel_wrappers():
    """The wrappers that count their kernel's launches (``.launches``), in
    the kernels line's order: B1, B2, B3, B4 and B2's seeded mode (B2v,
    ``preds_vjp``)."""
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_trees_kernel, fused_loss, fused_loss_grad, preds_vjp,
    )

    return fused_loss, fused_loss_grad, evolve_block, eval_trees_kernel, preds_vjp


def zero_launches():
    """Set the launch counts of B1-B4 and B2v to 0, just before a path runs."""
    for w in _kernel_wrappers():
        w.launches = 0


def read_launches():
    """(B1, B2, B3, B4, B2v) launches since ``zero_launches``, just after a
    path ran: every count in the kernels line is one of these."""
    return tuple(w.launches for w in _kernel_wrappers())


def _counted(run):
    """Run ``run()`` with the launch counts of B1-B4 and B2v set to 0 just
    before; returns (its result, B1, B2, B3, B4, B2v launches)."""
    zero_launches()
    out = run()
    return (out, *read_launches())


def _check_engine_launches(tag, res, b1, b2, b3, block):
    st = res.engine_stats
    if b1 != st["score_calls"] or b1 == 0:
        _fail(f"{tag}: {b1} B1 launches for {st['score_calls']} engine scoring calls")
    if b2 != st["grad_calls"]:
        _fail(f"{tag}: {b2} B2 launches for {st['grad_calls']} engine gradient calls")
    if st["block"] != ("kernel" if block else None) or b3 != (st["iterations"] if block else 0):
        _fail(f"{tag}: evolve leg {st['block']!r} with {b3} B3 launches in "
              f"{st['iterations']} iterations")


def options_profile(device, block_run_s, iterations=ENGINE_ITERATIONS, cycles=ENGINE_CYCLES):
    """engine_options (a): config3 on the engine, on the block, with
    ``profile=True``, and the same search unprofiled in the readback mode
    the profile forces (synchronous): the frontiers must be equal, the
    profile must cover every iteration, and its top-level fractions must
    sum to 1. Prints each stage's mean ms and fraction, the evolve and
    const-opt stages beside the engine's own leg timers, and the profiled
    mean iteration wall beside the unprofiled ones (``block_run_s``: phase
    5's default run on the block, whose legs ran under its timing wrap).
    Returns the profiled run's launches of B1, B2 and B3."""
    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data()

    def run(**kw):
        options = Options(populations=100, population_size=100, maxsize=20,
                          ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                          progress=False, device=str(device), scheduler="device",
                          **CONFIG3_OPS, **kw)
        return equation_search(X, y, options=options, niterations=iterations, verbosity=0)

    with engine_block_env(True):
        res, b1, b2, b3, b4, b2v = _counted(lambda: run(profile=True))
        plain = run(async_readback=False)
    _check_engine_launches("profile", res, b1, b2, b3, block=True)
    prof = res.engine_profile
    stages = prof["stages"]
    total = sum(v["fraction"] for k, v in stages.items() if "/" not in k)
    if prof["iterations"] != iterations or not 0.99 <= total <= 1.01:
        _fail(f"profile: {prof['iterations']} iterations, top-level fractions sum to {total}")
    if _frontier(res) != _frontier(plain):
        _fail("profile: the profiled frontier differs from the unprofiled one")
    st = res.engine_stats
    print(f"engine_options (a) profile, config3 device engine on the block, {iterations} "
          f"iterations x {cycles} cycles: stages (mean ms, fraction) "
          + "; ".join(f"{k} {v['mean_ms']:.3f} ({v['fraction']:.4f})" for k, v in stages.items())
          + f"; fractions sum {total:.6f}", flush=True)
    print("engine_options (a) profile: stage vs the engine's leg timer per iteration (host ms "
          "/ CUDA-event device ms): " + "; ".join(
              f"{leg} {stages[leg]['mean_ms']:.3f} vs {st['host_seconds'][leg] / iterations * 1e3:.3f}"
              f" / {st['device_seconds'].get(leg, 0.0) / iterations * 1e3:.3f}"
              for leg in ("evolve", "const_opt")), flush=True)
    walls = {"profiled": prof["iteration_mean_ms"],
             "unprofiled, synchronous readback": plain.iteration_seconds / iterations * 1e3,
             "phase 5 block run (pipelined readback, timing wrap)": block_run_s / iterations * 1e3}
    print("engine_options (a) profile: mean iteration wall ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; overhead {walls['profiled'] / walls['unprofiled, synchronous readback'] - 1:.2%}"
          f" against the synchronous run; frontiers of the profiled and unprofiled runs equal "
          f"({len(res.pareto_frontier)} members); B1 {b1}, B2 {b2}, B3 {b3}", flush=True)
    return b1, b2, b3, b4, b2v


def options_units(device, iterations=OPTIONS_ITERATIONS, cycles=OPTIONS_CYCLES):
    """engine_options (b): the planted units problem on lockstep and on the
    device engine (whose units runs take the event leg). On each frontier
    every member the host oracle flags must carry the penalty; on the
    engine's final populations its batched check must equal the oracle on
    every member. Returns the launches of B1-B4 of each run, and the
    device run's evolve ms per cycle (``device_ms_per_cycle``)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.dimensional_analysis import (
        violates_dimensional_constraints,
    )
    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config
    from symbolicregression_jl_tpu_torch.ops.evolve import dim_violates_batch
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.treeops import Tree

    rng = np.random.default_rng(0)
    X = rng.uniform(1, 5, size=(3, UNITS_ROWS)).astype(np.float32)
    y = (X[0] * X[1] ** 2 / X[2]).astype(np.float32)
    out = {}
    for scheduler in ("lockstep", "device"):
        options = Options(binary_operators=["+", "-", "*", "/"],
                          unary_operators=["sqrt", "cos"], populations=15, population_size=33,
                          ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                          progress=False, device=str(device), scheduler=scheduler)
        t0 = time.perf_counter()
        res, b1, b2, b3, b4, b2v = _counted(lambda: equation_search(
            X, y, options=options, niterations=iterations, verbosity=0, X_units=UNITS_X,
            y_units=UNITS_Y))
        wall = time.perf_counter() - t0
        pen = 1000.0
        front = res.pareto_frontier
        flagged = [m for m in front
                   if violates_dimensional_constraints(m.tree, res.dataset, options)]
        if not front or any(m.loss < pen for m in flagged):
            _fail(f"units {scheduler}: a frontier member the oracle flags lacks the penalty")
        best = min(front, key=lambda m: m.loss)
        line = (f"engine_options (b) units, {scheduler}: 15x33, {UNITS_ROWS} rows, "
                f"{iterations} iterations x {cycles} cycles in {wall:.3f} s; frontier "
                f"{len(front)} members, {len(flagged)} flagged (each with the penalty); best "
                f"loss {best.loss:.6g}: {best.tree.string_tree(options.operators)}; B1 {b1}, "
                f"B2 {b2}, B3 {b3}")
        if scheduler == "device":
            _check_engine_launches("units device", res, b1, b2, b3, block=False)
            members = [m for pop in res.populations for m in pop.members]
            flat = flatten_trees([m.tree for m in members], options.max_nodes)
            batch = Tree(*(torch.from_numpy(np.asarray(getattr(flat, f))).to(device)
                           for f in ("kind", "op", "lhs", "rhs", "feat", "val", "length")))
            cfg = build_evo_config(options, 3, 1.0, True, iterations, dataset=res.dataset)
            got = dim_violates_batch(batch, cfg).cpu().numpy()
            want = np.array([violates_dimensional_constraints(m.tree, res.dataset, options)
                             for m in members])
            bad = [members[i].tree.string_tree(options.operators)
                   for i in np.flatnonzero(got != want)]
            if bad:
                _fail(f"units device: the engine's check and the oracle differ on {bad[:5]}")
            st = res.engine_stats
            evolve_s = st["device_seconds"].get("evolve", st["host_seconds"]["evolve"])
            out["device_ms_per_cycle"] = evolve_s / (iterations * cycles) * 1e3
            line += (f"; the engine's check equals the oracle on all {len(members)} final "
                     f"members ({int(want.sum())} flagged); evolve (event leg) "
                     f"{evolve_s / (iterations * cycles) * 1e3:.4f} ms/cycle, const-opt "
                     f"{st['device_seconds'].get('const_opt', 0.0) / iterations * 1e3:.3f} ms "
                     f"per iteration")
        print(line, flush=True)
        out[scheduler] = (b1, b2, b3, b4, b2v)
    return out


def options_recorder(device, tmp, iterations=3, cycles=None):
    """engine_options (c): the README quick start on the engine with the
    recorder. Every evolve leg runs with host syncs made errors; after
    every iteration the replay's mirror must equal the engine's populations
    slot for slot on kind, op, feat, val and length; the recorder file must
    parse and hold islands x events per cycle x cycles x iterations
    mutation events. Returns the launches of B1, B2 and B3."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models import device_recorder
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    path = os.path.join(tmp, "recorder.json")
    readme = {} if cycles is None else {"ncycles_per_iteration": cycles}
    options = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=0,
                      save_to_file=False, progress=False, device=str(device),
                      scheduler="device", use_recorder=True, recorder_file=path,
                      crossover_probability=0.0, **readme)
    checked, no_sync = [], []
    snapshot = device_recorder.EngineLineageReplay.snapshot_populations

    def mirror_check(replay, arrays, iteration):
        kind, op, _, _, feat, val, length = arrays[:7]
        I, P, N = kind.shape
        flat = flatten_trees(list(replay.trees.reshape(-1)), N, dtype=val.dtype)
        live = np.arange(N)[None, None, :] < length[:, :, None]
        for name, got, want in (("kind", flat.kind, kind), ("op", flat.op, op),
                                ("feat", flat.feat, feat), ("val", flat.val, val)):
            got = np.asarray(got).reshape(I, P, N)
            if not np.array_equal(np.where(live, got, 0), np.where(live, want, 0)):
                _fail(f"recorder: the mirror's {name} differs from the engine's at "
                      f"iteration {iteration}")
        if not np.array_equal(np.asarray(flat.length).reshape(I, P), length):
            _fail(f"recorder: the mirror's lengths differ at iteration {iteration}")
        checked.append(iteration)
        snapshot(replay, arrays, iteration)

    @contextlib.contextmanager
    def sync_free(name):
        if name != "evolve":
            yield
            return
        no_sync.append(name)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    saved = device_recorder.EngineLineageReplay.snapshot_populations, ds._LEG_WRAP
    device_recorder.EngineLineageReplay.snapshot_populations = mirror_check
    ds._LEG_WRAP = sync_free
    t0 = time.perf_counter()
    try:
        res, b1, b2, b3, b4, b2v = _counted(lambda: equation_search(
            X.T, y, options=options, niterations=iterations, verbosity=0))
    finally:
        device_recorder.EngineLineageReplay.snapshot_populations, ds._LEG_WRAP = saved
    wall = time.perf_counter() - t0
    _check_engine_launches("recorder", res, b1, b2, b3, block=False)
    if checked != list(range(1, iterations + 1)) or len(no_sync) != iterations:
        _fail(f"recorder: mirror checked at {checked}, {len(no_sync)} sync-free evolve legs")
    with open(path) as fh:
        data = json.load(fh)
    events = [e for m in data["mutations"].values() for e in m["events"]]
    n_mut = sum(e["type"] == "mutate" for e in events)
    E = -(-options.population_size // min(options.tournament_selection_n,
                                          options.population_size))
    want = options.populations * E * options.ncycles_per_iteration * iterations
    if n_mut != want:
        _fail(f"recorder: {n_mut} mutation events, expected {want}")
    print(f"engine_options (c) recorder, README quick start on the engine: {iterations} "
          f"iterations x {options.ncycles_per_iteration} cycles in {wall:.3f} s; every evolve "
          f"leg made no host sync; the mirror equalled the engine's populations after each "
          f"iteration; {os.path.getsize(path)} bytes of record, {n_mut} mutation events = "
          f"{options.populations} x {E} x {options.ncycles_per_iteration} x {iterations}, "
          f"{sum(e['type'] == 'death' for e in events)} deaths, "
          f"{sum(e['type'] == 'tuning' for e in events)} tunings; B1 {b1}, B2 {b2}, B3 {b3}",
          flush=True)
    return b1, b2, b3, b4, b2v


def options_neldermead(device, iterations=3, cycles=None):
    """engine_options (d): the README quick start on the engine with
    ``optimizer_algorithm="NelderMead"``: B2 must not launch, B1 must, and
    the frontier must be finite. Returns the launches of B1, B2 and B3."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    readme = {} if cycles is None else {"ncycles_per_iteration": cycles}
    options = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=0,
                      save_to_file=False, progress=False, device=str(device),
                      scheduler="device", optimizer_algorithm="NelderMead", **readme)
    t0 = time.perf_counter()
    with engine_block_env(True):
        res, b1, b2, b3, b4, b2v = _counted(lambda: equation_search(
            X.T, y, options=options, niterations=iterations, verbosity=0))
    wall = time.perf_counter() - t0
    _check_engine_launches("neldermead", res, b1, b2, b3, block=True)
    front = res.pareto_frontier
    if b2 != 0 or b1 == 0 or not front or not all(np.isfinite(m.loss) for m in front):
        _fail(f"neldermead: B2 {b2}, B1 {b1} launches, frontier "
              f"{[m.loss for m in front]}")
    best = min(front, key=lambda m: m.loss)
    st = res.engine_stats
    print(f"engine_options (d) NelderMead, README quick start on the engine (block): "
          f"{iterations} iterations in {wall:.3f} s; const-opt "
          f"{st['device_seconds'].get('const_opt', 0.0) / iterations * 1e3:.3f} ms per "
          f"iteration on the device; best loss {best.loss:.6g}: "
          f"{best.tree.string_tree(options.operators)}; B1 {b1} = {st['score_calls']} scoring "
          f"calls, B2 {b2}, B3 {b3}", flush=True)
    return b1, b2, b3, b4, b2v


def engine_options(device, block_run_s):
    """Phase 8: the device engine's single-card options: (a) the stage
    profile, (b) units on both schedulers, (c) the recorder, (d) NelderMead.
    Returns {path: (B1, B2, B3, B4, B2v launches)} for the kernels line."""
    import tempfile

    t0 = time.perf_counter()
    paths = {"profile": options_profile(device, block_run_s)}
    units = options_units(device)
    paths["units lockstep"], paths["units device"] = units["lockstep"], units["device"]
    with tempfile.TemporaryDirectory() as tmp:
        paths["recorder"] = options_recorder(device, tmp)
    paths["neldermead"] = options_neldermead(device)
    print(f"engine_options phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 9: the fleet
# ---------------------------------------------------------------------------


def fleet_targets(X):
    """The fleet cell's four targets over config3's X: config3's own y, then
    three planted laws the operator set can express (PERF.md section 4)."""
    import numpy as np

    y0 = config3_data(n_rows=X.shape[1])[1]
    y1 = X[1] * X[2] - 0.5 * X[0]
    y2 = np.cos(1.7 * X[3]) + np.abs(X[4])
    y3 = np.exp(0.3 * X[0]) / (1.0 + np.abs(X[1]))
    return np.stack([y0, y1, y2, y3]).astype(np.float32)


def _bits(t):
    """A tensor's bits, for bitwise comparison (NaN equal to itself)."""
    import torch

    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(tag, got, want):
    import torch

    if not torch.equal(_bits(got), _bits(want)):
        bad = torch.nonzero((_bits(got) != _bits(want)).reshape(got.shape[0], -1).any(1))
        _fail(f"{tag}: the lane-axis launch differs from the solo launches at rows "
              f"{bad.flatten()[:5].tolist()}")


def fleet_kernel_check(device, lanes=FLEET_CHECK_LANES, P_lane=4200, islands=100):
    """Phase 9 (a): B1, B2 and B3 on the lane axis at L = ``lanes``, on
    config3's X with a different y per lane: against their plain versions
    (the smoke's tolerances), then against one solo launch per lane, bit for
    bit. B1 and B2 at the const-opt shape (``P_lane`` programs a lane, 10k
    rows: the solo launch cuts each program's rows into 2 chunks, which a
    geometry taken from L * P_lane programs would not) and at 64 programs a
    lane (many chunks), weighted and unweighted; B3 at config3 width, 2
    cycles. Then each kernel timed at L = 1 and L = 4 on the same lane shapes,
    beside its bound at each (B3's for one cycle).
    Returns {name: {"max_abs_err", "ms_l1", "ms_l4"}}; timing launches are
    not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        block_work_counts, evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference, fused_loss_reference,
        grad_geometry, grad_work_counts, loss_geometry, optab_tensor, work_counts,
    )

    saved = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    opts = Options(maxsize=20, populations=islands, population_size=100, device=str(device),
                   **CONFIG3_OPS)
    opset, N, l2 = opts.operators, opts.max_nodes, opts.loss
    Xn, _ = config3_data()
    Yn = fleet_targets(Xn)
    L4 = Yn.shape[0]
    X4 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(Xn, (L4,) + Xn.shape))).to(device)
    Y4 = torch.from_numpy(Yn).to(device)
    W4 = torch.from_numpy(
        np.random.default_rng(3).uniform(0.1, 2.0, Yn.shape).astype(np.float32)).to(device)
    out = {}
    errs = {"fused_loss": 0.0, "fused_loss_grad": 0.0, "evolve_block": 0.0}
    for P in (P_lane, 64):
        n_chunks = loss_geometry(P, N, CONFIG3_ROWS)[4]
        if n_chunks == loss_geometry(lanes * P, N, CONFIG3_ROWS)[4] and P == P_lane:
            _fail(f"P_lane={P}: the check does not separate the lane's chunking from the "
                  "fleet's")
        prog_np, vals_np = random_programs(opset, lanes * P, N, CONFIG3_FEATURES, seed=P + 1)
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        X, Y = X4[:lanes], Y4[:lanes]
        for W in (None, W4[:lanes]):
            tag = f"L={lanes} x {P} programs{' weighted' if W is not None else ''}"
            got = fused_loss(prog, vals, X, Y, W, opset, l2)
            ref = fused_loss_reference(prog, vals, X, Y, W, opset, l2)
            gl, gg = fused_loss_grad(prog, vals, X, Y, W, opset, l2)
            rl, rg = fused_loss_grad_reference(prog, vals, X, Y, W, opset, l2)
            solo = [fused_loss(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X[l], Y[l],
                               None if W is None else W[l], opset, l2) for l in range(lanes)]
            solo_g = [fused_loss_grad(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X[l],
                                      Y[l], None if W is None else W[l], opset, l2)
                      for l in range(lanes)]
            torch.cuda.synchronize()
            errs["fused_loss"] = worst_err(errs["fused_loss"],
                                           compare(f"B1 lanes {tag}", got, ref))
            errs["fused_loss_grad"] = worst_err(errs["fused_loss_grad"],
                                                compare(f"B2 lanes {tag}", gl, rl),
                                                compare_grads(f"B2 lanes {tag}", gg, rg))
            _same_bits(f"B1 {tag}", got, torch.cat(solo))
            _same_bits(f"B2 losses {tag}", gl, torch.cat([s[0] for s in solo_g]))
            _same_bits(f"B2 gradients {tag}", gg, torch.cat([s[1] for s in solo_g]))
        print(f"fleet kernel check, B1 and B2: L={lanes} lanes x {P} programs x "
              f"{CONFIG3_ROWS} rows (a lane's launch shape: {n_chunks} row chunks per program "
              f"for B1, {grad_geometry(P, N, CONFIG3_ROWS)[4]} for B2), weighted and not: "
              "within tolerance of the plain versions and bit for bit the solo launches",
              flush=True)

    # B3: each lane its own population (seed), y and scalars
    setups = [block_setup(device, opts, X4[l], Y4[l], None, islands, 2, seed=l)
              for l in range(lanes)]
    cfg = setups[0][0]
    pops = [s[1] for s in setups]
    scal = [s[2] for s in setups]
    stacked = tuple(torch.cat([p[k] for p in pops]) for k in range(6))
    lane_scal = tuple(torch.stack([s[k] for s in scal]) for k in range(5))
    args = (*stacked, *lane_scal, X4[:lanes], Y4[:lanes], None, cfg, opset, l2)
    got = evolve_block(*args)
    ref = evolve_block_reference(*args)
    solo = [evolve_block(*pops[l], *scal[l], X4[l], Y4[l], None, cfg, opset, l2)
            for l in range(lanes)]
    torch.cuda.synchronize()
    errs["evolve_block"] = compare_block(f"B3 lanes L={lanes}", got, ref)
    for k, field in enumerate(got):
        _same_bits(f"B3 output {k}", field, torch.cat([s[k] for s in solo]))
    print(f"fleet kernel check, B3: L={lanes} lanes x {islands} islands x 100 (config3), 2 "
          f"cycles, one launch of {lanes * islands} blocks: within tolerance of the plain "
          "version, and every output bit for bit the solo launches'", flush=True)

    bmm_batch_count(device, N)

    # timings on the lane shapes, at L = 1 and L = 4
    prog_np, vals_np = random_programs(opset, L4 * P_lane, N, CONFIG3_FEATURES, seed=P_lane + 1)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    t, bound = {}, {}

    def bound_ms(work):
        return max(work["operations"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES) * 1e3

    tab = optab_tensor(opset, device)  # once, as a search's scorer holds it
    for L in (1, L4):
        n = L * P_lane
        t[("fused_loss", L)] = time_ms(lambda: fused_loss(prog[:n], vals[:n], X4[:L], Y4[:L],
                                                            None, opset, l2, tab))
        t[("fused_loss_grad", L)] = time_ms(lambda: fused_loss_grad(
            prog[:n], vals[:n], X4[:L], Y4[:L], None, opset, l2, tab))
        bound[("fused_loss", L)] = bound_ms(work_counts(
            prog_np[:n], CONFIG3_ROWS, CONFIG3_FEATURES, False, lanes=L))
        bound[("fused_loss_grad", L)] = bound_ms(grad_work_counts(
            prog_np[:n], CONFIG3_ROWS, CONFIG3_FEATURES, False, lanes=L))
    ksetups = [block_setup(device, opts, X4[l], Y4[l], None, islands, ENGINE_CYCLES, seed=l)
               for l in range(L4)]
    ones = [block_setup(device, opts, X4[l], Y4[l], None, islands, 1, seed=l)
            for l in range(L4)]
    for L in (1, L4):
        per = {}
        for tag, su in (("k", ksetups), ("1", ones)):
            st = tuple(torch.cat([s[1][k] for s in su[:L]]) for k in range(6))
            sc = tuple(torch.stack([s[2][k] for s in su[:L]]) for k in range(5))
            a = (*st, *sc, X4[:L], Y4[:L], None, su[0][0], opset, l2)
            per[tag] = time_ms(lambda: evolve_block(*a))
            if tag == "1":
                # the bound of one cycle, from the candidates the plain
                # version scores in it
                counts = {}
                evolve_block_reference(*a, counts=counts)
                bound[("evolve_block", L)] = bound_ms(block_work_counts(
                    su[0][0], CONFIG3_ROWS, CONFIG3_FEATURES, False, counts["candidates"],
                    counts["slots"], lanes=L))
        t[("evolve_block", L)] = (per["k"] - per["1"]) / (ENGINE_CYCLES - 1)
    fused_loss.launches, fused_loss_grad.launches, evolve_block.launches = saved
    for name in ("fused_loss", "fused_loss_grad", "evolve_block"):
        a, b = t[(name, 1)], t[(name, L4)]
        unit = "ms per cycle" if name == "evolve_block" else "ms"
        what = (f"{islands} islands a lane ({islands} and {L4 * islands} blocks)"
                if name == "evolve_block" else f"{P_lane} programs a lane x {CONFIG3_ROWS} rows")
        b1, b4 = bound[(name, 1)], bound[(name, L4)]
        print(f"fleet timing, {name} on the lane axis, {what}: L=1 {a:.4f} {unit}, L={L4} "
              f"{b:.4f} {unit} ({b / a:.2f}x the one lane's); bound L=1 {b1:.5f} ms, "
              f"L={L4} {b4:.5f} ms{' (one cycle)' if name == 'evolve_block' else ''}",
              flush=True)
        out[name] = {"max_abs_err": errs[name],
                     "max_tol_ratio": getattr(errs[name], "ratio", 0.0),
                     "ms_l1": a, f"ms_l{L4}": b,
                     "bound_ms_l1": b1, f"bound_ms_l{L4}": b4}
    return out


def bmm_batch_count(device, N, lanes=4, batches=(4200, 64)):
    """Whether one ``torch.bmm`` over a fleet's lane-major batch gives each
    lane the bits of one call on that lane alone, for the BFGS's products
    (H g, and the two of the H update) at B instances a lane: the reason
    the fleet's BFGS calls bmm once per lane (``_lane_bmm``). Prints what it
    finds; fails on nothing."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    for B in batches:
        def r(*shape):
            return torch.randn(*shape, device=device, generator=g)

        A = r(lanes * B, N, N)
        found = []
        for name, b in (("H g", r(lanes * B, N, 1)), ("A H", r(lanes * B, N, N)),
                        ("A H A^T", r(lanes * B, N, N).transpose(1, 2))):
            whole = torch.bmm(A, b)
            parts = torch.cat([torch.bmm(u, v) for u, v in zip(A.chunk(lanes), b.chunk(lanes))])
            same = torch.equal(whole.view(torch.int32), parts.view(torch.int32))
            found.append(f"{name} {'equal' if same else 'DIFFERENT'} "
                         f"(max abs diff {float((whole - parts).abs().max()):.3g})")
        print(f"bmm over {lanes} lanes x {B} instances x {N} slots against one bmm per lane: "
              + ", ".join(found), flush=True)


def _leg_timer(last_iteration, trace=("const_opt",)):
    """A ``device_search._LEG_WRAP`` that times each evolve and const-opt leg
    on the host clock between two synchronizations, and traces the legs
    named in ``trace`` of iteration ``last_iteration`` under torch.profiler
    (CUDA activity). Returns (wrap, walls {leg: [s]}, idle {leg: (wall s,
    busy s)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls, idle, seen = {}, {}, {}

    def wrap(name):
        seen[name] = nth = seen.get(name, 0) + 1
        if name not in ("evolve", "const_opt"):
            return contextlib.nullcontext()
        traced = name in trace and nth == last_iteration

        @contextlib.contextmanager
        def timed():
            acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
            with profile(activities=acts) if traced else contextlib.nullcontext() as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls.setdefault(name, []).append(wall)
            if traced:
                busy = 0.0
                for ev in prof.key_averages():
                    us = getattr(ev, "self_device_time_total", None)
                    busy += (getattr(ev, "self_cuda_time_total", 0.0) if us is None else us) * 1e-6
                idle[name] = (wall, busy)
        return timed()

    return wrap, walls, idle


def _timed_run(run, last_iteration):
    """``run()`` with its legs timed (``_leg_timer``) and B1-B4 counted from 0;
    returns (its result, (B1, B2, B3, B4, B2v), walls, idle)."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds

    wrap, walls, idle = _leg_timer(last_iteration)
    saved = ds._LEG_WRAP
    ds._LEG_WRAP = wrap
    try:
        out, *counts = _counted(run)
    finally:
        ds._LEG_WRAP = saved
    return out, tuple(counts), walls, idle


def _idle_text(idle):
    wall, busy = idle
    return (f"{1 - busy / wall:.1%} of {wall * 1e3:.3f} ms" if busy > 0
            else "not measured (no device time traced)")


def fleet_multitarget(device, iterations=ENGINE_ITERATIONS, cycles=ENGINE_CYCLES, seed=0):
    """Phase 9 (b): ``multitarget_search`` of the four fleet targets on
    config3's X at config3 width, on the block, and the four solo
    ``scheduler="device"`` runs at seeds ``seed + t``: each lane's frontier
    (complexities, losses, strings) and num_evals equal its solo's; the
    fleet launches B3 once per iteration and B2 no more than one solo; legs
    timed per iteration against the solos' sums, and the const-opt leg's idle
    share in the last iteration. Returns (fleet launches, solo launches, the
    fleet's results), the results for phase 11."""
    from symbolicregression_jl_tpu_torch import equation_search, multitarget_search

    Xn, _ = config3_data()
    Y = fleet_targets(Xn)
    T = Y.shape[0]

    def opts(s):
        return _config3_options(device, s, cycles)

    with engine_block_env(True):
        t0 = time.perf_counter()
        fleet, fl, fwalls, fidle = _timed_run(
            lambda: multitarget_search(Xn, Y, opts(seed), niterations=iterations), iterations)
        fleet_wall = time.perf_counter() - t0
        solos, swalls, sidle = [], [], []
        sl = [0] * len(_kernel_wrappers())
        solo_wall = 0.0
        for t in range(T):
            t0 = time.perf_counter()
            res, counts, walls, idle = _timed_run(
                lambda: equation_search(Xn, Y[t], options=opts(seed + t), niterations=iterations,
                                        verbosity=0), iterations)
            solo_wall += time.perf_counter() - t0
            solos.append(res)
            swalls.append(walls)
            sidle.append(idle)
            sl = [a + b for a, b in zip(sl, counts)]
            if res.engine_stats["block"] != "kernel":
                _fail(f"solo target {t} ran the evolve leg {res.engine_stats['block']!r}")
    for t in range(T):
        if _frontier(fleet[t]) != _frontier(solos[t]):
            _fail(f"multitarget lane {t}: frontier differs from its solo run")
        if fleet[t].num_evals != solos[t].num_evals:
            _fail(f"multitarget lane {t}: num_evals {fleet[t].num_evals} vs solo "
                  f"{solos[t].num_evals}")
    st = fleet[0].engine_stats
    if st["block"] != "kernel":
        _fail(f"the fleet ran the evolve leg {st['block']!r}, not the block")
    if fl[2] != iterations or sl[2] != T * iterations:
        _fail(f"B3 launches: fleet {fl[2]}, solos {sl[2]} (want {iterations} and "
              f"{T * iterations})")
    solo_b2 = [s.engine_stats["grad_calls"] for s in solos]
    if fl[1] != st["fleet"]["grad_calls"] or fl[1] > max(solo_b2):
        _fail(f"B2 launches: fleet {fl[1]} ({st['fleet']['grad_calls']} gradient calls) "
              f"against solos {solo_b2}")
    fleet_score = st["fleet"]["score_calls"] + sum(r.engine_stats["score_calls"] for r in fleet)
    if fl[0] != fleet_score:
        _fail(f"B1 launches: fleet {fl[0]} for {fleet_score} scoring calls")
    print(f"fleet multitarget_search: {T} targets on config3's X (100x100, "
          f"{CONFIG3_ROWS} rows), {iterations} iterations x {cycles} cycles on the block: "
          f"every lane's frontier and num_evals equal its solo run at seed {seed}+t; "
          f"launches fleet B1 {fl[0]}, B2 {fl[1]}, B3 {fl[2]} against the four solos' "
          f"B1 {sl[0]}, B2 {sl[1]}, B3 {sl[2]}; wall fleet {fleet_wall:.3f} s (set-up "
          f"{fleet[0].setup_seconds:.3f} s, main loop "
          f"{max(r.iteration_seconds for r in fleet):.3f} s), the four solos {solo_wall:.3f} s "
          f"(set-up {sum(r.setup_seconds for r in solos):.3f} s, main loops "
          f"{sum(r.iteration_seconds for r in solos):.3f} s)", flush=True)
    for leg in ("evolve", "const_opt"):
        f_ms = [w * 1e3 for w in fwalls[leg]]
        s_ms = [sum(w[leg][i] for w in swalls) * 1e3 for i in range(iterations)]
        print(f"fleet legs, {leg}, host ms between synchronizations per iteration: fleet "
              + ", ".join(f"{v:.3f}" for v in f_ms) + "; sum of the four solos "
              + ", ".join(f"{v:.3f}" for v in s_ms), flush=True)
    print(f"fleet const-opt leg, iteration {iterations}, device idle under torch.profiler: "
          f"fleet {_idle_text(fidle['const_opt'])}; solos "
          + ", ".join(_idle_text(i["const_opt"]) for i in sidle), flush=True)
    for t, r in enumerate(fleet):
        best = min(r.pareto_frontier, key=lambda m: m.loss)
        print(f"  target {t}: best loss {best.loss:.6g}, "
              f"{best.tree.string_tree(r.options.operators)}", flush=True)
    return tuple(fl), tuple(sl), fleet


def fleet_mixed(device, cycles=ENGINE_CYCLES, seed=0):
    """Phase 9 (c): a 6,000-row lane of 3 iterations beside a 10,000-row
    lane of 1 iteration, at config3 width on the block: the short-rowed lane
    equals its solo on its data padded to 10,000 rows (``pad_rows_np``), the
    other its solo with explicit ones weights (a fleet of mixed rows weights
    every lane), and the 1-iteration lane stops while the other goes on.
    Returns (fleet launches, solo launches)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search
    from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np

    Xn, _ = config3_data()
    Y = fleet_targets(Xn)

    def opts(s):
        return Options(populations=100, population_size=100, maxsize=20,
                       ncycles_per_iteration=cycles, seed=s, save_to_file=False, progress=False,
                       device=str(device), scheduler="device", **CONFIG3_OPS)

    short_X, short_y = np.ascontiguousarray(Xn[:, :6000]), np.ascontiguousarray(Y[1][:6000])
    with engine_block_env(True):
        res, *fl = _counted(lambda: fleet_search([
            FleetLaneSpec(X=short_X, y=short_y, options=opts(seed + 1), niterations=3),
            FleetLaneSpec(X=Xn, y=Y[0], options=opts(seed), niterations=1),
        ]))
        Xp, yp, wp = pad_rows_np(short_X, short_y, None, CONFIG3_ROWS)
        solo_a, *sa = _counted(lambda: equation_search(Xp, yp, weights=wp, options=opts(seed + 1),
                                                        niterations=3, verbosity=0))
        solo_b, *sb = _counted(lambda: equation_search(
            Xn, Y[0], weights=np.ones(CONFIG3_ROWS, np.float32), options=opts(seed),
            niterations=1, verbosity=0))
    for tag, got, want in (("6,000-row lane (3 iterations)", res[0], solo_a),
                           ("10,000-row lane (1 iteration)", res[1], solo_b)):
        if _frontier(got) != _frontier(want) or got.num_evals != want.num_evals:
            _fail(f"fleet, mixed rows and budgets: the {tag} differs from its solo run")
    iters = [r.engine_stats["iterations"] for r in res]
    if iters != [3, 1] or fl[2] != 3:
        _fail(f"fleet, mixed budgets: lanes ran {iters} iterations in {fl[2]} B3 launches")
    print(f"fleet, mixed rows and budgets (6,000 rows x 3 iterations beside 10,000 rows x 1, "
          f"config3 width, on the block): each lane equal to its solo run on the padded, "
          f"weighted data (frontier and num_evals); launches fleet B1 {fl[0]}, B2 {fl[1]}, B3 "
          f"{fl[2]}; solos B1 {sa[0] + sb[0]}, B2 {sa[1] + sb[1]}, B3 {sa[2] + sb[2]}",
          flush=True)
    return tuple(fl), tuple(a + b for a, b in zip(sa, sb))


def fleet_event_leg(device, iterations=2, cycles=100, seed=0):
    """Phase 9 (d): two lanes at the quick start's size (200 x 2, 15 x 33,
    ``+ - *``, ``cos``) with ``SR_ENGINE_BLOCK=0``: the event leg runs lane
    after lane, the const-opt leg once for both; each lane equals its solo
    run. Cycles cut from 550 to ``cycles``. Returns (fleet launches, solo
    launches)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    ys = [(2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32),
          (X[0] * X[1] + np.cos(X[0])).astype(np.float32)]

    def opts(s):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       ncycles_per_iteration=cycles, seed=s, save_to_file=False, progress=False,
                       device=str(device), scheduler="device")

    with engine_block_env(False):
        t0 = time.perf_counter()
        res, *fl = _counted(lambda: fleet_search(
            [FleetLaneSpec(X=X, y=ys[t], options=opts(seed + t), niterations=iterations)
             for t in range(2)]))
        fleet_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        solos, *sl = _counted(lambda: [equation_search(X, ys[t], options=opts(seed + t),
                                                       niterations=iterations, verbosity=0)
                                       for t in range(2)])
        solo_wall = time.perf_counter() - t0
    for t in range(2):
        if _frontier(res[t]) != _frontier(solos[t]) or res[t].num_evals != solos[t].num_evals:
            _fail(f"fleet, event leg: lane {t} differs from its solo run")
    if res[0].engine_stats["block"] is not None or fl[2] != 0:
        _fail("fleet, event leg: the block ran")
    print(f"fleet, event leg (SR_ENGINE_BLOCK=0; quick start's size, 2 lanes x {iterations} "
          f"iterations x {cycles} cycles): each lane equal to its solo run; wall fleet "
          f"{fleet_wall:.3f} s, two solos {solo_wall:.3f} s; launches fleet B1 {fl[0]}, B2 "
          f"{fl[1]}; solos B1 {sl[0]}, B2 {sl[1]}", flush=True)
    return tuple(fl), tuple(sl)


class _Gate:
    """Holds a stream session's engine at every iteration boundary (its
    iteration callback) until the caller lets it go on, so that a staged
    update lands at a chosen iteration; ``step`` returns the host seconds
    of each iteration it let through (release to the next boundary)."""

    def __init__(self):
        import threading

        self.release = threading.Semaphore(0)
        self.arrived = threading.Semaphore(0)

    def cb(self, report):
        self.arrived.release()
        self.release.acquire()
        return None

    def step(self, sess, n=1, timeout=600):
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            self.release.release()
            if not self.arrived.acquire(timeout=timeout):
                _fail(f"stream: no iteration boundary within {timeout} s ({sess.error})")
            walls.append(time.perf_counter() - t0)
        return walls

    def drain(self, sess, timeout=600):
        """Stop the session at its next boundary and wait for its end."""
        sess.request_stop()
        self.release.release()
        if not sess.wait(timeout=timeout):
            _fail("stream: the session did not stop")
        while self.arrived.acquire(timeout=0.01):
            self.release.release()
        return sess.stop()


def _timed_calls(obj, name, calls):
    """Wrap the bound method ``obj.name`` on the instance so that each call
    appends (its host seconds, its result) to ``calls``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, timed)


@contextlib.contextmanager
def _block_launches():
    """While open, every B3 launch the engine makes is counted under the name
    of the thread that made it (a stream session's engine thread, a server's
    workers launching at once), with that thread's last launch's arguments
    (the population and scalars the prologue built, the data views, the
    config): {thread: [launches, args]}."""
    import threading

    from symbolicregression_jl_tpu_torch.models import device_search

    real = device_search.evolve_block
    seen, lock = {}, threading.Lock()

    def counted(*args):
        with lock:
            rec = seen.setdefault(threading.current_thread().name, [0, None])
            rec[0] += 1
            rec[1] = args
        return real(*args)

    device_search.evolve_block = counted
    try:
        yield seen
    finally:
        device_search.evolve_block = real


def stream_kernel_check(device, tag, lane, block_args=None, probe=None, block_cycles=8):
    """Phase 10's kernel check at the shapes the session gives B1, B2 and
    B3, while the engine is held at an iteration boundary: B1 and B2 on the
    lane's resident rows (the whole bucket, pad rows at weight 0) at the
    rescore's shape (the hall of fame's frontier trees) and at the BFGS's
    (4,200 random config3 programs); B1 on the drift probe's rows
    (``probe``: the incoming X, y, at weight 1) with the best member; B3 on
    the inputs of the engine's last launch (``block_args``: its
    population, scalars and lane-axis data), cut to ``block_cycles``
    cycles as phase 3's check. Each against its plain version at the
    smoke's tolerances; these launches are not counted. Returns {kernel:
    max abs err}."""
    import dataclasses

    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference, fused_loss_reference,
        pack_programs_fused,
    )

    saved = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    opts, data = lane.options, lane.data
    opset, N, loss = opts.operators, lane.cfg.n_slots, opts.loss
    F, R = data.X.shape
    frontier = lane.hof.pareto_frontier()
    if not frontier:
        _fail(f"stream kernel check {tag}: an empty frontier")
    best = min(frontier, key=lambda m: m.loss)
    errs = {"fused_loss": 0.0, "fused_loss_grad": 0.0}

    def on_card(prog_np, vals_np):
        return torch.from_numpy(prog_np).to(device), torch.from_numpy(vals_np).to(device)

    cases = [(f"{len(frontier)} frontier trees",
              *on_card(*pack_programs_fused(flatten_trees([m.tree for m in frontier], N),
                                            opset))),
             ("4200 BFGS-shape programs", *on_card(*random_programs(opset, 4200, N, F,
                                                                     seed=4200)))]
    for what, prog, vals in cases:
        name = f"stream {tag}: {what} x {R} rows"
        got = fused_loss(prog, vals, data.X, data.y, data.w, opset, loss)
        ref = fused_loss_reference(prog, vals, data.X, data.y, data.w, opset, loss)
        gl, gg = fused_loss_grad(prog, vals, data.X, data.y, data.w, opset, loss)
        rl, rg = fused_loss_grad_reference(prog, vals, data.X, data.y, data.w, opset, loss)
        torch.cuda.synchronize()
        errs["fused_loss"] = worst_err(errs["fused_loss"], compare(f"B1 {name}", got, ref))
        errs["fused_loss_grad"] = worst_err(errs["fused_loss_grad"],
                                            compare(f"B2 {name}", gl, rl),
                                            compare(f"B2 vs B1 {name}", gl, got),
                                            compare_grads(f"B2 {name}", gg, rg))
    shapes = [f"B1 and B2 on {R} rows x ({', '.join(c[0] for c in cases)})"]
    if probe is not None:
        Xp, yp = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in probe)
        wp = torch.ones_like(yp)
        prog, vals = on_card(*pack_programs_fused(flatten_trees([best.tree], N), opset))
        got = fused_loss(prog, vals, Xp, yp, wp, opset, loss)
        ref = fused_loss_reference(prog, vals, Xp, yp, wp, opset, loss)
        torch.cuda.synchronize()
        errs["fused_loss"] = worst_err(errs["fused_loss"],
                                       compare(f"B1 stream {tag}: the probe on {yp.numel()} rows",
                                               got, ref))
        shapes.append(f"B1 on the probe's {yp.numel()} rows x 1 tree")
    if block_args is not None:
        cfg = dataclasses.replace(block_args[14], ncycles=block_cycles)
        args = (*block_args[:14], cfg, *block_args[15:])
        got = evolve_block(*args)
        ref = evolve_block_reference(*args)
        torch.cuda.synchronize()
        errs["evolve_block"] = compare_block(f"B3 stream {tag}", got, ref)
        X = block_args[11]
        shapes.append(f"B3 on the engine's last launch's inputs ({block_args[0].shape[0]} "
                      f"islands, X {list(X.shape)}, weighted), {block_cycles} cycles")
    fused_loss.launches, fused_loss_grad.launches, evolve_block.launches = saved
    print(f"stream kernel check {tag}: " + "; ".join(shapes) + " within tolerance of the "
          "plain versions; max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
          flush=True)
    return errs


def stream_session_config3(device, cycles=ENGINE_CYCLES, seed=0,
                           rows=(8000, 9000, 10_000, 11_000), bucket=10_240, width=100):
    """Phase 10 (a)-(d): one ``StreamSession`` at config3 width (100 x 100,
    maxsize 20, ``cycles`` cycles, ``row_bucket=10_240``, on the block)
    from config3's rows 0-7,999, gated at every iteration boundary. (a) rows
    8,000-8,999 and 9,000-9,999 pushed in the bucket: the lane's tensors
    keep their pointers, no kernel is built, B3 runs once per iteration, the
    resident y equals the padded host y bit for bit; (b) at iteration 5 a
    replace with the same X and ``fleet_targets``' third law: drift, a
    rescore whose best loss is above twice the fitted one, two more
    iterations with a finite frontier; (c) rows 10,000-10,999 pushed: one
    restart on a 16,384-row bucket with the same hall of fame, one iteration
    there (the event leg: above the block's row cap); (d) every frame decodes
    with niterations 0 and the stop is a callback stop. After the second
    push and in epoch 2, ``stream_kernel_check`` holds B1, B2 and (on the
    block) B3 against their plain versions at the shapes the session gives
    them. Returns the B3 launches and {kernel: max abs err} of those
    checks."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np
    from symbolicregression_jl_tpu_torch.stream import StreamSession, next_row_bucket
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    n0, n1, n2, n3 = rows
    X, y = config3_data(n_rows=n3)
    y_shift = fleet_targets(X)[2]
    gate = _Gate()
    frames = []
    opts = Options(populations=width, population_size=width, maxsize=20,
                   ncycles_per_iteration=cycles, seed=seed, save_to_file=False, progress=False,
                   device=str(device), scheduler="device", warmup_maxsize_by=0.0,
                   iteration_callback=gate.cb, **CONFIG3_OPS)
    builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    hook_s, probe_s, rescore_s = [], [], []

    def swap_ms(calls):
        return [sec * 1e3 for sec, upd in calls if upd is not None]

    with engine_block_env(True), _block_launches() as captured:
        sess = StreamSession(X[:, :n0], y[:n0], opts, row_bucket=bucket,
                             on_frame=frames.append)
        _timed_calls(sess, "_hook", hook_s)
        _timed_calls(sess, "_probe_best_loss", probe_s)
        _timed_calls(sess, "_rescore_frontier", rescore_s)
        b3_0 = evolve_block.launches
        t0 = time.perf_counter()
        sess.start()
        if not gate.arrived.acquire(timeout=600):
            _fail(f"stream: no first iteration ({sess.error})")
        first_s = time.perf_counter() - t0
        lane = sess._lane
        ptrs = tuple(t.data_ptr() for t in lane.data)
        if lane.block_mode != "kernel":
            _fail(f"stream: the {bucket}-row bucket ran the evolve leg {lane.block_mode!r}")
        before = gate.step(sess)

        def check_swap(tag, n_rows, iterations):
            if tuple(t.data_ptr() for t in lane.data) != ptrs:
                _fail(f"stream {tag}: the lane's tensors moved")
            if {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()} != builds:
                _fail(f"stream {tag}: a kernel was built")
            if evolve_block.launches - b3_0 != iterations:
                _fail(f"stream {tag}: {evolve_block.launches - b3_0} B3 launches in "
                      f"{iterations} iterations")
            _, yp, wp = pad_rows_np(X[:, :n_rows], y[:n_rows], None, bucket)
            if not (torch.equal(lane.data.y.cpu(), torch.from_numpy(yp))
                    and torch.equal(lane.data.w.cpu(), torch.from_numpy(wp))):
                _fail(f"stream {tag}: the resident y/w differ from the padded host rows")

        # (a) two pushes in the bucket, up to config3's 10,000 rows
        sess.push_rows(X[:, n0:n1], y[n0:n1])
        swap_walls = gate.step(sess)
        check_swap(f"push {n0}-{n1 - 1}", n1, 3)
        sess.push_rows(X[:, n1:n2], y[n1:n2])
        swap_walls += gate.step(sess)
        check_swap(f"push {n1}-{n2 - 1}", n2, 4)
        # the session's engine thread made every B3 launch so far
        (block_args,) = [rec[1] for rec in captured.values()]
        errs = [stream_kernel_check(device, f"(a), {n2} rows on the {bucket}-row bucket", lane,
                                    block_args, probe=(X[:, n1:n2], y[n1:n2]))]
        after = gate.step(sess)
        st = sess.stats
        if st.updates_applied != 2 or st.recompile_events != 0 or st.rows != n2:
            _fail(f"stream (a): {st.summary()}")
        print(f"stream (a), config3 width ({width}x{width}, {cycles} cycles, bucket {bucket} rows, "
              f"block {lane.block_mode}): first iteration (set-up included) {first_s:.3f} s; "
              f"ms per iteration before the swaps {before[0] * 1e3:.3f}, at the two swaps "
              + ", ".join(f"{w * 1e3:.3f}" for w in swap_walls)
              + f", after {after[0] * 1e3:.3f}; hook host ms per push "
              + ", ".join(f"{v:.3f}" for v in swap_ms(hook_s))
              + "; the lane's X/y/w/norm kept their pointers, no kernel built, B3 once per "
              f"iteration ({evolve_block.launches - b3_0} in 5), the resident y and w equal "
              "the padded host rows bit for bit", flush=True)

        # (b) drift: the same X, another law
        best_before = min(m.loss for m in sess.frontier())
        obs = sess._detector.observations
        if obs < sess._detector.config.min_obs:
            _fail(f"stream (b): {obs} observations before the replace")
        sess.replace_rows(X[:, :n2], y_shift[:n2])
        drift_walls = gate.step(sess, 3)
        st = sess.stats
        if st.drifts < 1 or st.rescores < 1:
            _fail(f"stream (b): no drift response: {st.summary()}")
        if not st.last_rescore_best > 2 * best_before:
            _fail(f"stream (b): rescored best {st.last_rescore_best} not above twice "
                  f"{best_before}")
        fr = sess.frontier()
        if not fr or not all(np.isfinite(m.loss) for m in fr):
            _fail("stream (b): the frontier after the drift is not finite")
        _, yp, _ = pad_rows_np(X[:, :n2], y_shift[:n2], None, bucket)
        if not torch.equal(lane.data.y.cpu(), torch.from_numpy(yp)):
            _fail("stream (b): the resident y is not the replaced target")
        print(f"stream (b), drift at iteration {st.iterations - 2}: best frontier loss "
              f"{best_before:.6g} before, {st.last_rescore_best:.6g} rescored on the new law "
              f"(drifts {st.drifts}, rescores {st.rescores}), "
              f"{min(m.loss for m in fr):.6g} two iterations later; hook host ms "
              f"{swap_ms(hook_s)[-1]:.3f} (probe {probe_s[-1][0] * 1e3:.3f}, rescore "
              f"{rescore_s[-1][0] * 1e3:.3f}); ms per iteration "
              + ", ".join(f"{w * 1e3:.3f}" for w in drift_walls), flush=True)

        # (c) overflow: 11,000 rows, a restart on the next bucket
        hof = sess.hof
        sess.push_rows(X[:, n2:], y_shift[n2:])
        grow_walls = gate.step(sess)
        b3_epoch1 = evolve_block.launches - b3_0
        if b3_epoch1 != sess.stats.iterations:
            _fail(f"stream (c): {b3_epoch1} B3 launches in {sess.stats.iterations} iterations")
        grow_walls += gate.step(sess)
        st = sess.stats
        lane2 = sess._lane
        errs.append(stream_kernel_check(
            device, f"(c), {n3} rows on the {lane2.dataset.n}-row bucket", lane2))
        if st.recompile_events != 1 or st.epochs != 2 or st.row_bucket != next_row_bucket(n3):
            _fail(f"stream (c): {st.summary()}")
        if sess.hof is not hof or lane2 is lane or lane2.hof is not hof:
            _fail("stream (c): the restart did not keep the hall of fame")
        if lane2.dataset.n != st.row_bucket or st.rows != n3:
            _fail(f"stream (c): {lane2.dataset.n} rows on the lane, {st.rows} in the session")
        b3_epoch2 = evolve_block.launches - b3_0 - b3_epoch1
        res = gate.drain(sess)
    if sess.error is not None or res is None or res.stop_reason != "callback":
        _fail(f"stream (d): stop {getattr(res, 'stop_reason', None)!r}, error {sess.error}")
    if res.engine_stats["block"] != lane2.block_mode or res.engine_stats["iterations"] < 1:
        _fail(f"stream (c): epoch 2 {res.engine_stats}")
    print(f"stream (c), overflow to {n3} rows: restart on a {st.row_bucket}-row bucket "
          f"(recompile_events {st.recompile_events}, epochs {st.epochs}, the same hall of "
          f"fame); evolve leg epoch 1 block {lane.block_mode!r} ({b3_epoch1} B3 launches), "
          f"epoch 2 block {lane2.block_mode!r} ({b3_epoch2} B3 launches, "
          f"{res.engine_stats['iterations']} iterations); ms per iteration at the boundary "
          f"and in epoch 2: " + ", ".join(f"{w * 1e3:.3f}" for w in grow_walls), flush=True)
    if not frames:
        _fail("stream (d): no frame")
    for f in frames:
        upd = load_frontier_bytes(f)
        if upd.niterations != 0 or not upd.members:
            _fail(f"stream (d): frame at iteration {upd.iteration}: niterations "
                  f"{upd.niterations}, {len(upd.members)} members")
    print(f"stream (d): {len(frames)} frames, each decoded with niterations 0; stop reason "
          f"{res.stop_reason!r}; session {sess.stats.summary()}", flush=True)
    return b3_epoch1 + b3_epoch2, {k: worst_err(*(e.get(k, 0.0) for e in errs))
                                   for k in errs[0]}


def stream_noop(device, seed=0):
    """Phase 10 (e): the README quick start's size (200 x 2, ``+ - *``,
    ``cos``, 15 x 33, default cycles) as a session on a 256-row bucket, run
    twice with one seed; in one run ``replace_rows`` re-stages the identical
    rows at iteration 1. Then 3 more iterations: the two frontiers are
    identical string for string. Returns the B3 launches."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.stream import StreamSession

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    fronts, b3 = [], evolve_block.launches
    t0 = time.perf_counter()
    with engine_block_env(True):
        for touch in (False, True):
            gate = _Gate()
            opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=seed,
                           save_to_file=False, progress=False, device=str(device),
                           scheduler="device", iteration_callback=gate.cb)
            sess = StreamSession(X, y, opts, row_bucket=256)
            sess.start()
            if not gate.arrived.acquire(timeout=600):
                _fail(f"stream (e): no first iteration ({sess.error})")
            if touch:
                sess.replace_rows(X, y)
            gate.step(sess, 3)
            res = gate.drain(sess)
            if sess.error is not None or sess.stats.updates_applied != int(touch):
                _fail(f"stream (e): {sess.error}, {sess.stats.summary()}")
            fronts.append(_frontier(res))
    if fronts[0] != fronts[1]:
        _fail("stream (e): an identical replace_rows changed the frontier")
    print(f"stream (e), the quick start's size on a 256-row bucket, 1 + 3 iterations twice: "
          f"an identical replace_rows at iteration 1 leaves the frontier identical "
          f"({len(fronts[0])} members); {time.perf_counter() - t0:.3f} s", flush=True)
    return evolve_block.launches - b3


def stream_path(device):
    """Phase 10: the stream session. Returns its (B1, B2, B3, B4, B2v) launches,
    the path "stream", and {kernel: max abs err} of its kernel checks."""
    t0 = time.perf_counter()
    zero_launches()
    b3, errs = stream_session_config3(device)
    b3 += stream_noop(device)
    counts = read_launches()
    if counts[2] != b3 or not (counts[0] and counts[1]):
        _fail(f"stream: launches B1, B2, B3 {counts} (B3 counted per run: {b3})")
    print(f"stream phase: {time.perf_counter() - t0:.3f} s; launches B1 {counts[0]}, B2 "
          f"{counts[1]}, B3 {counts[2]}, B4 {counts[3]}", flush=True)
    return counts, errs


def fleet_path(device):
    """Phase 9: the fleet. (a) the lane-axis kernels, (b) multitarget_search
    at config3 width, (c) mixed rows and budgets, (d) the event leg. Returns
    ({kernel name: lane-axis record}, {path: (B1, B2, B3 launches)}, (b)'s
    results): the fleet runs under "fleet", their solo references under
    "fleet solos"; B4's count as the fourth."""
    t0 = time.perf_counter()
    lanes = fleet_kernel_check(device)
    *multitarget, results = fleet_multitarget(device)
    fleets, solos = zip(multitarget, fleet_mixed(device), fleet_event_leg(device))
    paths = {"fleet": tuple(map(sum, zip(*fleets))),
             "fleet solos": tuple(map(sum, zip(*solos)))}
    print(f"fleet phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return lanes, paths, results


# ---------------------------------------------------------------------------
# Phase 11: the server
# ---------------------------------------------------------------------------

def _config3_options(device, seed, cycles=ENGINE_CYCLES, **kw):
    """config3's Options at full width (phase 9 (b)'s and phase 11's)."""
    from symbolicregression_jl_tpu_torch import Options

    return Options(populations=100, population_size=100, maxsize=20,
                   ncycles_per_iteration=cycles, seed=seed, save_to_file=False, progress=False,
                   device=str(device), scheduler="device", **CONFIG3_OPS, **kw)


def _quick_start_problem(device, seed):
    """The README quick start (200 x 2 feature-major, ``+ - *``, ``cos``,
    default 15 x 33 and cycles) as (X, y, Options)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y, Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=seed,
                         save_to_file=False, progress=False, device=str(device),
                         scheduler="device")


def _job_times(tag, job):
    """One job's serving latencies, host clock: queue wait (submit to its
    first start), time to first frame, submit to terminal."""
    wait = None if job.started_at is None else job.started_at - job.submitted_at
    return (f"{tag} {job.id}: {job.state}, queue wait "
            + ("-" if wait is None else f"{wait * 1e3:.3f} ms")
            + ", first frame " + ("-" if job.ttff is None else f"{job.ttff * 1e3:.3f} ms")
            + f", submit to {job.state} {(job.finished_at - job.submitted_at) * 1e3:.3f} ms")


def _check_frames(tag, srv, job, iterations, n_frames):
    """A finished search streamed ``n_frames`` frames (a search of its own:
    one per iteration and the final one; a collapsed rider: the final one),
    and its last frame decodes to its frontier's losses."""
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    frames = srv.frames(job.id)
    if len(frames) != n_frames:
        _fail(f"serve {tag}: {len(frames)} frames for {iterations} iterations")
    last = load_frontier_bytes(frames[-1])
    got = sorted(m.loss for m in last.members)
    if last.iteration != iterations or got != sorted(m.loss for m in job.result.pareto_frontier):
        _fail(f"serve {tag}: the last frame (iteration {last.iteration}) is not the frontier")


def serve_fleet_and_collapse(device, fleet_ref, direct, iterations=ENGINE_ITERATIONS,
                             qs_iterations=DEVICE_QUICKSTART_ITERATIONS, seed=0):
    """Phase 11 (a), (b) and (e): one ``SearchServer(max_concurrency=2,
    fleet=True)``. With admission paused, the four ``fleet_targets`` jobs of
    phase 9 (b) (config3 width, seeds seed + t, ``iterations`` on the block)
    and two identical jobs at the quick start's size are submitted; resumed,
    the config3 jobs run as ONE fleet on one worker while the pair runs as
    one lane on the other. (a) one B3 launch per block iteration for the
    fleet, each job's frontier and num_evals bit for bit phase 9 (b)'s lane,
    one frame per iteration and the final one; (b) the pair collapsed (one
    search), both DONE with the frontier of ``direct``, the same search run
    directly, then a third quick-start job with another seed hits the
    program cache's ``score_data`` entry of that dataset; (e) B3 on the
    fleet's last launch's inputs against its plain version. Returns (its B3
    launches, B3's max abs err, the server's stats)."""
    import dataclasses

    import torch

    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, SearchServer

    Xn, _ = config3_data()
    Y = fleet_targets(Xn)
    Xq, yq, oq = _quick_start_problem(device, seed)
    with engine_block_env(True), _block_launches() as b3, SearchServer(
            max_concurrency=2, fleet=True, default_quota=8) as srv:
        srv.pause_admission()
        fleet_ids = [srv.submit(JobSpec(Xn, Y[t], options=_config3_options(device, seed + t),
                                        niterations=iterations, label=f"target-{t}"))
                     for t in range(Y.shape[0])]
        pair = [srv.submit(JobSpec(Xq, yq, options=oq, niterations=qs_iterations,
                                   label="quick start")) for _ in range(2)]
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=600) for i in fleet_ids + pair]
        for job in jobs:
            if job.state != DONE:
                _fail(f"serve (a)/(b): {job.summary()}")
        cache0 = srv.stats()["program_cache"]["by_kind"]["score_data"]
        launches = {name: rec[0] for name, rec in b3.items()}
        # (e)'s inputs: the fleet's last launch (the lane axis: X [L, F, R])
        fleet_args = [rec[1] for rec in b3.values() if rec[1][11].dim() == 3]
        third = srv.wait(srv.submit(JobSpec(Xq, yq, options=dataclasses.replace(oq, seed=seed + 7),
                                            niterations=qs_iterations, label="third")),
                         timeout=600)
        cache1 = srv.stats()["program_cache"]["by_kind"]["score_data"]
        stats = srv.stats()
        third_b3 = sum(rec[0] for rec in b3.values()) - sum(launches.values())
    if third.state != DONE:
        _fail(f"serve (b): the third job {third.summary()}")
    fleet_jobs, pair_jobs = jobs[:len(fleet_ids)], jobs[len(fleet_ids):]
    for t, job in enumerate(fleet_jobs):
        if _frontier(job.result) != _frontier(fleet_ref[t]) or (
                job.result.num_evals != fleet_ref[t].num_evals):
            _fail(f"serve (a): job {job.id} (target {t}) differs from phase 9 (b)'s lane")
        if job.result.engine_stats["fleet"]["lanes"] != len(fleet_ids):
            _fail(f"serve (a): job {job.id} ran in a fleet of "
                  f"{job.result.engine_stats['fleet']['lanes']}")
        _check_frames(f"(a) target {t}", srv, job, iterations, iterations + 1)
    for job, n_frames in zip(pair_jobs, (qs_iterations + 1, 1)):
        if _frontier(job.result) != _frontier(direct) or job.result.num_evals != direct.num_evals:
            _fail(f"serve (b): collapsed job {job.id} differs from the direct run")
        _check_frames("(b) quick start", srv, job, qs_iterations, n_frames)
    _check_frames("(b) third", srv, third, qs_iterations, qs_iterations + 1)
    fl = stats["fleet"]
    if fl["batches"] != 2 or fl["coalesced_lanes"] != 6 or fl["deduped_lanes"] != 1:
        _fail(f"serve (a)/(b): fleet stats {fl}")
    if cache1["hits"] <= cache0["hits"] or cache1["misses"] != cache0["misses"]:
        _fail(f"serve (b): the third job's score_data {cache0} -> {cache1}")
    if sorted(launches.values()) != sorted([iterations, qs_iterations]) or (
            third_b3 != qs_iterations):
        _fail(f"serve (a)/(b): B3 launches by worker {launches}, then {third_b3} (want "
              f"{iterations} for the fleet, {qs_iterations} for the pair's one search and for "
              "the third job)")
    if len(fleet_args) != 1:
        _fail(f"serve (e): {len(fleet_args)} workers made lane-axis B3 launches")
    args = fleet_args[0]
    # (e): B3 on the fleet's last launch, cut to 8 cycles as phase 3's check;
    # this launch is not counted
    saved = evolve_block.launches
    cfg = dataclasses.replace(args[14], ncycles=8)
    a = (*args[:14], cfg, *args[15:])
    got = evolve_block(*a)
    ref = evolve_block_reference(*a)
    torch.cuda.synchronize()
    err = compare_block("B3 serve (e): the fleet's last launch", got, ref)
    evolve_block.launches = saved
    for job in jobs + [third]:
        print("  " + _job_times("serve", job), flush=True)
    print(f"serve (a): {len(fleet_ids)} config3 jobs (100x100, {CONFIG3_ROWS} rows, "
          f"{iterations} iterations on the block) as one fleet, each equal to phase 9 (b)'s "
          f"lane bit for bit, {iterations + 1} frames each; (b) two identical quick-start jobs "
          f"as one search, equal to the direct run; the third job hit score_data "
          f"({cache0['hits']} -> {cache1['hits']} hits, misses {cache1['misses']}); B3 launches "
          f"by worker {launches}, then {third_b3}; (e) B3 on the fleet's last launch ({args[0].shape[0]} "
          f"islands, X {list(args[11].shape)}), 8 cycles: max abs err {err:.3e}", flush=True)
    return sum(launches.values()) + third_b3, err, stats


def serve_preempt(device, iterations=6, qs_iterations=DEVICE_QUICKSTART_ITERATIONS, seed=0):
    """Phase 11 (c): ``max_concurrency=1``; a priority-0 config3 job of
    ``iterations`` is held at its first iteration boundary until a
    priority-1 quick-start job is submitted: the config3 job is snapshotted
    into the spool (host ms), requeued, and resumed after the other job; it
    ends DONE with all its iterations and more evaluations than at its
    snapshot. Returns (the snapshot's host ms, the B3 launches)."""
    import threading

    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, SearchServer
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_checkpoint

    Xn, yn = config3_data()
    Xq, yq, oq = _quick_start_problem(device, seed + 1)
    arrived, go = threading.Event(), threading.Event()

    def hold(report):
        if report.iteration == 1 and not go.is_set():
            arrived.set()
            go.wait(600)
        return None

    snaps = []
    with engine_block_env(True), _block_launches() as b3, SearchServer(max_concurrency=1) as srv:
        _timed_calls(srv, "_spool_snapshot", snaps)
        low = srv.submit(JobSpec(Xn, yn, options=_config3_options(device, seed,
                                                                   iteration_callback=hold),
                                 niterations=iterations, priority=0, label="config3"))
        if not arrived.wait(600):
            _fail("serve (c): the config3 job never reached an iteration boundary")
        high = srv.submit(JobSpec(Xq, yq, options=oq, niterations=qs_iterations, priority=1,
                                  label="quick start"))
        go.set()
        hj, lj = srv.wait(high, timeout=600), srv.wait(low, timeout=600)
        if hj.state != DONE or lj.state != DONE:
            _fail(f"serve (c): {hj.summary()} {lj.summary()}")
        snap = load_checkpoint(lj.resume_path)
        preemptions = lj.preemptions
        launches = sum(rec[0] for rec in b3.values())
    if preemptions != 1 or len(snaps) != 1 or lj.iterations_done != iterations:
        _fail(f"serve (c): preemptions {preemptions}, snapshots {len(snaps)}, iterations "
              f"{lj.iterations_done}")
    if not lj.result.num_evals > snap.num_evals or not hj.finished_at <= lj.finished_at:
        _fail(f"serve (c): num_evals {lj.result.num_evals} after a snapshot at "
              f"{snap.num_evals}")
    if lj.result.engine_stats["block"] != "kernel" or launches != iterations + qs_iterations:
        _fail(f"serve (c): the resumed run's evolve leg {lj.result.engine_stats['block']!r}, "
              f"{launches} B3 launches")
    snap_ms = snaps[0][0] * 1e3
    for job in (lj, hj):
        print("  " + _job_times("serve", job), flush=True)
    print(f"serve (c): config3 job preempted at iteration {snap.iteration} by a priority-1 "
          f"job, snapshot {snap_ms:.3f} ms of host time, resumed after it: DONE at "
          f"{lj.iterations_done} iterations, num_evals {snap.num_evals:.0f} at the snapshot, "
          f"{lj.result.num_evals:.0f} at the end; B3 {launches}", flush=True)
    return snap_ms, launches


def serve_subscription(device, rows=(8000, 10_000), bucket=10_240, seed=0):
    """Phase 11 (d): a subscription on config3's first ``rows[0]`` rows at
    config3 width (``row_bucket=10_240``, the block); after its first frame
    rows ``rows[0]``-``rows[1] - 1`` are pushed, and once they are resident
    and another frame has come, the client cancels: DONE with at least two
    frames, B3 once per block iteration, no kernel built. Returns the B3
    launches."""
    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, SearchServer

    n0, n1 = rows
    X, y = config3_data(n_rows=n1)
    builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    with engine_block_env(True), _block_launches() as b3, SearchServer(max_concurrency=1) as srv:
        jid = srv.submit(JobSpec(X[:, :n0], y[:n0],
                                 options=_config3_options(device, seed, warmup_maxsize_by=0.0),
                                 kind="subscription", stream_config={"row_bucket": bucket}))
        stream = iter(srv.stream(jid, timeout=600))
        if next(stream, None) is None:
            _fail("serve (d): no first frame")
        srv.push_rows(jid, X[:, n0:], y[n0:])
        job = srv.job(jid)
        deadline = time.monotonic() + 600
        while job.session.stats.rows != n1 or len(srv.frames(jid)) < 3:
            if time.monotonic() > deadline or job.terminal:
                _fail(f"serve (d): {job.summary()}")
            time.sleep(0.01)
        srv.cancel(jid)
        job = srv.wait(jid, timeout=600)
        launches = sum(rec[0] for rec in b3.values())
    st = job.session.stats
    if job.state != DONE or job.stop_reason != "cancelled" or len(job.frames) < 2:
        _fail(f"serve (d): {job.summary()}")
    if launches != st.iterations or st.recompile_events or job.session._lane.block_mode != "kernel":
        _fail(f"serve (d): {launches} B3 launches in {st.iterations} iterations, "
              f"{st.summary()}")
    if {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()} != builds:
        _fail("serve (d): a kernel was built")
    print("  " + _job_times("serve", job), flush=True)
    print(f"serve (d): subscription on {n0} rows (bucket {bucket}, the block), {n1 - n0} rows "
          f"pushed after the first frame, cancelled: DONE with {len(job.frames)} frames, "
          f"{st.iterations} iterations, B3 {launches}, no kernel built", flush=True)
    return launches


def serve_path(device, fleet_ref):
    """Phase 11: the server. ``fleet_ref``: phase 9 (b)'s results. Returns
    its (B1, B2, B3, B4, B2v) launches, the path "serve", and B3's max abs err."""
    from symbolicregression_jl_tpu_torch import equation_search

    t0 = time.perf_counter()
    # the reference of (b): the quick start's search run directly
    Xq, yq, oq = _quick_start_problem(device, 0)
    with engine_block_env(True):
        direct = equation_search(Xq, yq, options=oq, niterations=DEVICE_QUICKSTART_ITERATIONS,
                                 verbosity=0)
    zero_launches()
    b3_ab, err, stats = serve_fleet_and_collapse(device, fleet_ref, direct)
    snap_ms, b3_c = serve_preempt(device)
    b3_d = serve_subscription(device)
    counts = read_launches()
    if counts[2] != b3_ab + b3_c + b3_d or not (counts[0] and counts[1]):
        _fail(f"serve: launches B1, B2, B3 {counts} (B3 counted per part: "
              f"{b3_ab}, {b3_c}, {b3_d})")
    cache = stats["program_cache"]
    print(f"serve stats (a)/(b): fleet batches {stats['fleet']['batches']}, coalesced lanes "
          f"{stats['fleet']['coalesced_lanes']}, collapsed riders "
          f"{stats['fleet']['deduped_lanes']}; program cache hits {cache['hits']}, misses "
          f"{cache['misses']}, entries {cache['entries']}, {cache['data_bytes']} bytes; "
          f"(c) preemptions 1, snapshot {snap_ms:.3f} ms", flush=True)
    print(f"serve phase: {time.perf_counter() - t0:.3f} s; launches B1 {counts[0]}, B2 "
          f"{counts[1]}, B3 {counts[2]}, B4 {counts[3]}", flush=True)
    return counts, err


# ---------------------------------------------------------------------------
# Phase 12: the network front door
# ---------------------------------------------------------------------------

# the phase's token: a client presents it, the server maps it to the tenant
NET_TOKENS = {"tok-a": "lab"}
# (b)'s stream: the quick start's size, NET_FAULT_ITERATIONS iterations, so
# that its 5 frames reach both armed faults
NET_FAULTS, NET_FAULT_ITERATIONS = "torn_frame@1;net_drop@3", 4
# (c)'s long job: config3 width on the block, NET_LONG_ITERATIONS iterations,
# killed once NET_KILL_AT iterations are done and a spool snapshot exists
NET_LONG_ITERATIONS, NET_KILL_AT = 8, 3


def _client(port, **kw):
    from symbolicregression_jl_tpu_torch.serve.net import SRClient

    return SRClient("127.0.0.1", port, token="tok-a", **kw)


def _frame_frontier(update, options):
    """A decoded frame's members as ``_frontier`` lists a result's."""
    from symbolicregression_jl_tpu_torch.complexity import compute_complexity

    return [(compute_complexity(m.tree, options), m.loss,
             m.tree.string_tree(options.operators, precision=17)) for m in update.members]


def _wire_times(tag, client_first_s, summary):
    """The client's submit-to-first-frame beside the server's own
    ``ttff_seconds``; their difference is the wire's share."""
    server = summary["ttff_seconds"]
    return (f"{tag}: first frame at the client {client_first_s * 1e3:.3f} ms, at the server "
            f"{server * 1e3:.3f} ms, the wire's share {(client_first_s - server) * 1e3:.3f} ms")


def _async_quick_start(port, spec, out):
    """An ``AsyncSRClient`` submits ``spec`` and streams it to its end, in
    its own event loop; fills ``out`` (id, client first frame s, frames,
    pulled frames, summary, or the error)."""
    import asyncio

    from symbolicregression_jl_tpu_torch.serve.net import AsyncSRClient

    async def run():
        cli = await AsyncSRClient.connect("127.0.0.1", port, token="tok-a")
        try:
            t0 = time.perf_counter()
            jid = await cli.submit(spec)
            frames = []
            async for frame in cli.iter_frames(jid, timeout=600):
                if not frames:
                    out["first_s"] = time.perf_counter() - t0
                frames.append(frame)
            out.update(id=jid, frames=frames, summary=await cli.wait(jid, timeout=600),
                       pulled=await cli.frames(jid))
        finally:
            await cli.close()

    try:
        asyncio.run(run())
    except BaseException as e:  # re-raised by the caller, on the main thread
        out["error"] = e


def net_config3(device, srv, nsrv, ref):
    """Phase 12 (a): phase 9 (b)'s seed-0 config3 job submitted over the wire
    by an ``SRClient`` holding a token and streamed with ``iter_frames``,
    while an ``AsyncSRClient`` runs a quick-start job on the other worker.
    The pushed frames equal the pulled ones byte for byte, a second client
    subscribed from index 1 gets exactly the suffix, the last frame's
    frontier and num_evals equal ``ref`` (phase 9 (b)'s lane) bit for bit,
    an unknown token is refused, and the launches of B1, B2 and B3 equal
    the two engines' own counts (B3 once per block iteration). Prints the
    ping's round trip (median of 50), the submit's round trip for the
    config3 spec, and each job's first frame at the client and at the
    server. Returns its B3 launches."""
    import pickle
    import threading

    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec
    from symbolicregression_jl_tpu_torch.serve.net import AuthError, SRClient

    Xn, _ = config3_data()
    y0 = fleet_targets(Xn)[0]
    Xq, yq, oq = _quick_start_problem(device, 0)
    # a client presenting a token the server does not know is refused at
    # its hello, before any request
    try:
        SRClient("127.0.0.1", nsrv.port, token="tok-unknown", auto_reconnect=False).close()
    except AuthError:
        pass
    else:
        _fail("net (a): a client with an unknown token was accepted")
    quick = {}
    with _block_launches() as b3, _client(nsrv.port) as cli:
        pings = []
        for _ in range(50):
            t0 = time.perf_counter()
            cli.ping()
            pings.append(time.perf_counter() - t0)
        spec = JobSpec(Xn, y0, options=_config3_options(device, 0), niterations=ENGINE_ITERATIONS,
                       label="config3")
        t0 = time.perf_counter()
        raw = pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
        pickle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jid = cli.submit(raw)
        submit_s = time.perf_counter() - t0
        qthread = threading.Thread(target=_async_quick_start, args=(
            nsrv.port, JobSpec(Xq, yq, options=oq, niterations=DEVICE_QUICKSTART_ITERATIONS,
                               label="quick start"), quick))
        qthread.start()
        frames, first_s = [], float("nan")
        for frame in cli.iter_frames(jid, timeout=600):
            if not frames:
                first_s = time.perf_counter() - t0
            frames.append(frame)
        summary = cli.wait(jid, timeout=600)
        qthread.join(600)
        if qthread.is_alive():
            _fail("net (a): the quick-start job over the async client did not end")
        pulled = cli.frames(jid, 0)
        with _client(nsrv.port) as late:
            late.subscribe(jid, start=1)
            suffix = list(late.iter_frames(jid, timeout=600))
        last = cli.decode_frame(frames[-1])
        launches = {name: rec[0] for name, rec in b3.items()}
    counts = read_launches()
    if "error" in quick:
        raise quick["error"]
    job, qjob = srv.job(jid), srv.job(quick["id"])
    if summary["state"] != DONE or quick["summary"]["state"] != DONE:
        _fail(f"net (a): {summary} {quick['summary']}")
    if summary["tenant"] != "lab" or quick["summary"]["tenant"] != "lab":
        _fail(f"net (a): tenants {summary['tenant']!r}, {quick['summary']['tenant']!r}")
    if frames != pulled or len(frames) != ENGINE_ITERATIONS + 1 or suffix != frames[1:]:
        _fail(f"net (a): {len(frames)} pushed frames, {len(pulled)} pulled, a suffix of "
              f"{len(suffix)} (pushed == pulled: {frames == pulled}, suffix exact: "
              f"{suffix == frames[1:]})")
    if quick["frames"] != quick["pulled"] or len(quick["frames"]) != (
            DEVICE_QUICKSTART_ITERATIONS + 1):
        _fail(f"net (a): the async client's {len(quick['frames'])} frames")
    o = ref.options
    if _frame_frontier(last, o) != _frontier(ref) or last.num_evals != ref.num_evals or (
            _frontier(job.result) != _frontier(ref) or job.result.num_evals != ref.num_evals):
        _fail("net (a): the config3 job over the wire differs from phase 9 (b)'s seed-0 lane")
    st = [job.result.engine_stats, qjob.result.engine_stats]
    want = (sum(s["score_calls"] for s in st), sum(s["grad_calls"] for s in st),
            sum(s["iterations"] for s in st))
    if counts[:3] != want or sorted(launches.values()) != sorted(
            [ENGINE_ITERATIONS, DEVICE_QUICKSTART_ITERATIONS]) or counts[3]:
        _fail(f"net (a): launches B1, B2, B3, B4 {counts} for the engines' {want}; B3 by "
              f"worker {launches}")
    print(f"net (a): ping round trip median {statistics.median(pings) * 1e3:.3f} ms (50 pings, "
          f"min {min(pings) * 1e3:.3f}, max {max(pings) * 1e3:.3f}); config3 spec "
          f"{len(raw)} bytes, pickled in {pickle_s * 1e3:.3f} ms, submit round trip "
          f"{submit_s * 1e3:.3f} ms", flush=True)
    print("  " + _wire_times(f"config3 {jid}", first_s, summary), flush=True)
    print("  " + _wire_times(f"quick start {quick['id']} (async client)", quick["first_s"],
                             quick["summary"]), flush=True)
    for j in (job, qjob):
        print("  " + _job_times("net", j), flush=True)
    print(f"net (a): config3 (100x100, {CONFIG3_ROWS} rows, {ENGINE_ITERATIONS} iterations on "
          f"the block) over the wire, tenant 'lab' from its token: {len(frames)} frames pushed "
          f"equal to the pulled ones, a subscription from index 1 got the {len(suffix)}-frame "
          f"suffix, the last frame equal to phase 9 (b)'s seed-0 lane bit for bit (num_evals "
          f"{last.num_evals:.0f}); beside it the async client's quick start "
          f"({len(quick['frames'])} frames); an unknown token refused at its hello; launches B1 {counts[0]}, "
          f"B2 {counts[1]} (config3 {st[0]['grad_calls']}), B3 by worker {launches}", flush=True)
    return sum(launches.values())


def net_wire_faults(device, srv, nsrv):
    """Phase 12 (b): ``torn_frame@1;net_drop@3`` armed in this process while
    one stream runs at the quick start's size: the client gets every frame
    exactly once, equal to the server's, after at least two reconnects, and
    both faults fired. Returns its B3 launches."""
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec
    from symbolicregression_jl_tpu_torch.utils import faults

    Xq, yq, oq = _quick_start_problem(device, 1)
    faults.install(NET_FAULTS)
    try:
        with _block_launches() as b3, _client(nsrv.port) as cli:
            jid = cli.submit(JobSpec(Xq, yq, options=oq, niterations=NET_FAULT_ITERATIONS,
                                     label="wire faults"))
            frames = list(cli.iter_frames(jid, timeout=600))
            summary = cli.wait(jid, timeout=600)
            reconnects, st = cli.reconnects, cli.stream_state(jid)
            launches = sum(rec[0] for rec in b3.values())
    finally:
        faults.install(None)
    stored = srv.frames(jid)
    net_faults = nsrv.net_stats()["net_faults"]
    if summary["state"] != DONE or frames != stored or len(frames) != NET_FAULT_ITERATIONS + 1:
        _fail(f"net (b): {summary['state']}, {len(frames)} frames delivered for "
              f"{len(stored)} stored (equal: {frames == stored})")
    if reconnects < 2 or net_faults != 2 or st.next_index != len(stored):
        _fail(f"net (b): {reconnects} reconnects, {net_faults} wire faults, cursor "
              f"{st.next_index}")
    if launches != NET_FAULT_ITERATIONS:
        _fail(f"net (b): {launches} B3 launches in {NET_FAULT_ITERATIONS} iterations")
    print(f"net (b): {NET_FAULTS} on a quick-start stream: {len(frames)} frames each delivered "
          f"once, equal to the server's, after {reconnects} reconnects ({net_faults} wire "
          f"faults, {st.dup_dropped} replayed duplicates dropped); B3 {launches}", flush=True)
    return launches


def net_subscription(device, srv, nsrv, rows=(8000, 10_000), bucket=10_240, seed=0):
    """Phase 12 (d): a subscription on config3's first ``rows[0]`` rows
    (``row_bucket=10_240``, the block) submitted over the wire; rows
    ``rows[0]``-``rows[1] - 1`` pushed over the wire after its first frame;
    once they are resident and a frame made after that has reached the
    client, a cancel over the wire: DONE, cancelled, B3 once per block
    iteration, no kernel built. Returns its B3 launches."""
    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec

    n0, n1 = rows
    X, y = config3_data(n_rows=n1)
    builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    with _block_launches() as b3, _client(nsrv.port) as cli:
        t0 = time.perf_counter()
        jid = cli.submit(JobSpec(X[:, :n0], y[:n0],
                                 options=_config3_options(device, seed, warmup_maxsize_by=0.0),
                                 kind="subscription", stream_config={"row_bucket": bucket}))
        stream = cli.iter_frames(jid, timeout=600)
        if next(stream, None) is None:
            _fail("net (d): no first frame")
        first_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cli.push_rows(jid, X[:, n0:], y[n0:])
        push_s = time.perf_counter() - t1
        job = srv.job(jid)
        deadline = time.monotonic() + 600
        while job.session.stats.rows != n1:
            if time.monotonic() > deadline or job.terminal:
                _fail(f"net (d): {job.summary()}")
            time.sleep(0.01)
        resident_at, got = len(srv.frames(jid)), 1
        while got <= resident_at:
            if next(stream, None) is None:
                _fail(f"net (d): the stream ended before a frame after the push: {job.summary()}")
            got += 1
        cli.cancel(jid)
        summary = cli.wait(jid, timeout=600)
        got += len(list(stream))
        launches = sum(rec[0] for rec in b3.values())
    st = job.session.stats
    if summary["state"] != DONE or summary["stop_reason"] != "cancelled" or (
            got != summary["frames"]):
        _fail(f"net (d): {summary}, {got} frames delivered")
    if launches != st.iterations or st.recompile_events or job.session._lane.block_mode != "kernel":
        _fail(f"net (d): {launches} B3 launches in {st.iterations} iterations, {st.summary()}")
    if {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()} != builds:
        _fail("net (d): a kernel was built")
    print("  " + _wire_times(f"subscription {jid}", first_s, summary), flush=True)
    print(f"net (d): subscription on {n0} rows (bucket {bucket}, the block) over the wire, "
          f"{n1 - n0} rows pushed over the wire ({push_s * 1e3:.3f} ms round trip) after the "
          f"first frame, {got - 1 - resident_at} frame(s) after they were resident, cancelled: "
          f"DONE with {got} frames, {st.iterations} iterations, B3 {launches}, no kernel "
          "built", flush=True)
    return launches


# (c)'s server child: the port only (it imports nothing of JAX), one worker,
# a journal and a spool snapshot every 0.05 s, on a fixed port. It prints
# READY with its start-up times; on SIGTERM it prints the kernel libraries it
# loaded and whether any JAX module was imported, and exits.
_NET_CHILD = """
import json, os, signal, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from symbolicregression_jl_tpu_torch.ops import interp_cuda
from symbolicregression_jl_tpu_torch.serve import NetServer, SearchServer
from symbolicregression_jl_tpu_torch.serve.journal import JobJournal
import_s = time.perf_counter() - t0
spent = {{"replay": 0.0, "adopt": 0.0}}

def timed(cls, name, key):
    real = getattr(cls, name)

    def run(*args, **kwargs):
        s = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent[key] += time.perf_counter() - s

    setattr(cls, name, run)

timed(JobJournal, "replay", "replay")
timed(SearchServer, "_adopt_checkpoint", "adopt")
jdir, port = sys.argv[1], int(sys.argv[2])
s = time.perf_counter()
srv = SearchServer(max_concurrency=1, journal_dir=jdir, ckpt_every_s=0.05).start()
net = NetServer(srv, port=port).start()
ready = dict(import_s=import_s, server_s=time.perf_counter() - s, replay_s=spent["replay"],
             adopt_s=spent["adopt"], recovered=dict(srv._recovered))

def stop(signum, frame):
    libs = {{k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}}
    jax = any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
              for m in sys.modules)
    print("STOPPED " + json.dumps(dict(libraries=libs, jax=jax)), flush=True)
    os._exit(0)

signal.signal(signal.SIGTERM, stop)
print("READY " + json.dumps(ready), flush=True)
while True:
    time.sleep(3600)
"""


class _Child:
    """One server child of (c): its process, and a thread draining its
    output (stdout and stderr) into a queue of lines."""

    def __init__(self, script, jdir, port, env):
        import queue
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, script, jdir, str(port)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=env, cwd=os.path.dirname(script))
        self.lines, self.log = queue.Queue(), []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def expect(self, prefix, timeout):
        """The JSON after the first output line starting with ``prefix``;
        fails the smoke if the child exits or says nothing so in time."""
        import json
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = ""
            if line is None or line == "":
                _fail(f"net (c): the server child gave no {prefix.strip()} (exit code "
                      f"{self.proc.poll()}); its last lines:\n" + "".join(self.log[-30:]))
            if line.startswith(prefix):
                return json.loads(line[len(prefix):])
            self.log.append(line)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def _check_child_builds(stopped, parent_builds, tag="net (c): the restarted child",
                        need=("fused_loss", "evolve_block")):
    """The child ran the card's kernels (those of ``need`` loaded) from the
    libraries phase 1 built, and imported nothing of JAX."""
    libs = stopped["libraries"]
    if stopped["jax"] or not set(need) <= set(libs) or any(
            parent_builds.get(k) != v for k, v in libs.items()):
        _fail(f"{tag} loaded {libs} (phase 1 built {parent_builds}); "
              f"a JAX module imported: {stopped['jax']}")


def net_kill_recover(device):
    """Phase 12 (c), kill and recover over the wire: a server child on a
    fixed port with a journal runs two quick-start jobs and a config3-width
    job of NET_LONG_ITERATIONS iterations on the card; one client is closed
    mid-stream; once the long job has NET_KILL_AT iterations and a spool
    snapshot, the child is SIGKILLed and restarted on the same port and
    journal with ``torn_frame@1;net_drop@3`` armed. The surviving client's
    stream resumes across the new boot: the three jobs end DONE, the long
    one resumed from its snapshot, one boot change, no duplicate, the replay
    exact, at least three reconnects and both faults fired. The restarted
    child builds no kernel and imports nothing of JAX. The children's
    launches are their own processes' and are not counted. Returns a dict
    of the times printed."""
    import glob
    import signal
    import socket
    import tempfile

    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec
    from symbolicregression_jl_tpu_torch.serve.net import ConnectionLost

    Xn, yn = config3_data()
    shorts_args = [_quick_start_problem(device, 2 + i) for i in range(2)]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    built = sorted((p.name, p.stat().st_mtime_ns) for p in interp_cuda.BUILD_DIR.glob("*.so"))
    parent_builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    children = []
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "net_child.py")
        with open(script, "w") as f:
            f.write(_NET_CHILD.format(root=os.path.dirname(os.path.abspath(__file__))))
        jdir = os.path.join(d, "journal")
        env = {k: v for k, v in os.environ.items()
               if k not in ("SR_FAULT_SPEC", "SR_ENGINE_BLOCK")}
        try:
            children.append(_Child(script, jdir, port, env))
            boot1 = children[-1].expect("READY ", 300)
            ready1_s = time.perf_counter() - children[-1].t0
            doomed = _client(port, auto_reconnect=False)
            shorts = [doomed.submit(JobSpec(X, y, options=o, niterations=2, label="short"))
                      for X, y, o in shorts_args]
            t_long = time.perf_counter()
            long_id = doomed.submit(JobSpec(Xn, yn, options=_config3_options(device, 0),
                                            niterations=NET_LONG_ITERATIONS, label="long"))
            cli = _client(port, reconnect_deadline_s=300.0)
            st = cli.subscribe(long_id)
            # one client closed mid-stream: no unsubscribe, no goodbye
            it = doomed.iter_frames(long_id, timeout=600)
            got = [next(it), next(it)]
            doomed.close()
            cli.ping()
            if got != cli.frames(long_id, 0)[:len(got)]:
                _fail("net (c): the closed client's frames are not a prefix of the stored ones")
            for jid in shorts:
                if cli.wait(jid, timeout=600)["state"] != DONE:
                    _fail(f"net (c): short job {jid} not DONE")
            spool = os.path.join(jdir, "spool", long_id + ".engine.*")
            deadline = time.monotonic() + 600
            while not (cli.status(long_id)["iterations_done"] >= NET_KILL_AT
                       and glob.glob(spool)):
                if time.monotonic() > deadline:
                    _fail("net (c): the long job never reached mid-run with a spool snapshot")
                time.sleep(0.05)
            killed_at = cli.status(long_id)["iterations_done"]
            children[-1].proc.send_signal(signal.SIGKILL)
            children[-1].proc.wait(timeout=60)
            restart = _Child(script, jdir, port, {**env, "SR_FAULT_SPEC": NET_FAULTS})
            children.append(restart)
            boot2 = restart.expect("READY ", 300)
            ready2_s = time.perf_counter() - restart.t0
            deadline = time.monotonic() + 600
            while (terminal := cli.terminal_summary(long_id)) is None:
                if time.monotonic() > deadline:
                    _fail(f"net (c): no terminal push for the recovered long job (reconnects "
                          f"{cli.reconnects}, boots {st.boots})")
                time.sleep(0.05)
            long_wall_s = time.perf_counter() - t_long
            for jid in shorts:
                summary = None
                for _ in range(3):  # a fault may cut a request in flight
                    try:
                        summary = cli.status(jid)
                        break
                    except (ConnectionLost, KeyError):
                        time.sleep(0.5)
                if summary is None or summary["state"] != DONE:
                    _fail(f"net (c): short job {jid} lost across the restart: {summary}")
            stats = cli.stats()
            stored = cli.frames(long_id, 0)
            reconnects = cli.reconnects
            cli.close()
            restart.proc.send_signal(signal.SIGTERM)
            stopped = restart.expect("STOPPED ", 60)
        finally:
            for child in children:
                child.stop()
    if terminal["state"] != DONE or not terminal.get("resumed_from_iteration"):
        _fail(f"net (c): the recovered long job: {terminal}")
    if stats["server"]["jobs"] != {"done": 3}:
        _fail(f"net (c): the recovered server's jobs {stats['server']['jobs']}")
    if st.boots != 1 or st.dup_dropped != 0 or st.next_index != len(stored) or (
            st.frames[-len(stored):] != stored):
        _fail(f"net (c): boots {st.boots}, duplicates {st.dup_dropped}, cursor {st.next_index} "
              f"for {len(stored)} stored frames (replay exact: "
              f"{st.frames[-len(stored):] == stored})")
    if reconnects < 3 or stats["net"]["net_faults"] != 2:
        _fail(f"net (c): {reconnects} reconnects, wire faults {stats['net']['net_faults']}")
    _check_child_builds(stopped, parent_builds)
    if sorted((p.name, p.stat().st_mtime_ns)
              for p in interp_cuda.BUILD_DIR.glob("*.so")) != built:
        _fail("net (c): a kernel library was built or rewritten")
    times = dict(ready1_s=ready1_s, ready2_s=ready2_s, replay_s=boot2["replay_s"],
                 adopt_s=boot2["adopt_s"], long_wall_s=long_wall_s)
    print(f"net (c): server child READY in {ready1_s:.3f} s (imports {boot1['import_s']:.3f} s, "
          f"server {boot1['server_s'] * 1e3:.3f} ms); SIGKILLed with the long job at iteration "
          f"{killed_at}; restarted with {NET_FAULTS}: READY in {ready2_s:.3f} s (imports "
          f"{boot2['import_s']:.3f} s, server {boot2['server_s'] * 1e3:.3f} ms, journal replay "
          f"{boot2['replay_s'] * 1e3:.3f} ms, spool adoption {boot2['adopt_s'] * 1e3:.3f} ms, "
          f"recovered {boot2['recovered']})", flush=True)
    print(f"net (c): 3 of 3 jobs DONE; the long job (config3 width, {NET_LONG_ITERATIONS} "
          f"iterations) resumed from iteration {terminal['resumed_from_iteration']}, submit to "
          f"its terminal push {long_wall_s:.3f} s; the stream: {len(st.frames)} frames over two "
          f"boots, {len(stored)} stored after the restart, replay exact, boots {st.boots}, "
          f"duplicates {st.dup_dropped}, reconnects {reconnects}, wire faults "
          f"{stats['net']['net_faults']}; the restarted child loaded "
          f"{sorted(stopped['libraries'])} and built none; the children's launches are their "
          "own processes' and are not counted", flush=True)
    jr = stats["server"]["journal"]
    print(f"net (c) the restarted server's stats: jobs {stats['server']['jobs']}, journal "
          f"appended {jr['appended']}, records {jr['records']}, rotations {jr['rotations']}, "
          f"torn bytes truncated {jr['torn_bytes_truncated']}, recovered {jr['recovered']}; "
          f"net {json.dumps(stats['net'])}", flush=True)
    return times


def net_path(device, ref, smi):
    """Phase 12: the network front door. ``ref``: phase 9 (b)'s seed-0 lane.
    (a), (b) and (d) on one ``SearchServer(max_concurrency=2)`` behind a
    ``NetServer`` with a token, in this process, between ``zero_launches``
    and ``read_launches``; (c) in server children. Returns its (B1, B2, B3,
    B4) launches, the path "net"."""
    from symbolicregression_jl_tpu_torch.serve import NetServer, SearchServer

    t0 = time.perf_counter()
    zero_launches()
    with engine_block_env(True), SearchServer(max_concurrency=2) as srv, NetServer(
            srv, port=0, tokens=NET_TOKENS) as nsrv:
        b3 = net_config3(device, srv, nsrv, ref)
        b3 += net_wire_faults(device, srv, nsrv)
        b3 += net_subscription(device, srv, nsrv)
        stats, net_stats = srv.stats(), nsrv.net_stats()
    counts = read_launches()
    if counts[2] != b3 or not (counts[0] and counts[1]) or counts[3]:
        _fail(f"net: launches B1, B2, B3, B4 {counts} (B3 counted per part: {b3})")
    net_kill_recover(device)
    print(f"net stats (a)/(b)/(d): server jobs {stats['jobs']}; net {json.dumps(net_stats)}",
          flush=True)
    print(f"net phase: {time.perf_counter() - t0:.3f} s on {smi}; launches B1 {counts[0]}, "
          f"B2 {counts[1]}, B3 {counts[2]}, B4 {counts[3]}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 13: the slice-2 features (full objectives, graph nodes, complex)
# ---------------------------------------------------------------------------


def wmse_objective(preds, y, w):
    """The weighted mean squared error as a full objective: B1's L2 loss,
    through B4's predictions instead."""
    err = (preds - y[None, :]) ** 2
    if w is None:
        return err.mean(-1)
    return (err * w[None, :]).sum(-1) / w.sum()


def corr_objective(preds, y, w):
    """1 - corr(preds, y)^2 per tree, weighted by w when given: a full
    objective that no elementwise loss expresses. Torch operations on the
    preds' device and no host sync; a constant prediction scores 1."""
    import torch

    w = torch.ones_like(y) if w is None else w
    ws = w.sum()
    pm = (preds * w).sum(-1, keepdim=True) / ws
    dp, dy = preds - pm, y - (y * w).sum() / ws
    cov = (w * dp * dy).sum(-1)
    return 1.0 - cov * cov / ((w * dp * dp).sum(-1) * (w * dy * dy).sum() + 1e-30)


def _frontier_objective_check(tag, res, X, y, objective, options):
    """Every frontier member's loss against the objective of its decoded
    tree's predictions from the plain interpreter on the card (rtol 2e-4,
    atol 1e-6: the loss is 1 - c^2 near 0 for a good fit). Returns the
    largest relative error."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees

    front = res.pareto_frontier
    if not front:
        _fail(f"{tag}: empty frontier")
    flat = flatten_trees([m.tree for m in front], options.max_nodes)
    preds = eval_trees(flat, X, options.operators)
    want = torch.where(torch.isfinite(preds).all(-1), objective(preds, y, None),
                       torch.inf).double().cpu().numpy()
    got = np.array([m.loss for m in front])
    if not np.all(np.isfinite(got)) or not np.allclose(got, want, rtol=2e-4, atol=1e-6):
        k = int(np.argmax(np.abs(got - want)))
        _fail(f"{tag}: frontier loss {got[k]!r} against the objective's {want[k]!r}")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))


def objective_kernel_check(device, P=4200):
    """Phase 13 (a): at config3 width (P programs, N as phase 3, 10,000 rows
    x 5 features), a weighted-MSE objective through B4 (``objective_losses``)
    against B1 (phase 2's tolerance), unweighted and weighted; B2's seeded
    mode (``preds_vjp``) against its plain version on a random seed (B2's
    gradient tolerance, NaN only where the plain version has it, two
    launches bit for bit, unsound rows zero),
    also on a 50-row minibatch; timings of B4 + the objective and of the
    seeded sweep. Returns the B2v record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_preds, fused_loss, objective_losses, optab_tensor, preds_vjp,
        preds_vjp_reference, preds_vjp_work_counts, preds_work_counts,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    w = torch.from_numpy(
        np.random.default_rng(1).uniform(0.1, 2.0, CONFIG3_ROWS).astype(np.float32)).to(device)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
    prog, vals = torch.from_numpy(prog_np).to(device), torch.from_numpy(vals_np).to(device)
    tab = optab_tensor(opset, device)
    obj_err = 0.0
    for tag, wt in (("unweighted", None), ("weighted", w)):
        got = objective_losses(prog, vals, X, y, wt, opset, wmse_objective, tab)
        ref = fused_loss(prog, vals, X, y, wt, opset, L.L2DistLoss, tab)
        torch.cuda.synchronize()
        obj_err = worst_err(obj_err, compare(f"objective through B4, {tag}", got, ref))
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    seed = torch.randn((P, CONFIG3_ROWS), generator=gen, device=device)
    got = preds_vjp(prog, vals, X, seed, opset, tab)
    again = preds_vjp(prog, vals, X, seed, opset, tab)
    ref = preds_vjp_reference(prog, vals, X, seed, opset)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        _fail("preds_vjp: two launches differ")
    # NaN only where the plain version has it (an inf - inf in a tree's
    # sum), held by compare_grads with every other non-finite position
    vjp_err = compare_grads(f"preds_vjp P={P}", got, ref)
    n_nan = int(torch.isnan(got).sum())
    if device.type == "cuda":  # the plain version follows the pointers instead
        bad_np, bad_rows = unsound_rows(prog_np, opset)
        g_bad = preds_vjp(torch.from_numpy(bad_np).to(device), vals, X, seed, opset, tab)
        torch.cuda.synchronize()
        if bool((g_bad[bad_rows] != 0).any()):
            _fail("preds_vjp: an unsound row got a nonzero gradient")
        keep = torch.ones(P, dtype=torch.bool)
        keep[bad_rows] = False
        vjp_err = worst_err(vjp_err, compare_grads("preds_vjp, unsound rows beside",
                                                   g_bad.cpu()[keep], ref.cpu()[keep]))
    idx = torch.from_numpy(np.random.default_rng(50).integers(0, CONFIG3_ROWS, 50)).to(device)
    Xb, sb = X[:, idx].contiguous(), seed[:1024, :50].contiguous()
    vjp_err = worst_err(vjp_err, compare_grads(
        "preds_vjp 1024 x 50", preds_vjp(prog[:1024], vals[:1024], Xb, sb, opset, tab),
        preds_vjp_reference(prog[:1024], vals[:1024], Xb, sb, opset)))
    # timings (not counted: each path sets the counts to 0 before it runs)
    b4_ms = time_ms(lambda: eval_preds(prog, vals, X, opset, tab))
    obj_ms = time_ms(lambda: objective_losses(prog, vals, X, y, w, opset, corr_objective, tab))
    obj_dev = device_time_ms(
        lambda: objective_losses(prog, vals, X, y, w, opset, corr_objective, tab))
    ms = time_ms(lambda: preds_vjp(prog, vals, X, seed, opset, tab))
    dev_ms = device_time_ms(lambda: preds_vjp(prog, vals, X, seed, opset, tab))
    plain_ms = time_ms(lambda: preds_vjp_reference(prog, vals, X, seed, opset), warmup=1,
                       reps=5)
    pw = preds_work_counts(prog_np, CONFIG3_ROWS, CONFIG3_FEATURES)
    b4_bound = max(pw["operations"] / PEAK_F32_FLOPS, pw["bytes"] / PEAK_BYTES) * 1e3
    work = preds_vjp_work_counts(prog_np, CONFIG3_ROWS, CONFIG3_FEATURES)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    print(f"features (a) objective kernels (P={P}, R={CONFIG3_ROWS}, N={N}): weighted-MSE "
          f"objective through B4 equals B1 (max abs err {obj_err:.3e}, rtol {RTOL}); "
          f"preds_vjp equals its plain version (max abs err {vjp_err:.3e}; NaN in {n_nan} "
          f"gradients, where the plain version has them), two launches bit for bit, unsound "
          f"rows zero; B4 {b4_ms:.4f} ms, B4 + corr objective "
          f"{obj_ms:.4f} ms (device alone {obj_dev:.4f} ms; B4's bound "
          f"{b4_bound:.5f} ms, bytes); preds_vjp {ms:.4f} ms (device alone {dev_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, bound {max(bound_ops, bound_bytes):.5f} ms "
          f"({'operations' if bound_ops >= bound_bytes else 'bytes'}), "
          f"{work['slot_evals'] / (ms * 1e-3):.4g} slot-evals/s", flush=True)
    return {
        "name": "preds_vjp",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss_grad.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:725",
        "max_abs_err": vjp_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "device_ms": dev_ms,
        "objective_ms": obj_ms,
    }


def _first_evolve_no_sync(inner):
    """Wrap a ``_LEG_WRAP`` so that the first evolve leg runs with host syncs
    made errors. Returns (wrap, the legs it checked)."""
    import torch

    checked = []

    def wrap(name):
        cm = inner(name)
        if name != "evolve" or checked:
            return cm
        checked.append(name)

        @contextlib.contextmanager
        def guarded():
            with cm:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        return guarded()

    return wrap, checked


def _host_timed_cycles():
    """Time the lockstep evolution cycles (``search.s_r_cycle_lockstep``) on
    the host clock. Returns (context manager, the seconds spent)."""
    import symbolicregression_jl_tpu_torch.search as search_mod

    spent = [0.0]

    @contextlib.contextmanager
    def timed():
        saved = search_mod.s_r_cycle_lockstep

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return saved(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t0

        search_mod.s_r_cycle_lockstep = run
        try:
            yield
        finally:
            search_mod.s_r_cycle_lockstep = saved

    return timed(), spent


def objective_search(device, lockstep_stats, iterations=ENGINE_ITERATIONS,
                     cycles=ENGINE_CYCLES, lockstep_cycles=None):
    """Phase 13 (b): config3 (100 x 100, 10,000 rows, maxsize 20) under the
    full objective 1 - corr(preds, y)^2: the device engine for ``iterations``
    x ``cycles`` (the event leg: the block is off under an objective; the
    first evolve leg with host syncs made errors; the last const-opt leg
    traced), then lockstep for 1 x ``lockstep_cycles``. B4 launches must
    equal the scoring calls plus the gradient calls (``DiffPreds``' forward),
    B2v the gradient calls, B1-B3 none; every frontier member's loss the
    objective of its decoded tree.
    Returns {path: launches}."""
    import torch

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search

    lockstep_cycles = lockstep_cycles or FEATURES_LOCKSTEP_CYCLES
    Xn, yn = config3_data()
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    kw = dict(populations=100, population_size=100, maxsize=20, seed=0, save_to_file=False,
              progress=False, device=str(device), loss_function_jit=corr_objective,
              **CONFIG3_OPS)
    options = Options(ncycles_per_iteration=cycles, scheduler="device", **kw)
    wrap, walls, idle = _leg_timer(iterations)
    wrap, checked = _first_evolve_no_sync(wrap)
    saved = ds._LEG_WRAP
    ds._LEG_WRAP = wrap
    try:
        with engine_block_env(True):
            res, *counts = _counted(
                lambda: equation_search(Xn, yn, options=options, niterations=iterations,
                                        verbosity=0))
    finally:
        ds._LEG_WRAP = saved
    b1, b2, b3, b4, b2v = counts
    st = res.engine_stats
    if st["block"] is not None or (b1, b2, b3) != (0, 0, 0):
        _fail(f"features (b) engine: evolve leg {st['block']!r}, B1 {b1}, B2 {b2}, B3 {b3}")
    # a gradient call is DiffPreds: one B4 launch forward, one B2v backward
    if (b4 != st["score_calls"] + st["grad_calls"] or st["score_calls"] == 0
            or b2v != st["grad_calls"] or b2v == 0):
        _fail(f"features (b) engine: B4 {b4} for {st['score_calls']} scoring and "
              f"{st['grad_calls']} gradient calls, B2v {b2v} for the gradient calls")
    if device.type == "cuda" and not checked:
        _fail("features (b) engine: the evolve leg ran without the host-sync check")
    err = _frontier_objective_check("features (b) engine", res, X, y, corr_objective, options)
    evolve = walls["evolve"]
    copt = walls["const_opt"]
    n_cycles = iterations * cycles
    print(f"features (b) objective 1 - corr^2, config3 device engine (event leg), "
          f"{iterations} x {cycles} cycles: {sum(evolve) / n_cycles * 1e3:.4f} ms/cycle "
          f"(phase 5's event leg beside it in this log), "
          f"{res.num_evals / res.iteration_seconds:.4g} evals/s, const-opt leg ms per "
          f"iteration {', '.join(f'{c * 1e3:.3f}' for c in copt)} (idle "
          f"{_idle_text(idle['const_opt'])}); B4 {b4} = {st['score_calls']} scoring calls "
          f"+ {st['grad_calls']} gradient calls' forwards, B2v {b2v} = gradient calls, B1 B2 "
          f"B3 0; first evolve leg made no host sync; frontier "
          f"{len(res.pareto_frontier)} members equal the objective of their trees (max rel "
          f"err {err:.3e}), best {min(m.loss for m in res.pareto_frontier):.6g}", flush=True)
    options = Options(ncycles_per_iteration=lockstep_cycles, **kw)
    timer, spent = _host_timed_cycles()
    with timer:
        res_l, *counts_l = _counted(
            lambda: equation_search(Xn, yn, options=options, niterations=1, verbosity=0))
    lb1, lb2, lb3, lb4, lb2v = counts_l
    if (lb1, lb2, lb3, lb2v) != (0, 0, 0, 0) or lb4 != res_l.scoring_dispatches or lb4 == 0:
        _fail(f"features (b) lockstep: launches {counts_l} for {res_l.scoring_dispatches} "
              f"scoring dispatches")
    err_l = _frontier_objective_check("features (b) lockstep", res_l, X, y, corr_objective,
                                      options)
    print(f"features (b) objective, config3 lockstep, 1 x {lockstep_cycles} cycles: "
          f"{spent[0] / lockstep_cycles * 1e3:.2f} ms/cycle (phase 4: "
          f"{lockstep_stats['ms_per_cycle']:.2f}), main loop {res_l.iteration_seconds:.3f} s, "
          f"{res_l.num_evals / res_l.iteration_seconds:.4g} evals/s; B4 {lb4} = scoring "
          f"dispatches, B1 B2 B3 B2v 0; frontier equal to the objective (max rel err "
          f"{err_l:.3e}), best {min(m.loss for m in res_l.pareto_frontier):.6g}", flush=True)
    return {"objective device": tuple(counts), "objective lockstep": tuple(counts_l)}


def unsound_count(flat):
    """Rows of a flat batch (numpy) that the kernels' decode would refuse
    (``decode_code``): an operator whose children are not the postfix
    stack's top entries, or a stack that does not end with one entry."""
    import numpy as np

    from symbolicregression_jl_tpu_torch.ops.flat import (
        KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR,
    )

    kind, lhs, rhs, length = (np.asarray(a) for a in (flat.kind, flat.lhs, flat.rhs,
                                                      flat.length))
    P, N = kind.shape
    stack = np.zeros((P, N + 2), np.int64)
    h = np.zeros(P, np.int64)
    bad = np.zeros(P, bool)
    rows = np.arange(P)
    for i in range(N):
        k = kind[:, i]
        r = rows[k == KIND_UNARY]
        top = np.maximum(h[r] - 1, 0)
        bad[r] |= (h[r] < 1) | (lhs[r, i] != stack[r, top])
        stack[r, top] = i
        r = rows[k == KIND_BINARY]
        left, top = np.maximum(h[r] - 2, 0), np.maximum(h[r] - 1, 0)
        bad[r] |= (h[r] < 2) | (lhs[r, i] != stack[r, left]) | (rhs[r, i] != stack[r, top])
        stack[r, left] = i
        h[r] = np.maximum(h[r] - 1, 0)
        r = rows[(k == KIND_CONST) | (k == KIND_VAR)]
        stack[r, np.minimum(h[r], N + 1)] = i
        h[r] += 1
    bad |= (length > 0) & (h != 1)
    return int(bad.sum())


def graph_lockstep(device, lockstep_stats, cycles=None):
    """Phase 13 (c): config3 (100 x 100, 10,000 rows) on lockstep with
    ``graph_nodes=True`` for 1 x ``cycles``: every scoring batch is
    re-pointed (``stack_sound_pointers``) before B1; the rows whose pointers
    changed (the ones that carried sharing) are counted and must be some,
    every re-pointed row must be stack-sound (``unsound_count``), and on the
    batch with the most such rows B1 on the re-pointed programs must equal
    the plain version on the raw ones (phase 2's tolerance; the number of
    trees equal bit for bit is reported), while the plain version gives the
    same bits on both. Returns the launches."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_reference, pack_programs_fused,
    )

    cycles = cycles or FEATURES_LOCKSTEP_CYCLES
    Xn, yn = config3_data()
    options = Options(populations=100, population_size=100, maxsize=20,
                      ncycles_per_iteration=cycles, seed=0, save_to_file=False, progress=False,
                      device=str(device), graph_nodes=True, **CONFIG3_OPS)
    real = scorer_mod.stack_sound_pointers
    seen = {"batches": 0, "rows": 0, "shared": 0, "unsound": 0, "host_s": 0.0, "kept": None}

    def recording(flat):
        t0 = time.perf_counter()
        out = real(flat)
        seen["host_s"] += time.perf_counter() - t0
        changed = ((np.asarray(out.lhs) != np.asarray(flat.lhs)).any(1)
                   | (np.asarray(out.rhs) != np.asarray(flat.rhs)).any(1))
        seen["batches"] += 1
        seen["rows"] += len(changed)
        seen["shared"] += int(changed.sum())
        seen["unsound"] += unsound_count(out)
        if seen["kept"] is None or changed.sum() > seen["kept"][2]:
            seen["kept"] = (flat, out, int(changed.sum()))
        return out

    timer, spent = _host_timed_cycles()
    scorer_mod.stack_sound_pointers = recording
    try:
        with timer:
            res, *counts = _counted(
                lambda: equation_search(Xn, yn, options=options, niterations=1, verbosity=0))
    finally:
        scorer_mod.stack_sound_pointers = real
    b1 = counts[0]
    if b1 != res.scoring_dispatches or b1 == 0 or any(counts[1:]):
        _fail(f"features (c) graph nodes: launches {counts} for {res.scoring_dispatches} "
              f"scoring dispatches")
    if seen["shared"] == 0 or seen["unsound"]:
        _fail(f"features (c) graph nodes: {seen['shared']} rows carried sharing, "
              f"{seen['unsound']} re-pointed rows unsound")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("features (c) graph nodes: frontier empty or not finite")
    raw, rep, n_shared = seen["kept"]
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    opset, l2 = options.operators, L.L2DistLoss
    p_raw, v = (torch.from_numpy(a).to(device) for a in pack_programs_fused(raw, opset))
    p_rep, _ = (torch.from_numpy(a).to(device) for a in pack_programs_fused(rep, opset))
    got = fused_loss(p_rep, v, X, y, None, opset, l2)
    lost = fused_loss(p_raw, v, X, y, None, opset, l2)
    ref = fused_loss_reference(p_raw, v, X, y, None, opset, l2)
    ref_rep = fused_loss_reference(p_rep, v, X, y, None, opset, l2)
    torch.cuda.synchronize()
    if not torch.equal(ref, ref_rep):
        _fail("features (c): the plain version differs on the re-pointed programs")
    err = compare("features (c) B1 on re-pointed programs vs plain on raw", got, ref)
    fin = torch.isfinite(ref)
    bits = int((got.view(torch.int32) == ref.view(torch.int32))[fin].sum())
    n_lost = int((torch.isinf(lost) & fin).sum())
    print(f"features (c) graph nodes, config3 lockstep, 1 x {cycles} cycles: "
          f"{spent[0] / cycles * 1e3:.2f} ms/cycle (phase 4: "
          f"{lockstep_stats['ms_per_cycle']:.2f}), main loop {res.iteration_seconds:.3f} s; "
          f"B1 {b1} = scoring dispatches; {seen['shared']} of {seen['rows']} rows in "
          f"{seen['batches']} batches carried sharing, 0 unsound after re-pointing "
          f"({seen['host_s'] * 1e3:.3f} ms of host in all); on the batch with the most "
          f"({n_shared} of {len(ref)}): B1 re-pointed equals plain raw (max abs err "
          f"{err:.3e}), {bits} of {int(fin.sum())} finite losses equal bit for bit, B1 on the "
          f"raw pointers would have scored {n_lost} of them inf; best "
          f"{min(m.loss for m in front):.6g}", flush=True)
    return tuple(counts)


def complex_path(device, iterations=None):
    """Phase 13 (d): the planted (2 - 0.5i) cos((1 + 1i) x0) at 10,000 rows x
    5 features complex64 (JAX ``tests/test_complex.py``), ``+ - *`` and
    ``cos exp``, 15 x 33, lockstep on the card (the plain interpreter, no
    kernel) with early stop at JAX's 1e-2 bar, which the best loss must
    reach; then every operator of the complex table on the card against the
    CPU (rtol 1e-4), and ``SRRegressor.predict`` on a complex X against the
    plain interpreter on the card. Returns the launches (all 0)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options, SRRegressor, equation_search
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.operators import COMPLEX_IMPLS

    iterations = iterations or COMPLEX_ITERATIONS
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(5, CONFIG3_ROWS)) + 1j * rng.normal(size=(5, CONFIG3_ROWS))).astype(
        np.complex64)
    y = ((2 - 0.5j) * np.cos((1 + 1j) * X[0])).astype(np.complex64)
    kw = dict(binary_operators=["+", "-", "*"], unary_operators=["cos", "exp"],
              dtype=np.complex64, maxsize=15)
    done = []
    options = Options(populations=15, population_size=33, ncycles_per_iteration=100,
                      seed=COMPLEX_SEED, early_stop_condition=1e-2, save_to_file=False,
                      progress=False, device=str(device),
                      iteration_callback=lambda report: done.append(report.iteration),
                      **kw)
    t0 = time.perf_counter()
    res, *counts = _counted(
        lambda: equation_search(X, y, options=options, niterations=iterations, verbosity=0))
    wall = time.perf_counter() - t0
    best = min(res.pareto_frontier, key=lambda m: m.loss)
    if any(counts) or not isinstance(best.loss, float) or not best.loss <= 1e-2:
        _fail(f"features (d) complex: best loss {best.loss!r} (bar 1e-2), launches {counts}")
    worst = 0.0
    a = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    b = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    for name, fn in COMPLEX_IMPLS.items():
        args = (a, b) if name in ("add", "sub", "mult", "div", "pow") else (a,)
        got = fn(*(torch.from_numpy(v).to(device) for v in args))
        torch.cuda.synchronize()
        want = fn(*(torch.from_numpy(v) for v in args)).numpy()
        got = got.cpu().numpy()
        if got.dtype != np.complex64 or not np.allclose(got, want, rtol=1e-4, atol=1e-5):
            _fail(f"features (d) complex: operator {name} on the card differs from the CPU")
        fin = np.isfinite(want)
        worst = max(worst, float(np.max(np.abs(got[fin] - want[fin])
                                        / np.maximum(np.abs(want[fin]), 1e-6))))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hof.csv")
        with open(path, "w") as f:
            f.write("Complexity,Loss,Equation\n")
            f.write(f"{best.get_complexity(options)},{best.loss!r},"
                    f"{best.tree.string_tree(options.operators, precision=17)}\n")
        model = SRRegressor.from_file(path, device=str(device), **kw)
        pred = model.predict(X.T[:1000])
    want = eval_trees(flatten_trees([best.tree], options.max_nodes, dtype=np.complex64),
                      torch.from_numpy(np.ascontiguousarray(X[:, :1000])).to(device),
                      options.operators)[0].cpu().numpy()
    if pred.dtype.kind != "c" or not np.allclose(pred, want, rtol=2e-4, atol=1e-5):
        _fail("features (d) complex: SRRegressor.predict differs from the card's interpreter")
    print(f"features (d) complex64: planted (2-0.5i) cos((1+1i) x0), {CONFIG3_ROWS} rows x 5, "
          f"15 x 33 lockstep on the card, {len(done)} iterations (cap {iterations}, early "
          f"stop 1e-2; stop: {res.stop_reason}) in {wall:.3f} s: best loss "
          f"{best.loss:.6g}, {best.tree.string_tree(options.operators)}; no kernel launched "
          f"(the plain interpreter in complex64); {len(COMPLEX_IMPLS)} complex operators on "
          f"the card equal the CPU (max rel err {worst:.3e}); SRRegressor.predict on a complex "
          f"X equals the card's interpreter", flush=True)
    return tuple(counts)


def features_path(device, lockstep_stats):
    """Phase 13: (a) the objective's kernels, (b) an objective end to end,
    (c) graph nodes, (d) complex. Returns (B2v's record, {path: launches})."""
    t0 = time.perf_counter()
    b2v = objective_kernel_check(device)
    paths = objective_search(device, lockstep_stats)
    paths["graph nodes"] = graph_lockstep(device, lockstep_stats)
    paths["complex"] = complex_path(device)
    print(f"features phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return b2v, paths


# ---------------------------------------------------------------------------
# Phase 14: scale_out, the multi-process search (parallel/)
# ---------------------------------------------------------------------------

_SCALE_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import chip_smoke
from symbolicregression_jl_tpu_torch.parallel import distributed
mode, rank, spec = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
if mode == "world":
    distributed.initialize(coordinator_address=spec["address"], num_processes=2,
                           process_id=rank)
child = chip_smoke.async_child if mode == "async" else chip_smoke.scale_child
out = child(rank, spec, time.perf_counter() - t0)
print("RESULT " + json.dumps(out), flush=True)
"""


def _frontier_text(res, options):
    return ";".join(f"{m.get_complexity(options)}:{m.loss!r}" for m in sorted(
        res.hall_of_fame.pareto_frontier(), key=lambda m: m.get_complexity(options)))


def scale_child(rank, spec, import_s):
    """One process of phase 14 (a) or (b), in a child of the smoke: the
    config3 search of ``spec`` (device, cycles, iterations, extra Options)
    on this process's islands, every evolve and const-opt leg timed between
    synchronizations; with ``spec["profile"]`` the search runs under
    torch.profiler (CUDA activity) for the card's busy share of the wall;
    with ``spec["check"]`` B3 on the engine's last launch's inputs (8
    cycles) and B1 and B2 on the frontier's trees are held against their
    plain versions afterwards (not counted). Returns a dict of what the
    parent prints and checks: frontier, losses, launches (each checked
    against the engine's calls here), leg ms per iteration, payload bytes,
    the libraries loaded, whether a JAX module was imported, and for a
    joiner the ms from its admission to its first exchange."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference, fused_loss_reference,
        pack_programs_fused,
    )
    from symbolicregression_jl_tpu_torch.parallel import distributed as dist
    from symbolicregression_jl_tpu_torch.parallel import membership

    device = torch.device(spec["device"])
    X, y = config3_data(n_rows=spec.get("rows", CONFIG3_ROWS))
    options = _config3_options(device, 0, cycles=spec["cycles"], **spec.get("options", {}))
    marks = {}
    real_join, real_exchange = membership.ExchangeGroup.join, membership.ExchangeGroup.exchange

    def join(self, *a, **k):
        out = real_join(self, *a, **k)
        marks["admitted"] = time.perf_counter()
        return out

    def exchange(self, *a, **k):
        out = real_exchange(self, *a, **k)
        if "admitted" in marks and "first_exchange" not in marks:
            marks["first_exchange"] = time.perf_counter()
        return out

    membership.ExchangeGroup.join, membership.ExchangeGroup.exchange = join, exchange
    on_card = device.type == "cuda"
    wrap, walls, _ = _leg_timer(0, trace=())
    # the first evolve leg runs with host syncs made errors, as phase 5's
    wrap, checked = _first_evolve_no_sync(wrap)
    if on_card:
        ds._LEG_WRAP = wrap
    with (engine_block_env(True) if on_card else contextlib.nullcontext()), \
            _block_launches() as b3_args, (
            profile(activities=[ProfilerActivity.CUDA]) if spec.get("profile") and on_card
            else contextlib.nullcontext()) as prof:
        zero_launches()
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=spec["iterations"],
                              verbosity=0)
        wall = time.perf_counter() - t0
        counts = read_launches()
    st = res.engine_stats
    its = st["iterations"]
    b1, b2, b3 = counts[:3]
    if on_card and (b1 != st["score_calls"] or b1 == 0 or b2 != st["grad_calls"]):
        raise RuntimeError(f"rank {rank}: B1 {b1} for {st['score_calls']} scoring calls, "
                           f"B2 {b2} for {st['grad_calls']} gradient calls")
    if on_card and not checked:
        raise RuntimeError(f"rank {rank}: the evolve leg ran without the host-sync check")
    if on_card and (st["block"] != "kernel" or b3 != its):
        raise RuntimeError(f"rank {rank}: evolve leg {st['block']!r}, {b3} B3 launches in "
                           f"{its} iterations")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        raise RuntimeError(f"rank {rank}: the frontier is empty or not finite")
    busy = None
    if prof is not None:
        busy = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            busy += (getattr(ev, "self_cuda_time_total", 0.0) if us is None else us) * 1e-6
    errs = {}
    if spec.get("check") and on_card:
        saved = read_launches()
        opset, N, loss = options.operators, options.max_nodes, options.loss
        args = next(iter(b3_args.values()))[1]
        cfg = dataclasses.replace(args[14], ncycles=8)
        args = (*args[:14], cfg, *args[15:])
        errs["evolve_block"] = compare_block(f"scale_out rank {rank}: B3",
                                             evolve_block(*args), evolve_block_reference(*args))
        Xd, yd = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
        prog, vals = (torch.from_numpy(a).to(device) for a in pack_programs_fused(
            flatten_trees([m.tree for m in front], N), opset))
        got = fused_loss(prog, vals, Xd, yd, None, opset, loss)
        gl, gg = fused_loss_grad(prog, vals, Xd, yd, None, opset, loss)
        rl, rg = fused_loss_grad_reference(prog, vals, Xd, yd, None, opset, loss)
        errs["fused_loss"] = compare(f"scale_out rank {rank}: B1 on the frontier", got,
                                     fused_loss_reference(prog, vals, Xd, yd, None, opset, loss))
        errs["fused_loss_grad"] = worst_err(compare(f"scale_out rank {rank}: B2", gl, rl),
                                            compare_grads(f"scale_out rank {rank}: B2", gg, rg))
        for w, n in zip(_kernel_wrappers(), saved):
            w.launches = n
    host = st["host_seconds"]
    legs = {k: [x * 1e3 for x in v] for k, v in walls.items()}
    legs["exchange"] = host.get("exchange", 0.0) * 1e3 / max(its, 1)
    return {
        "rank": rank, "best": min(m.loss for m in front), "frontier": _frontier_text(res, options),
        "no_sync_checked": bool(checked),
        "num_evals": res.num_evals, "iterations": its, "main_loop_s": res.iteration_seconds,
        "setup_s": res.setup_seconds, "wall_s": wall, "import_s": import_s,
        "evals_per_s": res.num_evals / res.iteration_seconds,
        "busy": None if busy is None else busy / wall, "launches": list(counts),
        "legs_ms": legs, "exchange_bytes": st.get("exchange_bytes"),
        "islands": st.get("islands"), "epoch": st.get("epoch"), "live": st.get("live"),
        "dead": sorted(dist.dead_peers()),
        "errs": {k: [float(v), v.ratio] for k, v in errs.items()},
        "admit_to_exchange_ms": ((marks["first_exchange"] - marks["admitted"]) * 1e3
                                 if "first_exchange" in marks else None),
        "libraries": {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()},
        "jax": _jax_imported(),
    }


def _spawn_scale(script, mode, rank, spec, env, log=None):
    """A child of phase 14; with ``log`` its output goes to that file (a
    child the parent does not read until much later must not fill a
    pipe)."""
    out = open(log, "w") if log else subprocess.PIPE
    try:
        proc = subprocess.Popen([sys.executable, script, mode, str(rank), json.dumps(spec)],
                                stdout=out, stderr=subprocess.STDOUT, text=True, env=env,
                                cwd=os.path.dirname(script))
    finally:
        if log:
            out.close()
    proc.log = log
    return proc


def _scale_results(tag, procs, timeout=300, codes=None):
    """Each child's RESULT dict (None for one that exited with its expected
    non-zero code); a child past ``timeout`` is killed and fails the smoke."""
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _fail(f"{tag}: child {i} still running after {timeout} s")
        if p.log:
            with open(p.log) as f:
                out = f.read()
        want = 0 if codes is None else codes[i]
        if p.returncode != want:
            _fail(f"{tag}: child {i} exited {p.returncode} (expected {want}); its last "
                  f"lines:\n" + "\n".join(out.splitlines()[-30:]))
        line = next((ln for ln in out.splitlines() if ln.startswith("RESULT ")), None)
        if want == 0 and line is None:
            _fail(f"{tag}: child {i} printed no RESULT:\n" + out[-3000:])
        outs.append(json.loads(line[len("RESULT "):]) if line else None)
    return outs


def _scale_env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SR_FAULT_SPEC", "SR_ENGINE_BLOCK", "SR_ELASTIC", "SR_COORD",
                                "SR_KV_"))}
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _add_launches(total, outs):
    for o in outs:
        if o is not None:
            total[:] = [a + b for a, b in zip(total, o["launches"])]
    return total


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scale_world(device, script, solo, parent_builds, iterations=ENGINE_ITERATIONS,
                cycles=ENGINE_CYCLES):
    """Phase 14 (a): a world of 2 over ``initialize()`` (a TCPStore on
    127.0.0.1 hosted by rank 0, gloo), both processes on the one card, each
    the device engine on 50 of config3's 100 islands, ``iterations`` x
    ``cycles`` on the block. Both must end with identical halls of fame;
    each launched B3 once per iteration. Per process: leg ms per iteration
    (their kernels share the card, so each includes the other's work), the
    payload bytes, evals/s and the card's busy share of its wall; phase 5's
    solo run beside them. Returns the children's launches."""
    spec = {"device": str(device), "cycles": cycles, "iterations": iterations,
            "address": f"127.0.0.1:{_free_port()}", "profile": True, "check": True,
            "rows": CONFIG3_ROWS}
    t0 = time.perf_counter()
    outs = _scale_results("scale_out (a)", [_spawn_scale(script, "world", r, spec, _scale_env())
                                            for r in (0, 1)])
    wall = time.perf_counter() - t0
    for o in outs:
        _check_child_builds(o, parent_builds, tag=f"scale_out (a): rank {o['rank']}")
    if outs[0]["frontier"] != outs[1]["frontier"]:
        _fail(f"scale_out (a): the halls of fame differ:\n{outs[0]['frontier']}\n"
              f"{outs[1]['frontier']}")
    for o in outs:
        idle = ("not measured (no device time traced)" if not o["busy"]
                else f"{1 - o['busy']:.1%}")
        print(f"scale_out (a) rank {o['rank']} of 2 on the one card (islands "
              f"{o['islands']}): imports {o['import_s']:.2f} s, set-up {o['setup_s']:.2f} s, "
              f"main loop {o['main_loop_s']:.3f} s; per iteration, host ms between "
              f"synchronizations (the other process's kernels, and (c)'s, share the card): evolve "
              + ", ".join(f"{x:.3f}" for x in o["legs_ms"].get("evolve", []))
              + "; const-opt " + ", ".join(f"{x:.3f}" for x in o["legs_ms"].get("const_opt", []))
              + f"; exchange {o['legs_ms']['exchange']:.3f} ms (payload "
              f"{o['exchange_bytes'][0]} bytes per iteration); {o['evals_per_s']:.4g} evals/s "
              f"(the world's); card idle {idle} of the process's search wall (its own "
              f"kernels under torch.profiler; set-up included); launches B1 "
              f"{o['launches'][0]}, B2 {o['launches'][1]}, B3 {o['launches'][2]}; B1, B2, B3 "
              f"against their plain versions: max abs err "
              + ", ".join(f"{k} {v[0]:.3e}" for k, v in o["errs"].items())
              + f"; first evolve leg made no host sync; best loss {o['best']:.6g}", flush=True)
    print(f"scale_out (a): identical halls of fame ({outs[0]['frontier'].count(':')} members), "
          f"children's wall {wall:.2f} s; solo (phase 5, 100 islands in one process): main loop "
          f"{solo['main_loop_s']:.3f} s, {solo['evals_per_s']:.4g} evals/s, best loss "
          f"{solo['best']:.6g}", flush=True)
    return outs


def scale_elastic(device, script, parent_builds, iterations=ELASTIC_ITERATIONS,
                  cycles=ELASTIC_CYCLES):
    """Phase 14 (b), the elastic drill of the JAX package's
    ``scripts/fault_smoke.py`` at config3 width on the card: a world of 2
    over a file coordination directory (``SR_COORD_DIR``,
    ``SR_ELASTIC_WORLD``, ``on_peer_loss="rejoin"``) first without a fault,
    then with rank 1 killed by ``peer_death`` (exit 43) while rank 0 is
    paced by ``slow_peer``; rank 1 restarted with ``SR_ELASTIC_JOIN=1``
    joins at a later epoch, adopts the leader's shard and finishes. The
    survivor ends with no dead peer. Prints the leave's detection ms (from
    the victim's exit to the epoch record), the epochs, the joiner's
    admission to first exchange, each side's best against the no-fault
    run's. Returns the children's launches."""
    import pickle
    import tempfile
    import urllib.parse

    spec = {"device": str(device), "cycles": cycles, "iterations": iterations,
            "options": {"on_peer_loss": "rejoin", "heartbeat_every_seconds": 1.0},
            "rows": CONFIG3_ROWS}
    base = dict(SR_ELASTIC_WORLD=2, SR_KV_TIMEOUT_MS=ELASTIC_KV_TIMEOUT_MS,
                SR_KV_BACKOFF_MS=50)
    pacing = ";".join(f"slow_peer@{i}:delay_ms={ELASTIC_PACE_MS}" for i in range(4 * iterations))
    with tempfile.TemporaryDirectory() as d:
        ref_dir, coord = os.path.join(d, "ref"), os.path.join(d, "coord")
        ref = _scale_results("scale_out (b) no-fault run", [
            _spawn_scale(script, "elastic", r, spec,
                         _scale_env(SR_COORD_DIR=ref_dir, SR_ELASTIC_ID=r, **base))
            for r in (0, 1)])
        t0 = time.perf_counter()
        survivor = _spawn_scale(script, "elastic", 0, spec, _scale_env(
            SR_COORD_DIR=coord, SR_ELASTIC_ID=0, SR_FAULT_SPEC=pacing, **base))
        victim = _spawn_scale(script, "elastic", 1, spec, _scale_env(
            SR_COORD_DIR=coord, SR_ELASTIC_ID=1, SR_FAULT_SPEC=f"peer_death@{ELASTIC_KILL_AT}",
            **base))
        _scale_results("scale_out (b) victim", [victim], codes=[43])
        t_death = time.time()
        restart_s = time.perf_counter() - t0
        rejoiner = _spawn_scale(script, "elastic", 1, spec, _scale_env(
            SR_COORD_DIR=coord, SR_ELASTIC_ID=1, SR_ELASTIC_JOIN=1, **base))
        surv, rej = _scale_results("scale_out (b)", [survivor, rejoiner])
        wall = time.perf_counter() - t0
        records = []
        for fn in os.listdir(coord):
            if urllib.parse.unquote(fn).startswith("srep/"):
                path = os.path.join(coord, fn)
                with open(path, "rb") as f:
                    records.append((pickle.load(f), os.stat(path).st_mtime))
    records.sort(key=lambda r: r[0]["epoch"])
    kills = [r for r in records if 1 in r[0]["left"]]
    joins = [r for r in records if 1 in r[0]["joined"]]
    if not kills or not joins or joins[0][0]["epoch"] <= kills[0][0]["epoch"]:
        _fail(f"scale_out (b): no leave then later rejoin of rank 1: "
              f"{[r[0] for r in records]}")
    if surv["dead"] or rej["dead"] or surv["live"] != [0, 1]:
        _fail(f"scale_out (b): dead peers after the rejoin: survivor {surv['dead']} live "
              f"{surv['live']}, joiner {rej['dead']}")
    for o in (*ref, surv, rej):
        _check_child_builds(o, parent_builds, tag=f"scale_out (b): rank {o['rank']}")
    ref_best = min(o["best"] for o in ref)
    for tag, o in (("survivor", surv), ("joiner", rej)):
        if not o["best"] <= max(ref_best * 100.0, 0.05):
            _fail(f"scale_out (b): the {tag}'s best {o['best']:.6g} against the no-fault run's "
                  f"{ref_best:.6g}")
    adm = rej["admit_to_exchange_ms"]
    print(f"scale_out (b) elastic drill, config3 width (50 islands a rank), {iterations} x "
          f"{cycles} (cut from 550 cycles so that the restart lands mid-run; the survivor "
          f"paced {ELASTIC_PACE_MS} ms a post, KV deadline {ELASTIC_KV_TIMEOUT_MS} ms): victim "
          f"exited 43 at iteration {ELASTIC_KILL_AT} after {restart_s:.2f} s; leave formalized "
          f"at epoch {kills[0][0]['epoch']} (iteration {kills[0][0]['iteration']}) "
          f"{(kills[0][1] - t_death) * 1e3:.1f} ms after the victim's exit; rejoin at epoch "
          f"{joins[0][0]['epoch']} (iteration {joins[0][0]['iteration']}); the joiner: imports "
          f"{rej['import_s']:.2f} s, admission to first exchange "
          + (f"{adm:.1f} ms" if adm is not None else "not reached")
          + f", {rej['iterations']} iterations, best {rej['best']:.6g}; the survivor: "
          f"{surv['iterations']} iterations, live {surv['live']}, no dead peer, best "
          f"{surv['best']:.6g}; no-fault run best {ref[0]['best']:.6g} / {ref[1]['best']:.6g} "
          f"(main loop {ref[0]['main_loop_s']:.2f} s); drill wall {wall:.2f} s", flush=True)
    return [*ref, surv, rej]


def async_child(rank, spec, import_s):
    """Phase 14 (c), in a child of the smoke: ``scheduler="async"`` on
    config3 (100 islands x 100 members, 1 iteration of ``spec["cycles"]``
    cycles, ``async_workers`` at its default), one work unit per island, B1
    launched from the pool's threads. Returns what the parent checks and
    prints: the launches, the scorer's dispatches, the wall and main loop,
    the head occupancy, the host seconds of the work units' two parts
    summed over the threads, the best loss, the libraries loaded and
    whether a JAX module was imported."""
    import threading

    import numpy as np

    import symbolicregression_jl_tpu_torch.parallel.islands as islands
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    X, y = config3_data()
    options = Options(populations=100, population_size=100, maxsize=20,
                      ncycles_per_iteration=spec["cycles"], seed=0, save_to_file=False,
                      progress=False, device=spec["device"], scheduler="async", **CONFIG3_OPS)
    spent = {"s_r_cycle_lockstep": 0.0, "optimize_and_simplify_populations": 0.0}
    saved = {name: getattr(islands, name) for name in spent}
    lock = threading.Lock()

    def timed(name):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return saved[name](*args, **kwargs)
            finally:
                with lock:
                    spent[name] += time.perf_counter() - t
        return run

    for name in spent:
        setattr(islands, name, timed(name))
    zero_launches()
    t0 = time.perf_counter()
    res = equation_search(X, y, options=options, niterations=1, verbosity=0)
    wall = time.perf_counter() - t0
    counts = read_launches()
    front = res.pareto_frontier
    return {
        "launches": list(counts), "dispatches": res.scoring_dispatches,
        "use_kernel": res.use_kernel, "wall_s": wall, "main_loop_s": res.iteration_seconds,
        "num_evals": res.num_evals, "head_occupancy": res.head_occupancy, "spent": spent,
        "best": min((m.loss for m in front), default=float("nan")),
        "finite": bool(front) and all(np.isfinite(m.loss) for m in front),
        "import_s": import_s,
        "libraries": {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()},
        "jax": _jax_imported(),
    }


def scale_async(proc, lockstep_stats, parent_builds, cycles=ASYNC_CYCLES):
    """Phase 14 (c)'s checks on ``async_child``'s result (the child ran
    beside (a), (b) and (d)): it loaded the parent's libraries, selected
    B1, and its B1 launches equal the scorer's dispatches, as phase 4's do;
    a finite frontier. Prints the main loop, evals/s, the launches and the
    head occupancy. Returns the launches."""
    out, = _scale_results("scale_out (c)", [proc])
    _check_child_builds(out, parent_builds, tag="scale_out (c): the async child",
                        need=("fused_loss",))
    b1 = out["launches"][0]
    if not out["use_kernel"]:
        _fail("scale_out (c): the async scorer did not select B1")
    if b1 != out["dispatches"] or b1 == 0:
        _fail(f"scale_out (c): {b1} B1 launches for {out['dispatches']} scoring dispatches")
    if not out["finite"]:
        _fail("scale_out (c): the async frontier is empty or not finite")
    per = out["main_loop_s"] / (100 * cycles) * 1e3
    print(f"scale_out (c) async scheduler, config3 100x100, 1 iteration x {cycles} cycles, "
          f"{min(100, 8)} workers, in a child beside (a), (b) and (d): imports "
          f"{out['import_s']:.2f} s, wall {out['wall_s']:.3f} s, main loop "
          f"{out['main_loop_s']:.3f} s ({per:.3f} ms per island-cycle against lockstep's "
          f"{lockstep_stats['ms_per_cycle'] / 100:.3f}), "
          f"{out['num_evals'] / out['main_loop_s']:.4g} evals/s, B1 {b1} launches = "
          f"{out['dispatches']} scoring dispatches, head occupancy "
          f"{out['head_occupancy']:.2%}; work units' host s summed over the threads: cycles "
          f"{out['spent']['s_r_cycle_lockstep']:.2f}, const-opt + simplify "
          f"{out['spent']['optimize_and_simplify_populations']:.2f}; best loss "
          f"{out['best']:.6g}", flush=True)
    return tuple(out["launches"])


def scale_rows(device, rows=ROWS_SHARDED, P=1024):
    """Phase 14 (d): ``make_sharded_loss`` over a 1 x 2 mesh whose entries
    are both ``device``, at ``rows`` rows x 5 features f32 with P random
    config3 programs, unweighted and weighted, held against one B1 call
    over all rows and against the plain version (in program chunks); both
    timed. Then ``Options(data_sharding="rows")`` lockstep for a few
    config3 cycles: with one device it equals the unsharded search bit for
    bit. Returns the launches of the sharded losses and the sharded
    search."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_reference, optab_tensor, unpack_programs_fused, work_counts,
    )
    from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh
    from symbolicregression_jl_tpu_torch.parallel.sharding import (
        make_sharded_loss, shard_dataset, shard_population,
    )

    opts = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    opset, N, loss = opts.operators, opts.max_nodes, opts.loss
    Xn, yn = config3_data(n_rows=rows, seed=5)
    wn = np.random.default_rng(6).uniform(0.5, 1.5, size=rows).astype(np.float32)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P + 1)
    flat = unpack_programs_fused(prog_np, vals_np, opset)
    X, y, w = (torch.from_numpy(a).to(device) for a in (Xn, yn, wn))
    prog, vals = torch.from_numpy(prog_np).to(device), torch.from_numpy(vals_np).to(device)
    tab = optab_tensor(opset, device)
    mesh = make_mesh(1, 2, devices=[device, device])
    fs = shard_population(mesh, flat)
    total = [0, 0, 0, 0, 0]
    for weighted in (False, True):
        tag = "weighted" if weighted else "unweighted"
        wt = w if weighted else None
        loss_fn = make_sharded_loss(mesh, opset, loss, has_weights=weighted)
        Xs, ys, ws = shard_dataset(mesh, X, y, wt)
        zero_launches()
        got = loss_fn(fs, Xs, ys, ws)
        torch.cuda.synchronize()
        counts = read_launches()
        if counts[0] != 2:
            _fail(f"scale_out (d) {tag}: {counts[0]} B1 launches for a 1 x 2 mesh")
        total = [a + b for a, b in zip(total, counts)]
        one = fused_loss(prog, vals, X, y, wt, opset, loss, tab)
        plain = torch.cat([fused_loss_reference(prog[i:i + 32], vals[i:i + 32], X, y, wt,
                                                opset, loss) for i in range(0, P, 32)])
        torch.cuda.synchronize()
        compare(f"scale_out (d) {tag}: the sharded loss against one B1 call", got, one)
        compare(f"scale_out (d) {tag}: the sharded loss against the plain version", got, plain)
        fin = torch.isfinite(one)
        rel = float(((got[fin].double() - one[fin].double()).abs()
                     / one[fin].double().abs().clamp_min(1e-30)).max()) if bool(fin.any()) else 0.0
        ms = time_ms(lambda: loss_fn(fs, Xs, ys, ws), warmup=1, reps=10)
        one_ms = time_ms(lambda: fused_loss(prog, vals, X, y, wt, opset, loss, tab), warmup=1,
                         reps=10)
        t0 = time.perf_counter()
        for i in range(0, P, 32):
            fused_loss_reference(prog[i:i + 32], vals[i:i + 32], X, y, wt, opset, loss)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        work = work_counts(prog_np, rows, CONFIG3_FEATURES, weighted=weighted)
        bound = max(work["operations"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES) * 1e3
        print(f"scale_out (d) rows, {tag}: make_sharded_loss over [{device}, {device}] at "
              f"{rows} rows x {CONFIG3_FEATURES} features x {P} programs ({int(fin.sum())} "
              f"finite, max relative difference from one B1 call {rel:.3e}): "
              f"{ms:.3f} ms against one B1 call over all rows {one_ms:.3f} ms ((c)'s child "
              f"shares the card; bound "
              f"{bound:.4f} ms), the plain version {plain_ms:.1f} ms (32 programs a call); "
              f"within tolerance of both (each shard's mean is rounded to f32 before the f64 "
              f"combination, so not bit for bit)", flush=True)
    for w_ in _kernel_wrappers():
        w_.launches = 0
    X3, y3 = config3_data()
    runs = {}
    for rows_opt in (None, "rows"):
        o = Options(populations=100, population_size=100, maxsize=20,
                    ncycles_per_iteration=ROWS_LOCKSTEP_CYCLES, seed=0, save_to_file=False,
                    progress=False, device=str(device), data_sharding=rows_opt, **CONFIG3_OPS)
        zero_launches()
        res = equation_search(X3, y3, options=o, niterations=1, verbosity=0)
        counts = read_launches()
        if counts[0] != res.scoring_dispatches:
            _fail(f"scale_out (d): {counts[0]} B1 launches for {res.scoring_dispatches} "
                  "dispatches")
        runs[rows_opt] = (_frontier_text(res, o), res.num_evals, res.iteration_seconds)
        if rows_opt == "rows":
            total = [a + b for a, b in zip(total, counts)]
    if runs[None][:2] != runs["rows"][:2]:
        _fail(f"scale_out (d): data_sharding='rows' on one device changed the search:\n"
              f"{runs[None]}\n{runs['rows']}")
    print(f"scale_out (d): lockstep config3 1 x {ROWS_LOCKSTEP_CYCLES} cycles with "
          f"data_sharding='rows' on the one card equals the unsharded search bit for bit "
          f"(frontier and num_evals); main loop {runs['rows'][2]:.3f} s against "
          f"{runs[None][2]:.3f} s", flush=True)
    return tuple(total)


def scale_out(device, solo, lockstep_stats):
    """Phase 14: (a) a world of two device-engine processes on the one card,
    (b) the elastic drill, (c) the async scheduler, (d) row sharding. (c)
    runs in a child started first, beside (a), (b) and (d): it is host work
    under one GIL (one constant optimization per work unit, which no cut of
    cycles removes), so the phase takes the longer of (c) and the rest, not
    their sum (each one's times include the other's load). Every child
    counts its own launches. Returns ({path: launches}, {kernel: max abs
    err})."""
    import tempfile

    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    t0 = time.perf_counter()
    parent_builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    paths, errs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "scale_child.py")
        with open(script, "w") as f:
            f.write(_SCALE_CHILD.format(root=os.path.dirname(os.path.abspath(__file__))))
        beside = _spawn_scale(script, "async", 0, {"device": str(device), "cycles": ASYNC_CYCLES},
                              _scale_env(), log=os.path.join(d, "async.log"))
        try:
            world = scale_world(device, script, solo, parent_builds)
            paths["scale_out"] = tuple(_add_launches([0] * 5, world))
            elastic = scale_elastic(device, script, parent_builds)
            paths["elastic"] = tuple(_add_launches([0] * 5, elastic))
            paths["rows"] = scale_rows(device)
            paths["async"] = scale_async(beside, lockstep_stats, parent_builds)
        finally:
            if beside.poll() is None:
                beside.kill()
                beside.wait()
    for o in world:
        for k, v in o["errs"].items():
            errs[k] = worst_err(errs.get(k, 0.0), Err(*v))
    print(f"phase 14 scale_out: {time.perf_counter() - t0:.2f} s", flush=True)
    return paths, errs


# ---------------------------------------------------------------------------
# Phase 15: pod, federated serving (serve/pod.py), chaos and the auditor
# ---------------------------------------------------------------------------

# phase 15, cut in depth only: (a) the migrated lockstep job at the quick
# start's size runs POD_LOCKSTEP_ITERATIONS x POD_LOCKSTEP_CYCLES (the
# README's 20 x 550 cut), the config3-width engine job POD_ENGINE_ITERATIONS
# x ENGINE_CYCLES on the block; the short jobs of (a) and (b) are JAX's
# drill's (``_pod_short``); pod hosts beat every POD_HB_S and suspect a peer
# after POD_SUSPECT_S (JAX's drill's 0.1 and 1.5 s). (c) the port's soak
# (``symbolicregression_jl_tpu_torch/scripts/chaos_soak.py``, JAX's, 60 s by
# default) cut to CHAOS_DURATION_S, its schedule drawn from CHAOS_SEED
POD_LOCKSTEP_ITERATIONS, POD_LOCKSTEP_CYCLES = 6, 10
POD_ENGINE_ITERATIONS = 6
POD_HB_S, POD_SUSPECT_S = 0.1, 1.5
CHAOS_SEED, CHAOS_DURATION_S = 0, 25.0

# a child of phase 15: a pod host or a NetServer ("pod", "net"), which
# writes a report file every 0.2 s, or (c)'s chaos orchestrator ("chaos"), which
# prints one RESULT line
_POD_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import chip_smoke
mode, spec = sys.argv[1], json.loads(sys.argv[3])
if mode == "chaos":
    out = chip_smoke.chaos_child(spec, time.perf_counter() - t0)
    print("RESULT " + json.dumps(out), flush=True)
else:
    chip_smoke.pod_child(mode, spec, time.perf_counter() - t0)
"""


def pod_child(mode, spec, import_s):
    """One host of phase 15 on the card: a ``PodNode`` ("pod") over the
    ``FileCoordStore`` at ``spec["coord"]`` or over the TCPStore at
    ``spec["store"]`` (a ``TorchCoordStore``, wrapped in a
    ``PartitionedCoordStore`` when ``kv_partition`` is armed), with the
    SIGTERM drain installed; or ("net") a ``NetServer`` over a journaled
    ``SearchServer``. With ``spec["go"]`` it waits for that file before it
    starts serving (its imports and the card's context paid ahead). Every
    0.2 s, and once more after a drain, it writes its report: the launches
    of B1-B4 and B2v since the process started, the libraries it loaded,
    whether a JAX module was imported, the node's stats, its pod jobs (pod
    id -> local id) and the host ms of each adoption. Never returns."""
    import threading

    import torch

    from symbolicregression_jl_tpu_torch.ops import interp_cuda
    from symbolicregression_jl_tpu_torch.parallel.membership import (
        FileCoordStore, PartitionedCoordStore, TorchCoordStore,
    )
    from symbolicregression_jl_tpu_torch.serve import NetServer, PodNode, SearchServer
    from symbolicregression_jl_tpu_torch.utils import faults

    torch.zeros(1, device=spec["device"])
    if spec.get("go"):
        print("WAITING", flush=True)
        while not os.path.exists(spec["go"]):
            time.sleep(0.02)
    host = spec["host"]
    path = os.path.join(spec["reports"], f"{host}-{os.getpid()}.json")
    lock = threading.Lock()
    state = {"final": False, "adoptions": []}
    node = None

    def write(final=False):
        with lock:
            if state["final"]:
                return
            state["final"] = final
            out = {"host": host, "pid": os.getpid(), "t": time.time(), "final": final,
                   "import_s": import_s, "launches": list(read_launches()),
                   "libraries": {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()},
                   "jax": _jax_imported(), "adoptions": list(state["adoptions"])}
            # each armed rule of this process: fired once its site's calls
            # passed its count
            inj = faults.active()
            out["faults"] = [
                f"{r.site}@{r.at} " + ("fired" if inj._counts.get(r.site, 0) > r.at else "idle")
                for r in inj._rules]
            if node is not None and hasattr(node.store, "partition_stats"):
                out["partition"] = node.store.partition_stats()
            if node is not None:
                st = node.stats()
                out["stats"] = {k: v for k, v in st.items() if k != "server"}
                out["server"] = {k: st.get("server", {}).get(k) for k in ("jobs", "queued")}
                with node._lock:
                    out["jobs"] = dict(node._by_pjid)
                out["progress"] = {}
                for pjid, jid in out["jobs"].items():
                    try:
                        job = node.server.job(jid)
                        out["progress"][pjid] = [job.state, job.iterations_done]
                    except (KeyError, AttributeError):
                        pass
            with open(path + ".tmp", "w") as f:
                json.dump(out, f)
            os.replace(path + ".tmp", path)

    if mode == "net":
        srv = SearchServer(max_concurrency=1, journal_dir=spec["journal"],
                           ckpt_every_s=0.05).start()
        NetServer(srv, port=spec["port"]).start()
    else:
        if spec.get("store"):
            import datetime

            import torch.distributed as tdist

            addr, port = spec["store"].rsplit(":", 1)
            store = TorchCoordStore(tdist.TCPStore(
                addr, int(port), None, False, timeout=datetime.timedelta(seconds=60)))
        else:
            store = FileCoordStore(spec["coord"])
        if faults.active().armed("kv_partition"):
            store = PartitionedCoordStore(store)
        node = PodNode(host, store=store, root=spec.get("root"), hb_seconds=spec["hb_s"],
                       suspect_seconds=spec["suspect_s"], max_concurrency=spec["workers"],
                       poll_seconds=0.02, ckpt_every_s=spec["ckpt_every_s"])
        real_adopt, real_drain = node._adopt_host, node.drain

        def adopt(peer, gen, retired):
            t, wall = time.perf_counter(), time.time()
            try:
                return real_adopt(peer, gen, retired=retired)
            finally:
                state["adoptions"].append({"host": peer, "gen": gen, "retired": retired,
                                           "t": wall, "ms": (time.perf_counter() - t) * 1e3})

        def drain(*args, **kwargs):
            try:
                return real_drain(*args, **kwargs)
            finally:
                write(final=True)

        node._adopt_host, node.drain = adopt, drain
        node.install_sigterm_drain()
        node.start()
    print("READY " + json.dumps({"host": host, "import_s": import_s,
                                 "gen": None if node is None else node.gen}), flush=True)
    while True:
        write()
        time.sleep(0.2)


def _pod_env(**kw):
    env = {k: v for k, v in _scale_env().items() if not k.startswith(("SR_POD_", "SR_QUEUE"))}
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _expect_line(proc, prefix, timeout, tag):
    """The JSON after the first line of ``proc``'s log starting with
    ``prefix`` (None when nothing follows it); fails the smoke if the child
    exits or says nothing so in time."""
    deadline = time.monotonic() + timeout
    while True:
        with open(proc.log) as f:
            for line in f:
                if line.startswith(prefix):
                    rest = line[len(prefix):].strip()
                    return json.loads(rest) if rest else None
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(proc.log) as f:
                tail = f.readlines()[-30:]
            _fail(f"{tag}: no {prefix.strip()} (exit code {proc.poll()}); its last lines:\n"
                  + "".join(tail))
        time.sleep(0.05)


def _reports(d, host=None):
    """Every report file in ``d`` (of ``host`` only, when given)."""
    out = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".json") and (host is None or name.startswith(host + "-")):
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
    return out


def _report_after(d, host, t, timeout=30, final=False):
    """``host``'s newest report written after wall time ``t`` (or its final
    one)."""
    deadline = time.monotonic() + timeout
    while True:
        reps = [r for r in _reports(d, host) if r["t"] > t and (r["final"] or not final)]
        if reps:
            return max(reps, key=lambda r: r["t"])
        if time.monotonic() > deadline:
            _fail(f"pod: no report of {host} after {t}")
        time.sleep(0.05)


def _members_text(members, options):
    return ";".join(f"{m.get_complexity(options)}:{m.loss!r}" for m in sorted(
        members, key=lambda m: m.get_complexity(options)))


def _pod_lockstep(device, seed):
    """The quick start's problem and width on lockstep, POD_LOCKSTEP_CYCLES
    cycles an iteration."""
    import dataclasses

    X, y, o = _quick_start_problem(device, seed)
    return X, y, dataclasses.replace(o, scheduler="lockstep",
                                     ncycles_per_iteration=POD_LOCKSTEP_CYCLES)


def _pod_short(device, seed):
    """JAX's pod drill's and soak's job: 2 x 64 rows, ``+ - *``, ``cos``,
    2 populations x 12 members, 8 cycles, lockstep."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y, Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                         populations=2, population_size=12, ncycles_per_iteration=8,
                         maxsize=12, seed=seed, scheduler="lockstep", save_to_file=False,
                         progress=False, device=str(device))


def _wait_claim(store, key, timeout, tag):
    import pickle

    deadline = time.monotonic() + timeout
    while (raw := store.try_get(key)) is None:
        if time.monotonic() > deadline:
            _fail(f"{tag}: {key} never claimed")
        time.sleep(0.01)
    return pickle.loads(raw)


def pod_federation(device, script, d, parent_builds):
    """Phase 15 (a) and (b), JAX's drill (``scripts/fault_smoke.py``'s
    ``smoke_pod_federation``) on the card. (a) Two ``PodNode`` children, h0
    and h1, two workers each, over one ``FileCoordStore``; pinned to h1 and
    running at once, a lockstep job at the quick start's size writing exact
    spool snapshots (``ckpt_every_s=0.1``) and a config3-width engine job on
    the block; three short jobs queued behind them on h1 and two routed
    freely. Once both running jobs have a spool snapshot, h1 is SIGKILLed:
    every job must reach DONE in the done ledger with no duplicate result;
    the migrated lockstep job's frontier equals the uninterrupted run's (in
    this process) string for string, resumed from an iteration above 0; the
    config3 job ends on h0 with every member of its last snapshot's
    frontier matched or beaten, more evaluations, and B1, B2 and B3
    launched in h0. (b) A third host, h2 (booted beside the others, serving
    from now), gets two jobs and a SIGTERM: it exits 0 with a retirement
    marker, h0 claims its generation, both jobs end DONE, no duplicate.
    Returns ({path: launches}, the times printed)."""
    import glob
    import re
    import signal
    import threading

    import numpy as np

    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.parallel.membership import FileCoordStore
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, PodClient
    from symbolicregression_jl_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_frontier_bytes,
    )

    coord, reports = os.path.join(d, "coord"), os.path.join(d, "pod_reports")
    os.makedirs(reports)
    go = os.path.join(d, "go-h2")
    common = {"device": str(device), "coord": coord, "reports": reports, "workers": 2,
              "ckpt_every_s": 0.1, "hb_s": POD_HB_S, "suspect_s": POD_SUSPECT_S}
    t_spawn = time.perf_counter()
    procs = {h: _spawn_scale(script, "pod", 0, {**common, "host": h, **kw}, _pod_env(),
                             log=os.path.join(d, f"{h}.log"))
             for h, kw in (("h0", {}), ("h1", {}), ("h2", {"go": go}))}
    try:
        # the uninterrupted reference of the migrated lockstep job, on a
        # thread of this process while the drill runs (nothing else here
        # launches a kernel)
        Xq, yq, oq = _pod_lockstep(device, 0)
        ref_out = {}

        def reference():
            t = time.perf_counter()
            ref_out["res"], *ref_out["counts"] = _counted(lambda: equation_search(
                Xq, yq, options=oq, niterations=POD_LOCKSTEP_ITERATIONS, verbosity=0))
            ref_out["s"] = time.perf_counter() - t

        ref_thread = threading.Thread(target=reference, daemon=True)
        ref_thread.start()
        for h in ("h0", "h1"):
            _expect_line(procs[h], "READY ", 300, f"pod (a): {h}")
        boot_s = time.perf_counter() - t_spawn
        _expect_line(procs["h2"], "WAITING", 300, "pod (b): h2")
        store = FileCoordStore(coord)
        client = PodClient(store=store, suspect_seconds=POD_SUSPECT_S)
        deadline = time.monotonic() + 60
        while {"h0", "h1"} - set(client.live_hosts()):
            if time.monotonic() > deadline:
                _fail("pod (a): the hosts never advertised")
            time.sleep(0.05)

        Xc, yc = config3_data()
        sent = {}

        def submit(spec, host=None):
            pjid = client.submit(spec, host=host)
            sent[pjid] = time.time()
            return pjid

        # h1's report maps the pod jobs to its local ids. The lockstep job
        # goes first; once it has a spool snapshot, the config3 job joins it
        # on h1's second worker (from then on the lockstep job's many syncs
        # wait behind the engine's work on the card, so it barely advances),
        # the short jobs queue behind them and two more are routed; h1 is
        # killed once the engine has a spool snapshot of iteration 2 or
        # later (its pipelined readback leaves the hall of fame of the first
        # snapshot empty)
        spool = os.path.join(coord, "_pod", "h1", "gen-0001", "spool")
        snap = re.compile(r"\.engine\.(\d+)$")

        def newest(pjid):
            job = (_reports(reports, "h1") or [{}])[-1].get("jobs", {}).get(pjid)
            its = [int(m.group(1)) + 1 for p in glob.glob(os.path.join(spool, f"{job}.engine.*"))
                   if job and (m := snap.search(p))]
            return max(its, default=0)

        def wait_until(cond, what):
            deadline = time.monotonic() + 300
            while not cond():
                if time.monotonic() > deadline:
                    _fail(f"pod (a): {what} never came")
                time.sleep(0.05)

        def alive():
            if client.done(long_id) is not None or client.done(eng_id) is not None:
                _fail(f"pod (a): a running job finished on h1 before the kill (lockstep "
                      f"{client.done(long_id) is not None}, config3 "
                      f"{client.done(eng_id) is not None}; {time.perf_counter() - t_sub:.2f} s "
                      f"after the lockstep submit; h1's jobs (state, iterations) "
                      f"{_reports(reports, 'h1')[-1].get('progress')})")
            return True

        t_sub, eng_id = time.perf_counter(), None
        long_id = submit(JobSpec(Xq, yq, options=oq, niterations=POD_LOCKSTEP_ITERATIONS),
                         host="h1")
        wait_until(lambda: alive() and newest(long_id) >= 1, "the lockstep job's first snapshot")
        t_first = time.perf_counter() - t_sub
        eng_id = submit(JobSpec(Xc, yc, options=_config3_options(device, 0),
                                niterations=POD_ENGINE_ITERATIONS), host="h1")
        wait_until(lambda: eng_id in _reports(reports, "h1")[-1].get("jobs", {}),
                   "h1's admission of the config3 job")
        pinned = [submit(JobSpec(X, y, options=o, niterations=4), host="h1")
                  for X, y, o in (_pod_short(device, 10 + s) for s in range(3))]
        free = [submit(JobSpec(X, y, options=o, niterations=2))
                for X, y, o in (_pod_short(device, 1 + s) for s in range(2))]
        all_ids = [long_id, eng_id, *pinned, *free]
        wait_until(lambda: alive() and newest(eng_id) >= 2, "the config3 job's spool snapshots")
        t_kill, kill_s = time.time(), time.perf_counter() - t_sub
        procs["h1"].send_signal(signal.SIGKILL)
        procs["h1"].wait(timeout=60)
        h1_rep = _reports(reports, "h1")[-1]
        ck = load_checkpoint(os.path.join(spool, h1_rep["jobs"][eng_id] + ".engine"))
        if not ck.pareto_frontier:
            _fail(f"pod (a): the config3 job's last snapshot (iteration {ck.iteration}) holds "
                  "no frontier")
        lease = _wait_claim(store, "srpod/pod0/claim/h1/gen-0001", 120, "pod (a)")
        recs = client.wait_all(all_ids, timeout=600)
        ref_thread.join(timeout=600)
        if "res" not in ref_out:
            _fail("pod (a): the lockstep reference run did not finish")
        ref, counts, ref_s = ref_out["res"], ref_out["counts"], ref_out["s"]
        ref_text = _members_text(ref.pareto_frontier, oq)
        ledger = client.results()
        if set(ledger) != set(all_ids):
            _fail(f"pod (a): done ledger {sorted(ledger)} != submitted {sorted(all_ids)}")
        bad = {p: r["state"] for p, r in recs.items() if r["state"] != DONE}
        if bad:
            _fail(f"pod (a): not DONE after the migration: {bad}")
        lrec, erec = recs[long_id], recs[eng_id]
        if lrec["host"] != "h0" or not lrec["resumed_from_iteration"]:
            _fail(f"pod (a): the lockstep job did not resume on h0: "
                  f"{ {k: v for k, v in lrec.items() if k != 'final_frame'} }")
        front = _members_text(load_frontier_bytes(lrec["final_frame"]).members, oq)
        if front != ref_text:
            _fail(f"pod (a): the migrated lockstep job's frontier differs from the "
                  f"uninterrupted run's\n  full:     {ref_text}\n  migrated: {front}")
        o3 = _config3_options(device, 0)
        upd = load_frontier_bytes(erec["final_frame"])
        final = [(m.get_complexity(o3), m.loss) for m in upd.members]
        lost = [(m.get_complexity(o3), m.loss) for m in ck.pareto_frontier
                if not any(c <= m.get_complexity(o3) and l <= m.loss + 1e-5 * abs(m.loss) + 1e-7
                           for c, l in final)]
        if erec["host"] != "h0" or not erec["resumed_from_iteration"] or lost:
            _fail(f"pod (a): the config3 job on {erec['host']}, resumed from "
                  f"{erec['resumed_from_iteration']}, lost {lost} of its snapshot's frontier")
        if not upd.num_evals > ck.num_evals or not all(np.isfinite(l) for _, l in final):
            _fail(f"pod (a): the config3 job's evaluations {upd.num_evals} (snapshot "
                  f"{ck.num_evals}) or a non-finite frontier")
        if client.hosts()["h0"]["duplicate_results"] != 0:
            _fail("pod (a): duplicate results after the migration")
        h0_rep = _report_after(reports, "h0", max(r["t"] for r in recs.values()))
        b1, b2, b3 = h0_rep["launches"][:3]
        if device.type == "cuda" and not (b1 and b2 and b3):
            _fail(f"pod (a): h0 launched B1 {b1}, B2 {b2}, B3 {b3}")
        adopt = [a for a in h0_rep["adoptions"] if a["host"] == "h1"]
        times = {"kill_to_claim_ms": (lease["t"] - t_kill) * 1e3,
                 "adopt_ms": adopt[0]["ms"] if adopt else None,
                 "done_s": {p: recs[p]["t"] - sent[p] for p in all_ids}}
        tag = {long_id: "lockstep (migrated)", eng_id: "config3 engine (migrated)",
               **{p: "short, pinned to h1" for p in pinned},
               **{p: "short, routed" for p in free}}
        print(f"pod (a): h0 and h1 READY {boot_s:.2f} s after their spawn; the uninterrupted "
              f"lockstep reference "
              f"{POD_LOCKSTEP_ITERATIONS} x {POD_LOCKSTEP_CYCLES} in this process ({ref_s:.2f} "
              f"s, B1 {counts[0]}); the lockstep job's first snapshot {t_first:.2f} s after its "
              f"submit; h1 SIGKILLed {kill_s:.2f} s after it, with the lockstep job and the "
              f"config3 job running "
              f"(config3 snapshot of iteration {ck.iteration}, {len(ck.pareto_frontier)} "
              f"frontier members, num_evals {ck.num_evals:.0f}) and "
              f"{len(h1_rep.get('jobs', {})) - 2} more of its jobs; suspect window "
              f"{POD_SUSPECT_S} s; kill to h0's claim {times['kill_to_claim_ms']:.1f} ms; "
              f"adoption {times['adopt_ms']:.3f} ms of host time in h0 "
              f"({adopt[0] if adopt else None})", flush=True)
        print(f"pod (a): {len(all_ids)} of {len(all_ids)} jobs DONE, 0 duplicates; the "
              f"lockstep job resumed on h0 from iteration {lrec['resumed_from_iteration']}, "
              f"its frontier equal to the uninterrupted run's string for string; the config3 "
              f"job resumed on h0 from iteration {erec['resumed_from_iteration']}, every "
              f"snapshot frontier member kept, num_evals {ck.num_evals:.0f} -> "
              f"{upd.num_evals:.0f}, best {min(l for _, l in final):.6g}; h0 launched B1 "
              f"{b1}, B2 {b2}, B3 {b3}; submit to DONE, s: "
              + ", ".join(f"{tag[p]} {times['done_s'][p]:.3f} on {recs[p]['host']}"
                          for p in all_ids), flush=True)

        # (b): the drain
        with open(go, "w"):
            pass
        _expect_line(procs["h2"], "READY ", 120, "pod (b): h2")
        deadline = time.monotonic() + 60
        while "h2" not in client.live_hosts():
            if time.monotonic() > deadline:
                _fail("pod (b): h2 never advertised")
            time.sleep(0.05)
        drain_ids = [submit(JobSpec(X, y, options=o, niterations=4), host="h2")
                     for X, y, o in (_pod_short(device, 20 + s) for s in range(2))]
        deadline = time.monotonic() + 120
        while True:
            ad = client.hosts().get("h2", {})
            owned = ad.get("queue_depth", 0) + ad.get("running", 0)
            settled = sum(1 for p in drain_ids if client.done(p) is not None)
            if owned + settled >= len(drain_ids):
                break
            if time.monotonic() > deadline:
                _fail("pod (b): h2 never consumed its inbox")
            time.sleep(0.02)
        t_term = time.time()
        procs["h2"].send_signal(signal.SIGTERM)
        if procs["h2"].wait(timeout=120) != 0:
            _fail(f"pod (b): the SIGTERM drain exited {procs['h2'].returncode}")
        if store.try_get("srpod/pod0/retire/h2/gen-0001") is None:
            _fail("pod (b): the drained host left no retirement marker")
        h2_rep = _report_after(reports, "h2", t_term, final=True)
        lease2 = _wait_claim(store, "srpod/pod0/claim/h2/gen-0001", 60, "pod (b)")
        drecs = client.wait_all(drain_ids, timeout=600)
        bad = {p: r["state"] for p, r in drecs.items() if r["state"] != DONE}
        if bad:
            _fail(f"pod (b): not DONE after the drain handoff: {bad}")
        if client.hosts()["h0"]["duplicate_results"] != 0:
            _fail("pod (b): duplicate results after the drain handoff")
        if set(client.results()) != set(all_ids + drain_ids):
            _fail("pod (b): the done ledger drifted after the drain")
        h0_rep = _report_after(reports, "h0", max(r["t"] for r in drecs.values()))
        times["handoff_s"] = lease2["t"] - t_term
        print(f"pod (b): h2 drained on SIGTERM and exited 0 ({h2_rep['stats']['tracked_jobs']} "
              f"jobs tracked), retirement marker published; SIGTERM to h0's claim "
              f"{times['handoff_s']:.3f} s; both jobs DONE (on "
              f"{sorted(r['host'] for r in drecs.values())}, resumed from "
              f"{[r['resumed_from_iteration'] for r in drecs.values()]}), 0 duplicates; "
              f"submit to DONE {[round(r['t'] - sent[p], 3) for p, r in drecs.items()]} s",
              flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for rep, need in ((h0_rep, ("fused_loss", "fused_loss_grad", "evolve_block")),
                      (h1_rep, ("fused_loss",)), (h2_rep, ("fused_loss",))):
        if device.type == "cuda":
            _check_child_builds(rep, parent_builds, tag=f"pod: {rep['host']}", need=need)
        elif rep["jax"]:
            _fail(f"pod: {rep['host']} imported a JAX module")
    pod = [0] * 5
    for rep in (h0_rep, h1_rep, h2_rep):
        pod = [a + b for a, b in zip(pod, rep["launches"])]
    return {"pod": tuple(pod), "pod reference": tuple(counts)}, times


def chaos_child(spec, import_s):
    """Phase 15 (c), in a child of the smoke: one seeded soak through the
    port's ``run_soak`` (``symbolicregression_jl_tpu_torch/scripts/
    chaos_soak.py``, JAX's soak): the schedule ``generate_schedule(
    spec["seed"], spec["duration"])`` over two pod hosts and a ``NetServer``
    host on the card, each a child booted with its ``host_env_spec`` slice,
    over a ``TorchCoordStore`` on a TCPStore this process hosts; JAX's
    workload, every observation audited by ``InvariantAuditor``. Returns the
    breaches, the report, the soak's own lines, the children's launches
    summed (each process's last report) and each child's libraries, JAX flag
    and armed faults."""
    import io

    from symbolicregression_jl_tpu_torch.scripts import chaos_soak
    from symbolicregression_jl_tpu_torch.utils import chaos

    t0 = time.perf_counter()
    sched = chaos.generate_schedule(spec["seed"], float(spec["duration"]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        auditor = chaos_soak.run_soak(sched, float(spec["duration"]), spec["dir"],
                                      device=spec["device"])
    print(buf.getvalue(), end="", flush=True)
    names = chaos_soak.KERNELS
    reps = chaos_soak.read_reports(spec["dir"])
    return {
        "schedule": chaos.schedule_spec(sched), "ok": auditor.ok,
        "breaches": [[b.invariant, b.detail] for b in auditor.breaches],
        "report": auditor.report(), "wall_s": time.perf_counter() - t0, "import_s": import_s,
        "launches": [sum(r["launches"][n] for r in reps) for n in names],
        "log": [ln[len("[chaos] "):] for ln in buf.getvalue().splitlines()
                if ln.startswith("[chaos] ")],
        "children": [{"host": r["host"], "pid": r["pid"], "libraries": r["libraries"],
                      "jax": r["jax"], "launches": [r["launches"][n] for n in names],
                      "faults": r["faults"], "partition": r.get("partition"),
                      "skew_suppressed": r.get("stats", {}).get("skew_suspects_suppressed")}
                     for r in reps],
        "jax": _jax_imported(),
    }


def pod_chaos(proc, parent_builds, device):
    """Phase 15 (c)'s checks on ``chaos_child``'s result (the child ran
    beside (a) and (b)): every invariant held, every child loaded the
    parent's libraries and imported nothing of JAX, the children launched
    B1. Prints the schedule, the soak's lines (kills and respawns), the
    auditor's report, each child's launches and faults. Returns the
    children's launches."""
    out, = _scale_results("pod (c)", [proc], timeout=900)
    print(f"pod (c) chaos soak through the port's run_soak: schedule {out['schedule']}; wall "
          f"{out['wall_s']:.2f} s (imports {out['import_s']:.2f} s); "
          + "; ".join(ln for ln in out["log"] if not ln.startswith("child ")), flush=True)
    print("pod (c) " + out["report"].replace("\n", "; "), flush=True)
    print("pod (c) children: " + "; ".join(
        f"{c['host']} ({c['pid']}): launches {c['launches'][:3]}, faults {c['faults']}"
        + (f", partition {c['partition']}" if c["partition"] else "")
        + (f", skew suspicions suppressed {c['skew_suppressed']}" if c["skew_suppressed"] else "")
        for c in out["children"]), flush=True)
    if not out["ok"]:
        _fail("pod (c): invariants breached: " + "; ".join(f"[{n}] {t}"
                                                          for n, t in out["breaches"]))
    for c in out["children"]:
        if device.type == "cuda":
            _check_child_builds(c, parent_builds, tag=f"pod (c): {c['host']} ({c['pid']})",
                                need=())
        elif c["jax"]:
            _fail(f"pod (c): {c['host']} imported a JAX module")
    if out["jax"]:
        _fail("pod (c): the chaos orchestrator imported a JAX module")
    if device.type == "cuda" and not out["launches"][0]:
        _fail("pod (c): the chaos children launched no B1")
    return tuple(out["launches"])


def pod_path(device):
    """Phase 15: (c)'s chaos orchestrator is started first, in a child that runs
    beside (a) and (b) (its rig is three more children); then (a) the kill
    drill and (b) the drain drill. Returns ({path: launches}, times)."""
    import tempfile

    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    t0 = time.perf_counter()
    parent_builds = {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "pod_child.py")
        with open(script, "w") as f:
            f.write(_POD_CHILD.format(root=os.path.dirname(os.path.abspath(__file__))))
        cdir = os.path.join(d, "chaos")
        os.makedirs(cdir)
        beside = _spawn_scale(script, "chaos", 0, {
            # the soak's jobs are lockstep jobs of two islands: never sharded
            "device": device.type, "dir": cdir, "seed": CHAOS_SEED,
            "duration": CHAOS_DURATION_S}, _pod_env(), log=os.path.join(d, "chaos.log"))
        try:
            paths, times = pod_federation(device, script, d, parent_builds)
            paths["chaos"] = pod_chaos(beside, parent_builds, device)
        finally:
            if beside.poll() is None:
                beside.kill()
                beside.wait()
    print(f"phase 15 pod: {time.perf_counter() - t0:.2f} s", flush=True)
    return paths, times


# ---------------------------------------------------------------------------
# Phase 16: the engine's in-process mesh (parallel/mesh.py, ops/evolve.py's
# sharded iteration, models/device_search.py's mesh decision)
# ---------------------------------------------------------------------------

# phase 16, cut in depth only (a mesh cycle of config3 is host work, ~80-140
# ms): (a) config3 at full width on a pop mesh of MESH_SHARDS shards,
# MESH_ITERATIONS x MESH_CYCLES; (b) a (2, 2) mesh under
# data_sharding="rows" on MESH_ROWS_ROWS rows, MESH_ROWS_ITERATIONS x
# MESH_ROWS_CYCLES
MESH_SHARDS, MESH_ITERATIONS, MESH_CYCLES = 4, 3, 30
MESH_ROWS_ITERATIONS, MESH_ROWS_CYCLES, MESH_ROWS_ROWS = 2, 10, 9998
# the check of B1 and B2 on every card: programs per call
MESH_CHECK_P = 512


def cards():
    """Every visible card, in index order."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _launches_by_card():
    """{wrapper name: {card: launches}} of B1 and B2 since the last reset."""
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_grad

    return {w.__name__: dict(getattr(w, "launches_by_device", {}))
            for w in (fused_loss, fused_loss_grad)}


def _reset_by_card():
    for w in _kernel_wrappers():
        w.launches_by_device = {}


def _frontier_honest(tag, res, X, y, options):
    """Every frontier loss is its tree's mean squared error, evaluated on
    the host in f64 (rel 1e-3, abs 1e-4: the JAX package's bar in its
    sharded-engine tests)."""
    import numpy as np

    front = res.pareto_frontier
    if not front:
        _fail(f"{tag}: empty frontier")
    for m in front:
        pred = m.tree.eval_np(X.astype(np.float64), options.operators)
        true = float(np.mean((pred - y.astype(np.float64)) ** 2))
        if not abs(true - m.loss) <= max(1e-3 * abs(true), 1e-4):
            _fail(f"{tag}: frontier loss {m.loss!r} of "
                  f"{m.tree.string_tree(options.operators)} is {true!r} on the host")
    return len(front)


def mesh_search(tag, devices, iterations, cycles, rows=False, layout=None):
    """One config3 search on the engine's mesh: ``Options(mesh_devices=
    devices)`` (``layout``: how the search sees them, for the print); with
    ``rows``, ``data_sharding="rows"`` on the first MESH_ROWS_ROWS rows,
    where the engine's rule picks (2, 2) over four devices, else islands
    over every device. Every evolve and const-opt leg is timed between synchronizations
    of every card; the first evolve leg runs with host syncs made errors;
    after every iteration the replicated leaves of every shard are held
    against shard 0's on the card (read once, at the end). Checks the mesh
    the engine chose, the frontier's honesty, num_evals, the launches
    against the scorers' calls and no B3. Returns (result, options,
    launches, launches by card, stats)."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data()
    if rows:
        X, y = X[:, :MESH_ROWS_ROWS].copy(), y[:MESH_ROWS_ROWS].copy()
    options = Options(
        populations=100, population_size=100, maxsize=20, ncycles_per_iteration=cycles,
        seed=0, save_to_file=False, progress=False, device=str(devices[0]),
        mesh_devices=[str(d) for d in devices], scheduler="device",
        data_sharding="rows" if rows else None, **CONFIG3_OPS,
    )
    on = sorted({d.index for d in devices})
    walls, seen, diffs = {}, {}, []

    def sync_all():
        for i in on:
            torch.cuda.synchronize(i)

    def leg_wrap(name):
        seen[name] = nth = seen.get(name, 0) + 1
        if name not in ("evolve", "const_opt", "finalize"):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def timed():
            sync_all()
            t0 = time.perf_counter()
            guard = name == "evolve" and nth == 1
            if guard:
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                if guard:
                    torch.cuda.set_sync_debug_mode(0)
            sync_all()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
        return timed()

    def state_hook(states):
        dev0 = states[0].freq.device
        ref = states[0]

        def leaves(st):
            return [st.freq, st.bs_loss, *st.bs_tree, st.bs_exists, st.step, st.num_evals,
                    st.iteration]

        flags = [(a.to(dev0) != b).any()
                 for st in states[1:] for a, b in zip(leaves(st), leaves(ref))]
        if flags:
            diffs.append(torch.stack(flags).any())

    saved = ds._LEG_WRAP, ds._STATE_HOOK
    ds._LEG_WRAP, ds._STATE_HOOK = leg_wrap, state_hook
    try:
        _reset_by_card()
        zero_launches()
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=iterations, verbosity=0)
        wall = time.perf_counter() - t0
        counts = read_launches()
        by_card = _launches_by_card()
    finally:
        ds._LEG_WRAP, ds._STATE_HOOK = saved
    st = res.engine_stats
    mesh = st.get("mesh")
    want = (2, 2) if rows else (len(devices), 1)
    if mesh is None or tuple(mesh["shape"]) != tuple(want):
        _fail(f"mesh {tag}: the engine ran on {mesh and mesh['shape']}, not a {want} mesh")
    if mesh["devices"] != [str(d) for d in devices]:
        _fail(f"mesh {tag}: the shards ran on {mesh['devices']}")
    if len(diffs) != iterations or bool(torch.stack(diffs).any()):
        _fail(f"mesh {tag}: the replicated leaves differ between shards")
    if st["block"] is not None or counts[2]:
        _fail(f"mesh {tag}: the evolve block ran under a mesh ({counts[2]} B3 launches)")
    if counts[0] != st["score_calls"] or counts[0] == 0:
        _fail(f"mesh {tag}: {counts[0]} B1 launches for {st['score_calls']} scoring calls")
    if counts[1] != st["grad_calls"]:
        _fail(f"mesh {tag}: {counts[1]} B2 launches for {st['grad_calls']} gradient calls")
    if not res.num_evals > 0:
        _fail(f"mesh {tag}: num_evals {res.num_evals}")
    n_front = _frontier_honest(f"mesh {tag}", res, X, y, options)
    n_cycles = iterations * cycles
    # the evolve leg's collectives (the const-opt leg's are per line search)
    coll = mesh["collectives_by_leg"].get("evolve", {})
    pop = coll.get("pop", {})
    rows_c = coll.get("rows", {})
    stats = {
        "evolve_ms_per_cycle": sum(walls["evolve"]) / n_cycles * 1e3,
        "evolve_device_ms_per_cycle": st["device_seconds"].get("evolve", 0.0) / n_cycles * 1e3,
        "const_opt_ms": [w * 1e3 for w in walls.get("const_opt", [])],
        "wall_s": wall, "main_loop_s": res.iteration_seconds,
        "evals_per_s": res.num_evals / res.iteration_seconds,
        "pop_gathers_per_cycle": pop.get("gathers", 0) / max(pop.get("groups", 1), 1) / n_cycles,
        "rows_gathers_per_cycle": (rows_c.get("gathers", 0) / max(rows_c.get("groups", 1), 1)
                                   / n_cycles),
        "gather_ms": {ax: (c["gather_seconds"] / c["gathers"] * 1e3 if c["gathers"] else 0.0,
                           c["wait_seconds"] / (c["gathers"] * len(devices) / c["groups"]) * 1e3
                           if c["gathers"] else 0.0, c["transport"])
                      for ax, c in coll.items()},
    }
    print(f"mesh {tag}: config3 100x100, {y.shape[0]} rows x {CONFIG3_FEATURES} features, "
          f"{iterations} x {cycles} cycles on a {tuple(mesh['shape'])} mesh over "
          f"{layout or mesh['devices']}: wall {wall:.3f} s (set-up {res.setup_seconds:.3f} s, "
          f"main loop {res.iteration_seconds:.3f} s); evolve "
          f"{stats['evolve_ms_per_cycle']:.4f} ms/cycle between syncs (CUDA events "
          f"{stats['evolve_device_ms_per_cycle']:.4f}; evolve leg ms per iteration "
          + ", ".join(f"{w * 1e3:.1f}" for w in walls["evolve"])
          + "); const-opt leg ms "
          + ", ".join(f"{v:.1f}" for v in stats["const_opt_ms"])
          + (f"; finalize leg ms " + ", ".join(f"{w * 1e3:.1f}" for w in walls["finalize"])
             if "finalize" in walls else "")
          + f"; evolve leg's gathers per group per cycle: pop "
          f"{stats['pop_gathers_per_cycle']:.3f}, rows {stats['rows_gathers_per_cycle']:.3f}; "
          f"per gather (launch ms, mean wait ms per shard, transport): "
          + ", ".join(f"{ax} {a:.4f} / {b:.4f} / {t}"
                      for ax, (a, b, t) in stats["gather_ms"].items())
          + f"; {stats['evals_per_s']:.4g} evals/s; B1 {counts[0]} = {st['score_calls']} "
          f"scoring calls, B2 {counts[1]} = {st['grad_calls']} gradient calls, B3 0; by card "
          f"B1 {by_card['fused_loss']}, B2 {by_card['fused_loss_grad']}; first evolve leg made "
          f"no host sync; replicated leaves equal on every shard after each iteration; "
          f"{n_front} frontier losses equal their host f64 losses; num_evals "
          f"{res.num_evals:.0f}; best {min(m.loss for m in res.pareto_frontier):.6g}",
          flush=True)
    return res, options, counts, by_card, stats


def mesh_solo(mesh_stats, iterations, cycles):
    """(d) What the default asks for on this machine: ``Options(device=
    "cuda")`` with no ``mesh_devices`` runs config3 on one card on the
    evolve block, however many cards there are, at (a)'s depth; its evals/s
    beside (a)'s. Returns its launches."""
    import torch

    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data()
    options = Options(
        populations=100, population_size=100, maxsize=20, ncycles_per_iteration=cycles,
        seed=0, save_to_file=False, progress=False, device="cuda", scheduler="device",
        **CONFIG3_OPS,
    )
    _reset_by_card()
    zero_launches()
    res = equation_search(X, y, options=options, niterations=iterations, verbosity=0)
    counts = read_launches()
    by_card = _launches_by_card()
    st = res.engine_stats
    if "mesh" in st or st["block"] != "kernel" or counts[2] != st["iterations"]:
        _fail(f"mesh (d): Options(device='cuda') ran mesh {st.get('mesh')}, block "
              f"{st['block']}, {counts[2]} B3 launches in {st['iterations']} iterations")
    if set(by_card["fused_loss"]) != {f"cuda:{torch.cuda.current_device()}"}:
        _fail(f"mesh (d): B1 launched on {by_card['fused_loss']}")
    n_front = _frontier_honest("mesh (d)", res, X, y, options)
    eps = res.num_evals / res.iteration_seconds
    print(f"mesh (d) solo: Options(device='cuda') on {torch.cuda.device_count()} card(s), "
          f"{iterations} x {cycles} cycles: no mesh, on {list(by_card['fused_loss'])} on the "
          f"block (B3 {counts[2]}, B1 {counts[0]}, B2 {counts[1]}); main loop "
          f"{res.iteration_seconds:.3f} s, {eps:.4g} evals/s against (a)'s "
          f"{mesh_stats['evals_per_s']:.4g} ({eps / mesh_stats['evals_per_s']:.1f}x); "
          f"{n_front} frontier losses equal their host f64 losses", flush=True)
    return counts


def _frontier_bits(res, options):
    """The hall of fame's frontier: complexity, loss and tree, per member."""
    return [(m.get_complexity(options), repr(m.loss), m.tree.string_tree(options.operators))
            for m in sorted(res.hall_of_fame.pareto_frontier(),
                            key=lambda m: m.get_complexity(options))]


def mesh_kernels_every_card(devs, P=MESH_CHECK_P):
    """B1 and B2 on each card held against their plain versions on the same
    card, at config3's width and rows. Returns {kernel: worst error}."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference, fused_loss_reference,
    )

    opts = Options(maxsize=20, device="cuda:0", **CONFIG3_OPS)
    opset, N, loss = opts.operators, opts.max_nodes, opts.loss
    Xn, yn = config3_data()
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=1601)
    errs = {"fused_loss": Err(0.0), "fused_loss_grad": Err(0.0)}
    for d in devs:
        X, y = torch.from_numpy(Xn).to(d), torch.from_numpy(yn).to(d)
        prog, vals = torch.from_numpy(prog_np).to(d), torch.from_numpy(vals_np).to(d)
        got = fused_loss(prog, vals, X, y, None, opset, loss)
        ref = fused_loss_reference(prog, vals, X, y, None, opset, loss)
        gl, gg = fused_loss_grad(prog, vals, X, y, None, opset, loss)
        rl, rg = fused_loss_grad_reference(prog, vals, X, y, None, opset, loss)
        torch.cuda.synchronize(d)
        for t in (got, gl, gg):
            if t.device != d:
                _fail(f"mesh (c): a kernel's output landed on {t.device}, not {d}")
        errs["fused_loss"] = worst_err(errs["fused_loss"],
                                       compare(f"mesh (c) B1 on {d}", got, ref),
                                       compare(f"mesh (c) B2 losses on {d}", gl, rl))
        errs["fused_loss_grad"] = worst_err(errs["fused_loss_grad"],
                                            compare_grads(f"mesh (c) B2 on {d}", gg, rg))
    print(f"mesh (c): B1 and B2 at {P} programs x {CONFIG3_ROWS} rows on each of "
          f"{[str(d) for d in devs]} within tolerance of their plain versions on the same card "
          f"(worst abs error B1 {float(errs['fused_loss']):.3e}, B2 "
          f"{float(errs['fused_loss_grad']):.3e})", flush=True)
    return errs


def mesh_rows_b1(devs, rows=ROWS_SHARDED, P=1024):
    """Phase 14 (d)'s row-sharded B1 over the real cards: ``make_sharded_loss``
    over a 1 x len(devs) mesh at ``rows`` rows, held against one B1 call over
    all rows on the first card, both timed. Returns the B1 launches of the
    sharded call."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, optab_tensor, unpack_programs_fused, work_counts,
    )
    from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh
    from symbolicregression_jl_tpu_torch.parallel.sharding import (
        make_sharded_loss, shard_dataset, shard_population,
    )

    opts = Options(maxsize=20, device="cuda:0", **CONFIG3_OPS)
    opset, N, loss = opts.operators, opts.max_nodes, opts.loss
    Xn, yn = config3_data(n_rows=rows, seed=5)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P + 1)
    flat = unpack_programs_fused(prog_np, vals_np, opset)
    d0 = devs[0]
    X, y = torch.from_numpy(Xn).to(d0), torch.from_numpy(yn).to(d0)
    prog, vals = torch.from_numpy(prog_np).to(d0), torch.from_numpy(vals_np).to(d0)
    tab = optab_tensor(opset, d0)
    mesh = make_mesh(1, len(devs), devices=devs)
    fs = shard_population(mesh, flat)
    loss_fn = make_sharded_loss(mesh, opset, loss)
    Xs, ys, ws = shard_dataset(mesh, X, y, None)
    _reset_by_card()
    zero_launches()
    got = loss_fn(fs, Xs, ys, ws)
    for d in devs:
        torch.cuda.synchronize(d)
    counts = read_launches()
    by_card = _launches_by_card()["fused_loss"]
    if counts[0] != len(devs) or sorted(by_card) != sorted(str(d) for d in devs):
        _fail(f"mesh (c) rows: B1 launches {counts[0]} by card {by_card} over {devs}")
    one = fused_loss(prog, vals, X, y, None, opset, loss, tab)
    torch.cuda.synchronize(d0)
    err = compare("mesh (c) rows: the sharded loss over the cards against one B1 call",
                  got, one)

    def sharded():
        loss_fn(fs, Xs, ys, ws)
        for d in devs:
            torch.cuda.synchronize(d)

    ms = time_ms(sharded, warmup=1, reps=10)
    one_ms = time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, loss, tab), warmup=1,
                     reps=10)
    work = work_counts(prog_np, rows, CONFIG3_FEATURES, weighted=False)
    bound = max(work["operations"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES) * 1e3
    print(f"mesh (c) rows: make_sharded_loss over {[str(d) for d in devs]} at {rows} rows x "
          f"{CONFIG3_FEATURES} features x {P} programs: {ms:.3f} ms (one launch per card, "
          f"{by_card}) against one B1 call over all rows on {d0} {one_ms:.3f} ms (bound "
          f"{bound:.4f} ms for the whole work on one card); within phase 14 (d)'s tolerance "
          f"of the one call (worst abs error {float(err):.3e})", flush=True)
    return counts, err


def mesh_path(device):
    """Phase 16: the engine's in-process mesh over every card of the
    machine. (a) config3 at full width on a pop mesh of four shards: one
    per card with four cards, else all four on cuda:0, named by
    ``Options.mesh_devices``; (b) the same shards under
    data_sharding="rows", a (2, 2) mesh by the engine's rule; (d)
    ``Options(device="cuda")`` alone, one card on the block; (c) with two
    cards or more: (a) again with the four shards on cuda:0,
    bit for bit (a)'s frontier and num_evals; B1 and B2 against their
    plain versions on every card; the row-sharded B1 at 1M rows over the
    cards against one B1 call. Returns ({path: launches}, {kernel: worst
    error})."""
    t0 = time.perf_counter()
    devs = cards()
    multi = len(devs) >= 2
    if multi and len(devs) != MESH_SHARDS:
        _fail(f"mesh: {len(devs)} cards; the phase lays {MESH_SHARDS} shards over one card or "
              f"{MESH_SHARDS}")
    one_card = [device] * MESH_SHARDS
    layout = devs if multi else one_card
    paths, errs = {}, {}
    res_a, opts_a, counts, _, stats_a = mesh_search(
        "(a)", layout, MESH_ITERATIONS, MESH_CYCLES,
        layout=("one shard per card" if multi else f"{MESH_SHARDS} shards on {device}"))
    paths["mesh"] = counts
    _, _, counts_b, _, _ = mesh_search(
        "(b) rows", layout, MESH_ROWS_ITERATIONS, MESH_ROWS_CYCLES, rows=True)
    paths["mesh rows"] = counts_b
    paths["mesh solo"] = mesh_solo(stats_a, MESH_ITERATIONS, MESH_CYCLES)
    if multi:
        res_c, _, _, _, _ = mesh_search("(c) one card", one_card, MESH_ITERATIONS,
                                        MESH_CYCLES, layout=f"{MESH_SHARDS} shards on {device}")
        if (_frontier_bits(res_a, opts_a) != _frontier_bits(res_c, opts_a)
                or res_a.num_evals != res_c.num_evals):
            _fail(f"mesh (c): four cards and one card differ:\n"
                  f"{_frontier_bits(res_a, opts_a)} {res_a.num_evals}\n"
                  f"{_frontier_bits(res_c, opts_a)} {res_c.num_evals}")
        print(f"mesh (c): the four-card and the one-card layouts give the same frontier and "
              f"num_evals ({res_a.num_evals:.0f}) bit for bit", flush=True)
        errs = mesh_kernels_every_card(devs)
        paths["mesh rows B1"], err = mesh_rows_b1(devs)
        errs["fused_loss"] = worst_err(errs["fused_loss"], err)
    print(f"phase 16 mesh: {time.perf_counter() - t0:.2f} s over {len(devs)} card(s)",
          flush=True)
    return paths, errs


# ---------------------------------------------------------------------------
# Phase 17: the drills
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _verify_sites():
    """Count the flat-IR verifier's calls by site (its ``where`` prefix),
    through the module attribute every gated site calls; yields the counts
    and puts the verifier back."""
    from symbolicregression_jl_tpu_torch.analysis import ir_verify

    calls, real = {}, ir_verify.verify_flat_trees

    def counting(*a, **kw):
        site = kw.get("where", "").split(":")[0]
        calls[site] = calls.get(site, 0) + 1
        return real(*a, **kw)

    ir_verify.verify_flat_trees = counting
    try:
        yield calls
    finally:
        ir_verify.verify_flat_trees = real


def drills_path(device):
    """Phase 17: the drill CLIs' functions on the card, steps (a)-(e), each
    of which raises on failure. Returns its (B1, B2, B3, B4, B2v) launches,
    the path "drills"."""
    from symbolicregression_jl_tpu_torch.scripts import (
        debug_checks_smoke, fault_smoke, fleet_smoke, serve_smoke,
    )
    from symbolicregression_jl_tpu_torch.utils import faults

    dev = str(device)
    faults.install(None)  # no fault of an earlier phase reaches the drills
    faults.reset_env_injector()
    walls = {}
    t0 = time.perf_counter()
    zero_launches()

    t = time.perf_counter()
    before = os.environ.get("SR_DEBUG_CHECKS")
    with _verify_sites() as calls:
        debug_checks_smoke.run(dev)
    if os.environ.get("SR_DEBUG_CHECKS") != before:
        _fail("drills (a): SR_DEBUG_CHECKS outlived the drill")
    sites = ("scorer.loss_many_async", "device_search._bs_to_members",
             "device_search._decode_state_populations")
    if not all(calls.get(site, 0) > 0 for site in sites):
        _fail(f"drills (a): verifier calls by site {calls}")
    walls["a"] = time.perf_counter() - t
    print(f"drills (a) debug checks: both schedulers, checkpoint and resume; verifier calls "
          f"by site {calls}; none raised; {walls['a']:.2f} s", flush=True)

    t = time.perf_counter()
    st = serve_smoke.run(dev)
    walls["b"] = time.perf_counter() - t
    cache = st["program_cache"]
    print(f"drills (b) serve: jobs {st['jobs']}, default_quota 4 over two tenants, program "
          f"cache {cache['hits']} hits / {cache['misses']} misses (warm-hit ratio "
          f"{st['warm_hit_ratio']:.3f}); {walls['b']:.2f} s", flush=True)

    t = time.perf_counter()
    jobs = fleet_smoke.cancel_mid_fleet(dev)
    walls["c"] = time.perf_counter() - t
    print(f"drills (c) cancel mid-fleet: lane 1 {jobs[1].state} after "
          f"{jobs[1].iterations_done} of 12 iterations, 3 survivors DONE bit for bit their "
          f"solo runs; {walls['c']:.2f} s", flush=True)

    t = time.perf_counter()
    fault_smoke.smoke_serve_durability(dev)
    walls["d"] = time.perf_counter() - t
    print(f"drills (d) serve cycle: {walls['d']:.2f} s", flush=True)

    t = time.perf_counter()
    fault_smoke.smoke_degraded_exchange(dev)
    walls["e"] = time.perf_counter() - t
    print(f"drills (e) exchange cycle: {walls['e']:.2f} s", flush=True)

    counts = read_launches()
    if not (counts[0] and counts[1] and counts[2]) or counts[3] or counts[4]:
        _fail(f"drills: launches B1, B2, B3, B4, B2v {counts} (B1, B2, B3 above 0; B4 and "
              f"B2v 0)")
    print(f"phase 17 drills: {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"({k}) {v:.2f}" for k, v in walls.items())
          + f"); launches B1 {counts[0]}, B2 {counts[1]}, B3 {counts[2]}, B4 {counts[3]}, "
          f"B2v {counts[4]} (the children of (d) and (e) not counted)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 18: native tree flattening
# ---------------------------------------------------------------------------

def native_build():
    """(a): the srcore extension the run loaded at its first flatten (the
    checkout holds no build), and a fresh build of the same source into a
    temporary directory, timed; fails without Python.h."""
    import tempfile
    from pathlib import Path

    from symbolicregression_jl_tpu_torch import native

    if native.get_srcore() is None:
        _fail("native (a): SR_NO_NATIVE=1 is set")
    first = dict(native.BUILD_INFO)
    saved = native.BUILD_DIR
    with tempfile.TemporaryDirectory() as d:
        native.BUILD_DIR = Path(d)
        try:
            native.build()
            fresh = dict(native.BUILD_INFO)
        finally:
            native.BUILD_DIR = saved
    if not fresh["python_h"]:
        _fail(f"native (a): no Python.h under {fresh['include']}")
    print(f"native (a) build: {fresh['compiler']} {fresh['flags']} -I{fresh['include']} "
          f"(Python.h found); the run's first flatten {'built' if first['built'] else 'loaded'} "
          f"{first['library']} in {first['seconds']:.3f} s; a fresh build of the same source "
          f"{fresh['seconds']:.3f} s", flush=True)


def native_special_dags(opset, n_features, seed=0, n=400):
    """Graph-node DAGs (shared subtrees) at config3's operators, with the
    constants that test the f32 cast: beyond its range, non-finite, signed
    zero, the smallest subnormal."""
    import numpy as np

    from symbolicregression_jl_tpu_torch.models.mutation_functions import (
        form_random_connection, gen_random_tree_fixed_size,
    )

    special = [1e39, -1e39, float("inf"), float("-inf"), float("nan"), -0.0, 1e-45]
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = gen_random_tree_fixed_size(int(rng.integers(5, 16)), opset, n_features, rng)
        for _ in range(3):
            t = form_random_connection(t, rng)
        consts = [m for m in t.iter_unique() if m.degree == 0 and m.is_const]
        for k, m in enumerate(consts):
            m.val = special[(len(out) + k) % len(special)]
        if len(t.postorder()) <= 24:
            out.append(t)
    return out


def _same_flat(tag, got, want):
    for name, a, b in zip(got._fields, got, want):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            _fail(f"native (b) {tag}: {name} differs between C and plain")


def native_bits(tag, trees, options):
    """(b) on one set: ``flatten_trees`` (C) against ``flatten_trees_plain``,
    every array as bytes (val as uint32 bits); ``FlatSlab.set_trees`` (C)
    against its ``set_tree`` loop and ``pack_programs_fused`` of the flatten.
    Returns the slab."""
    import warnings

    from symbolicregression_jl_tpu_torch.ops.flat import (
        FlatSlab, flatten_trees, flatten_trees_plain,
    )
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import pack_programs_fused

    N, opset = options.max_nodes, options.operators
    got = flatten_trees(trees, N)
    with warnings.catch_warnings():  # numpy warns where a cast overflows to inf
        warnings.simplefilter("ignore", RuntimeWarning)
        want = flatten_trees_plain(trees, N)
        loop = FlatSlab(len(trees), N, opset)
        for k, t in enumerate(trees):
            loop.set_tree(k, t)
    _same_flat(tag, got, want)
    slab = FlatSlab(len(trees), N, opset)
    slab.set_trees(trees)
    prog, vals = pack_programs_fused(got, opset)
    for what, (a, b) in (("set_tree loop", (loop.ints, loop.vals)),
                         ("pack_programs_fused", (prog, vals))):
        if slab.ints.tobytes() != a.tobytes() or slab.vals.tobytes() != b.tobytes():
            _fail(f"native (b) {tag}: the slab differs from its {what}")
    print(f"native (b) {tag}: {len(trees)} trees (lengths {int(got.length.min())}-"
          f"{int(got.length.max())}), C and plain flatten equal in every array, val as uint32 "
          f"bits; slab equal to its set_tree loop and to pack_programs_fused", flush=True)
    return slab


def native_host_ms(fn, reps=20):
    """Median and spread (min-max) of ``reps`` host-clock calls of fn, ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def native_lockstep(device, flatten, cycles=NATIVE_LOCKSTEP_CYCLES, seed=0):
    """(e), one run: config3 lockstep, 1 iteration x ``cycles``, every
    flatten of the scorer and of const-opt through ``flatten`` (patched into
    the modules, as ``main_path`` patches ``fused_loss``), timed on the host
    clock inside the cycles and outside them. Returns the result, its
    stats, and the largest batch the scorer flattened inside a cycle."""
    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
    import symbolicregression_jl_tpu_torch.ops.constant_opt as copt_mod
    import symbolicregression_jl_tpu_torch.search as search_mod
    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data()
    options = Options(
        populations=100, population_size=100, maxsize=20, ncycles_per_iteration=cycles,
        seed=seed, save_to_file=False, progress=False, device=str(device),
        should_optimize_constants=False, **CONFIG3_OPS,
    )
    st = {"cycle_s": 0.0, "flatten_cycle_s": 0.0, "flatten_other_s": 0.0, "calls": 0,
          "biggest": []}
    in_cycle = [False]
    saved = {"cycle": search_mod.s_r_cycle_lockstep, "scorer": scorer_mod.flatten_trees,
             "copt": copt_mod.flatten_trees}

    def cycle(*args, **kwargs):
        t0 = time.perf_counter()
        in_cycle[0] = True
        try:
            return saved["cycle"](*args, **kwargs)
        finally:
            in_cycle[0] = False
            st["cycle_s"] += time.perf_counter() - t0

    def timed(trees, *args, **kwargs):
        t0 = time.perf_counter()
        out = flatten(trees, *args, **kwargs)
        st["flatten_cycle_s" if in_cycle[0] else "flatten_other_s"] += time.perf_counter() - t0
        st["calls"] += 1
        if in_cycle[0] and len(trees) > len(st["biggest"]):
            st["biggest"] = list(trees)
        return out

    search_mod.s_r_cycle_lockstep = cycle
    scorer_mod.flatten_trees = copt_mod.flatten_trees = timed
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=1, verbosity=0)
        st["wall_s"] = time.perf_counter() - t0
        st["launches"] = read_launches()
    finally:
        search_mod.s_r_cycle_lockstep = saved["cycle"]
        scorer_mod.flatten_trees, copt_mod.flatten_trees = saved["scorer"], saved["copt"]
    if not res.use_kernel or st["launches"][0] != res.scoring_dispatches:
        _fail(f"native (e): B1 launches {st['launches'][0]} for {res.scoring_dispatches} "
              f"scoring dispatches")
    return res, options, st


def native_path(device):
    """Phase 18: the port's C tree flattening (``native/srcore.c`` through
    ``ops/flat.py``) on the card's host, steps (a)-(e), each of which raises
    on failure. Returns the (B1, B2, B3, B4, B2v) launches of (c), the path
    "native", those of (e)'s four runs, "native lockstep", and (c)'s
    error."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.models.population import Population
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees, flatten_trees_plain
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, make_packed_loss_fn, pack_programs_fused,
    )

    t0 = time.perf_counter()
    native_build()
    options = Options(maxsize=20, device=str(device), **CONFIG3_OPS)
    N, opset = options.max_nodes, options.operators

    # (e) first: its first run gives (b) a lockstep cycle's candidates
    runs = []
    for tag, fn in (("C", flatten_trees), ("plain", flatten_trees_plain),
                    ("plain", flatten_trees_plain), ("C", flatten_trees)):
        res, run_opts, st = native_lockstep(device, fn)
        runs.append((tag, res, run_opts, st))
    fronts = [(_frontier_bits(res, o), res.num_evals) for _, res, o, _ in runs]
    if any(f != fronts[0] for f in fronts[1:]):
        _fail("native (e): the four runs' halls of fame differ:\n"
              + "\n".join(f"{f}" for f in fronts))
    cycles = NATIVE_LOCKSTEP_CYCLES
    for tag, res, _, st in runs:
        print(f"native (e) lockstep {tag}: config3 1 x {cycles} cycles (const-opt off), wall "
              f"{st['wall_s']:.3f} s, {st['cycle_s'] / cycles * 1e3:.2f} ms/cycle, flatten "
              f"{st['flatten_cycle_s'] / cycles * 1e3:.3f} ms/cycle "
              f"({st['flatten_cycle_s'] / st['cycle_s']:.2%} of the cycles), set-up flatten "
              f"{st['flatten_other_s'] * 1e3:.2f} ms, {st['calls']} calls, B1 launches "
              f"{st['launches'][0]}", flush=True)
    print(f"native (e): C, plain, plain, C: the same hall of fame ({len(fronts[0][0])} members, "
          f"equation strings and loss bits) and num_evals ({fronts[0][1]:.0f}) in all four",
          flush=True)
    lock_counts = tuple(sum(st["launches"][i] for *_, st in runs) for i in range(5))

    # (b) bit for bit on three sets
    rng = np.random.default_rng(0)
    population = Population.random_trees(10_000, options, CONFIG3_FEATURES, rng)
    candidates = runs[0][3]["biggest"]
    slab = native_bits("config3 population", population, options)
    native_bits("a lockstep cycle's candidates", candidates, options)
    native_bits("graph-node DAGs, special constants",
                native_special_dags(opset, CONFIG3_FEATURES), options)

    # (c) B1 on the population's slab against B1 on the packed batch
    Xn, yn = config3_data()
    fn = make_packed_loss_fn(Xn, yn, None, opset, options.loss, N, device=device)
    zero_launches()
    got = fn(slab.ints, slab.vals)
    torch.cuda.synchronize()
    counts = read_launches()
    prog, vals = pack_programs_fused(flatten_trees(population, N), opset)
    saved = fused_loss.launches
    want = fused_loss(torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device),
                      torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device), None,
                      opset, options.loss)
    torch.cuda.synchronize()
    fused_loss.launches = saved  # the comparison's launch is not the path's
    if counts[0] != 1 or any(counts[1:]):
        _fail(f"native (c): launches B1, B2, B3, B4, B2v {counts} (one B1)")
    if got.cpu().numpy().tobytes() != want.cpu().numpy().tobytes():
        _fail("native (c): B1 on the slab differs from B1 on the packed batch")
    print(f"native (c): make_packed_loss_fn on the {len(population)}-tree slab x "
          f"{CONFIG3_ROWS} rows equals fused_loss on pack_programs_fused bit for bit "
          f"({int(torch.isfinite(got).sum())} finite losses), one B1 launch", flush=True)

    # (d) host ms per call
    for tag, trees in (("cycle", candidates), ("population", population)):
        c = native_host_ms(lambda: flatten_trees(trees, N))
        p = native_host_ms(lambda: flatten_trees_plain(trees, N))
        print(f"native (d) flatten {len(trees)} trees ({tag}): C {c['median']:.4f} ms "
              f"({c['min']:.4f}-{c['max']:.4f}), plain {p['median']:.4f} ms "
              f"({p['min']:.4f}-{p['max']:.4f}), plain / C {p['median'] / c['median']:.2f}x; "
              f"medians of 20, host clock", flush=True)
    from symbolicregression_jl_tpu_torch.ops.flat import FlatSlab

    s = FlatSlab(len(population), N, opset)

    def loop():
        for k, t in enumerate(population):
            s.set_tree(k, t)

    c = native_host_ms(lambda: s.set_trees(population))
    p = native_host_ms(loop)
    print(f"native (d) slab {len(population)} trees: set_trees (C) {c['median']:.4f} ms "
          f"({c['min']:.4f}-{c['max']:.4f}), set_tree loop {p['median']:.4f} ms "
          f"({p['min']:.4f}-{p['max']:.4f})", flush=True)
    print(f"phase 18 native: {time.perf_counter() - t0:.2f} s; launches B1 {counts[0]} (native), "
          f"{lock_counts[0]} (native lockstep)", flush=True)
    return counts, lock_counts, Err(0.0)


def build_from_two_threads():
    """Phase 1's build, asked for by two threads at once (a server's workers
    reaching the kernels first together): ``build_all`` serializes them, so
    each library is built once (one nvcc per source) and both threads get
    the same loaded libraries; no temporary library is left behind."""
    import threading

    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    got, errs = [None, None], []

    def run(i):
        try:
            got[i] = interp_cuda.build_all()
        except BaseException as e:  # re-raised below, on the main thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    if set(interp_cuda.BUILD_INFO) != set(interp_cuda.SOURCES) or any(
            got[0][n] is not got[1][n] or not interp_cuda._lib_path(n).exists()
            for n in interp_cuda.SOURCES):
        _fail("build: the two threads' builds differ")
    if list(interp_cuda.BUILD_DIR.glob("*.tmp.so")):
        _fail("build: a temporary library was left behind")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from symbolicregression_jl_tpu_torch.ops import interp_cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build_from_two_threads()
    print(f"build: {', '.join(interp_cuda.SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel; asked for by two threads at once, as a "
          f"server's workers do, and built once)", flush=True)
    for name, info in interp_cuda.BUILD_INFO.items():
        print(f"  {name}: {info['library']}", flush=True)
        for line in info["log"].splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    b1 = kernel_check(device)
    b2 = grad_kernel_check(device)
    operator_isolation(device)
    b3 = block_kernel_check(device)
    b4 = preds_kernel_check(device)
    # {path: (B1, B2, B3, B4, B2v) launches}, each read just after the path
    # ran with the counts set to 0 just before it (B4 and B2v run on the
    # full-objective paths of phase 13 only)
    paths = {}
    paths["lockstep"], lockstep_stats = main_path(device)
    srl003 = lint_port()
    event, _ = engine_path(device, lockstep_stats, block=False, census=srl003)
    paths["device"], block_stats = engine_path(device, lockstep_stats, block=True, census=srl003)
    paths["device SR_ENGINE_BLOCK=0"] = event
    quick_start(device)
    quick_start_device(device)
    paths["resume"] = resume_path(device)
    paths.update(engine_options(device, block_stats["main_loop_s"]))
    lanes, fleet_paths, multitarget = fleet_path(device)
    paths.update(fleet_paths)
    for rec in (b1, b2, b3):
        rec["lane_axis"] = lanes[rec["name"]]
    paths["stream"], stream_errs = stream_path(device)
    for rec in (b1, b2, b3):
        rec["max_abs_err"] = worst_err(rec["max_abs_err"], stream_errs[rec["name"]])
    paths["serve"], serve_b3_err = serve_path(device, multitarget)
    b3["max_abs_err"] = worst_err(b3["max_abs_err"], serve_b3_err)
    paths["net"] = net_path(device, multitarget[0], smi)
    b2v, feature_paths = features_path(device, lockstep_stats)
    paths.update(feature_paths)
    scale_paths, scale_errs = scale_out(device, block_stats, lockstep_stats)
    paths.update(scale_paths)
    for rec in (b1, b2, b3):
        rec["max_abs_err"] = worst_err(rec["max_abs_err"], scale_errs.get(rec["name"], 0.0))
    pod_paths, _ = pod_path(device)
    paths.update(pod_paths)
    mesh_paths, mesh_errs = mesh_path(device)
    paths.update(mesh_paths)
    for rec in (b1, b2):
        rec["max_abs_err"] = worst_err(rec["max_abs_err"], mesh_errs.get(rec["name"], 0.0))
    paths["drills"] = drills_path(device)
    paths["native"], paths["native lockstep"], native_err = native_path(device)
    b1["max_abs_err"] = worst_err(b1["max_abs_err"], native_err)
    for i, rec in enumerate((b1, b2, b3, b4, b2v)):
        rec["launches_by_path"] = {path: counts[i] for path, counts in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        # the worst error of the kernel's checks as a share of its tolerance
        rec["max_tol_ratio"] = getattr(rec["max_abs_err"], "ratio", 0.0)
        if rec["max_tol_ratio"] > 1:
            _fail(f"{rec['name']}: max_tol_ratio {rec['max_tol_ratio']} above 1")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "max_tol_ratio",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path",
             "lane_axis"]
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r}
                                  for r in (b1, b2, b3, b4, b2v)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            # the cards this run used
            "count": 1,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
