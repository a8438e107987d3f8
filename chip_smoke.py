"""Smoke run of goworld_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It

1. builds every CUDA kernel of the port from ``goworld_tpu_torch/ops/csrc``;
2. holds each kernel form against its plain PyTorch version on the card, at
   the headline cell grid and at a small lattice grid (bit-identical words),
   and times both;
3. drives the AOI neighbor engine's main path at the headline size of
   bench.py's accelerator branch (102,400 entities, 44x44 cells of 300,
   radius 100): the enter storm, 40 pipelined steady ticks, 200 synchronous
   ones and a slow tick (1% despawned, 1% teleported), with the kernel
   launch counts zeroed just before and read just after;
4. holds the storm, two steady ticks and the slow tick against the port's
   reference engine on the card, and a 1,024-entity sample's incremental
   interest sets against brute force;
5. repeats the kernel checks, the drive and the engine checks for a few
   ticks of the 32-space shape (bench.py ``multispace_32``: 32 space slots,
   32x32 cells of 400);
6. holds the boids kernel against its plain version at the cells of each
   grid of bench.py's supercell sweep, at a small dense grid across the
   torus seam and at hand-built cells that exercise its skips
   (``boids_skip_edge_cells``), then drives the boids step as
   ``bench_boids_tuned`` does (51,200 agents, radius 100, a 6,400-wide
   world: 15 steps at each cell size, the drop-free winner at 60), holds
   three of the winner's steps against the reference backend on the card
   and a 1,024-agent sample against the float64 oracle;
7. drives the strip+halo sharded engine at BASELINE.json's config 5
   (``strips_1m``: 1,048,576 entity slots, 917,504 active, 8 grid-column
   strips on the one card, 128x128 cells of 300, radius 100, the
   in-kernel drain on): the enter storm, a first steady tick, 20 pipelined
   and 10 synchronous steady ticks, a slow tick (1% despawned) and a
   teleport tick (the all-gather fallback), with the launch counts zeroed
   just before and read just after; holds every tick against the
   single-device engine on the card and a 1,024-entity sample against
   brute force; holds both drain forms against their plain version at one
   strip's slab and at a lattice slab whose events overflow the inline
   budget, and times them;
   then ``entity_1m``: the same world through the entity-sharded engine
   (8 shards on the card, the slab program: each shard launches the mask
   forms on its 16 grid rows), the storm, a first steady tick, 10
   pipelined and 5 synchronous steady ticks and a slow tick, each held
   against the single-device engine, a sample against brute force, 8
   launches of each mask form a tick; both mask forms held against their
   plain version at a shard's slab, and timed;
8. drives ``service_10k``: the port's runtime and batched AOI service at
   10,240 avatars (BASELINE.json config 2), fused logic off then on; then
   ``entity_service``: that world on an 8-shard entity-sharded service for
   10 ticks, its delivered interest sets equal to the single-device
   service's after every tick, and both mask forms held against their
   plain version at shard 0's slab of its last dispatch, and timed;
9. ``scenarios``: the scenario matrix (``hotspot``, ``battle_royale``,
   ``service_heavy``, each at its registered config) through
   ``run_scenario`` on the card, on the batched engine (the mask forms)
   and on the 8-strip engine with its strips on the card (the drain forms
   and, for ``hotspot``'s crowd, the all-gather fallback); every run's
   ``invariants`` bit for bit against the batched engine on the CPU, one
   step program a tick, and the event kernel's launches counted from 0
   around each run; both mask forms held and timed at ``hotspot``'s
   endgame cells; the port bench (``python -m goworld_tpu_torch.bench``)
   at cut steps;
10. ``cluster_ci``: the reference's CI deployment (.travis.yml, the
   3 dispatchers x 3 games x 3 gates of ``tests/test_stress.py``'s
   ``TRAVIS_INI``, compression and TLS on) started by the port's CLI
   (``python -m goworld_tpu_torch.cli start
   goworld_tpu_torch.examples.test_game``) with every game's batched AOI
   service on the card, 200 strict bots of the port's fleet for 30 s, a
   live ``reload`` (freeze -> restore), 200 strict bots for 30 s again and
   a stop; zero errors, every game's log naming the card and every game's
   ``/metrics`` counting AOI steps on the card and launches of both mask
   forms (the wrapper's own counts) in both runs. Before the cluster
   starts, both mask forms are held against their plain version and timed
   at the games' own cells (``params_from_config`` of the default
   ``[aoi]``: 16,384 slots, 32x32 cells of 100, 4 space slots, cell
   capacity 64, with 1,024 entities in 64 spaces). During the first run
   one game's ``/profile?mode=torch`` window must trace the card's
   kernels and the event kernel's launch (``gw_event_mask``); their summed
   device time over the window is the game's busy share. It also runs
   ``graft_entry.entry()`` once on the card against the reference step;
11. ``multihost``: processes of this script (``--multihost-worker``), 4
   shards each: one process on its card, whose gather takes the device
   route over NCCL; two processes pinned to one card, which take the host
   route (a Gloo gather of host rows); and, with two or more cards, two
   processes on two cards over NCCL. On both backends the union of each
   run's events equals the single-device engine's stream each tick, the
   two-card run's equal the host route's process by process, and each
   route's gather and step times are printed; both mask forms are held
   against their plain version at the slab global shard 0 launched them
   on in the host route's run (copied: 4 space slots), and timed;
   then ``multihost_1m``, with four cards: BASELINE config 5 (strips_1m's
   world) over 4 processes x 2 shards, one card each, the device route
   over NCCL, the slab kernel: every tick's union of events equal to the
   single-device engine's; tick, gather and step times, each card's peak
   memory, and both mask forms held and timed at the slab global shard 0
   launched them on;
12. ``multihost_cluster``: the two-game ``[aoi] multihost_coordinator``
   deployment of the JAX package's tests/test_multihost.py, started by the
   port's CLI, 10 strict bots across a reload, zero errors, each game
   joining the group twice; with two or more cards the games take a card
   each and the device route, on one card they share it and take the host
   route;
13. ``unity_demo``: the port's examples/unity_demo in one in-process game
   runtime on the batched AOI service on the card (16 spaces of 100
   players and 3 monsters, 1,648 entities, each space one crowd at the
   spawn point; the players on a walk seeded by ``--seed``, the monsters
   on their own AI and Tick timers; 300 AOI ticks), with the port's
   lock-order detector installed over the phase: every 30th tick's
   interest sets after a flush equal brute force, no entity dropped, a
   monster chased a player and landed a hit, both mask forms launched and
   held against their plain version at the run's last cells, and timed;
   the lock graph of the port's locks acyclic, with no blocking call
   under one and no deadlock, the service's prewarm and tier-warm threads
   live;
14. ``sync_check``: R1's ground truth. Which PyTorch calls the card's
   sync debug mode reports (``sync_calibration``), then every recorded
   sync of the dispatches of warmed engines (``SyncRecorder``: the mode's
   warnings and the Event and Stream waits it does not report): none in
   the single-device engine's ``step_async`` (a steady tick, a slow tick,
   a tick with ``logic=`` and ``tiers=``) and the service's ``_dispatch``
   at the default ``[aoi]``; none that the mode reports in the fused,
   tiered service dispatch; and every site seen, on those and on the
   8-strip and 8-shard engines at a cut ``strips_1m`` and the
   multi-process engine's device route over NCCL in one process at that
   cut, on one of the port's raw gwlint R1 findings;
15. ``bench_modes``: the port bench (``python -m goworld_tpu_torch.bench``)
   as a user runs it, a process a mode, steps cut (``BENCH_MODES_ENV``):
   the default run (``BENCH_MODE=all``: the headline, ``multispace_32``,
   ``synthetic_10k``, ``boids_50k``, ``phases``, the cell, events and drain
   sweeps, the self-tune) at full width, every config, sweep point and
   phase key present without an error, the kernel on the card, the boids
   winner drop-free; ``--sharded`` on each backend (parity with the
   single-device engine, no fallback, fewer halo bytes than the
   all-gather's), ``--fused`` (the fused hook never run) and
   ``--pinned-floor`` under ``--history-dir`` (the ring's final frame);
   the bench's headline printed beside the ``headline`` phase's;
16. ``bench_cluster_modes``: the bench's cluster modes, a process a mode,
   each at its fixed config: ``--fanout`` (80 bots, 1 gate) and
   ``--fanout-multi`` (104 bots, 2 gates) with records delivered and every
   hop of ``FANOUT_HOPS`` busy; ``--fanout-massive`` (1,008 bots in 4 fleet
   processes on 2 gates) with no bot error, the tiered bytes a client a
   second at least 3x below the full phase's, and the reconnect storm's
   census conserved; ``--trace-overhead`` at each sampling rate, its pinned
   floor on the card (the kernel backend, the card's name) under
   ``--history-dir``, whose final frame must count one launch of each mask
   form a step program; both mask forms held against their plain version
   and timed at the pinned floor's cells; ``--multigame`` with zero loss and
   no bot error, its dispatcher-restart phase too; ``--multigame-spaces``
   passing every kill cross. The games of every cluster mode run ``[aoi]
   backend = xzlist`` (the host pipeline), as bench.py's do.

Phases that need more cards than the machine has print a line saying they
did not run; on a machine with four cards (``chiprun --chips 4``) every
phase runs.

The kernels are built first, all at once. It prints bench.py's metrics, a
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is not 0. Without a CUDA device it exits with 1 and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, and
# FP32 outside the tensor cores, 67 TFLOP/s with an FMA counted as two
# operations. The kernel is built with --fmad=false and issues separate
# FP32 instructions of one operation each, so its peak is half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# FP32 operations per pair and epoch in the event kernel: 2 subtractions,
# 2 multiplications, 1 addition, 2 comparisons.
OPS_PER_PAIR_EPOCH = 7

# The two configurations of bench.py's accelerator branch, and the ticks.
HEADLINE = dict(capacity=102400, cell_size=300.0, grid_x=44, grid_z=44,
                space_slots=1, cell_capacity=128, max_events=131072)
MULTISPACE = dict(capacity=102400, cell_size=400.0, grid_x=32, grid_z=32,
                  space_slots=32, cell_capacity=128, max_events=131072)
PIPELINED_TICKS = 40
SYNC_TICKS = 200

# BASELINE.json's config 5 ("1M entities, 8 game processes sharded") on
# the strip tier: 8 grid-column strips, all on one card, at the headline's
# density, cell, radius and motion; 7/8 of the slots active (the slot slack
# of bench.py's SHARDED_FLOOR_CONFIG), max_events 131,072 a strip.
STRIPS = dict(capacity=1048576, cell_size=300.0, grid_x=128, grid_z=128,
              space_slots=1, cell_capacity=128, max_events=1048576)
STRIPS_ACTIVE = 917504
STRIPS_N = 8
STRIPS_PIPELINED = 20
STRIPS_SYNC = 10
# entity_1m: the same world through the entity-sharded tier
# (parallel/mesh.py ShardedNeighborEngine, the slab kernel): 8 shards on
# the one card, 16 grid rows a shard's slab; the storm, a first steady
# tick, 10 pipelined and 5 synchronous steady ticks, a slow tick (1%
# despawned).
ENTITY_N = 8
ENTITY_PIPELINED = 10
ENTITY_SYNC = 5
# BASELINE.json's config 2 ("examples/test_game synthetic: 10k random-walk
# entities, 1 Space, TPUAOIManager on 1 chip") through the port's entity
# runtime and batched AOI service: 10,240 columnar avatars drifting at
# N(0, 3) units a tick (bench.py bench_fused's drift program over Column
# attrs vx, vz) in one space, AOI distance 100 (examples/test_game), 14x14
# cells of 300 (the headline's density at a tenth of its entities), [sync]
# cadence tiers (1, 4, 16), fused delivery on; run with [aoi] fuse_logic
# off, then on, each 3 warm ticks, 60 pipelined ticks and a flush, on a
# fixed clock of one second a tick. 1% of the avatars log out (are
# destroyed) before pipelined tick 45: a slow tick. The space is an entity too, with a slab
# slot of its own: the slots are the avatars' count and 8 more.
SERVICE_ENTITIES = 10240
SERVICE = dict(capacity=SERVICE_ENTITIES + 8, cell_size=300.0, grid_x=14,
               grid_z=14, space_slots=1, cell_capacity=128,
               max_events=131072)
SERVICE_RADIUS = 100.0
SERVICE_TIERS = (1, 4, 16)
SERVICE_WARM = 3
SERVICE_TICKS = 60
SERVICE_DT = 1.0
SERVICE_LOGOUT_TICK = SERVICE_WARM + 45
# entity_service: service_10k's world and avatars with [aoi] mesh_shards = 8
# and shard_mode = entity (the entity-sharded engine, 8 shards on the card),
# unfused, 10 ticks, against the single-device service on the same ticks.
# The tier needs whole 8-row chunks a shard and one slab of grid rows a
# shard: 10,304 slots (the next multiple of 64) and 16x16 cells of 300 (a
# torus wider than service_10k's 4,200-unit world, which is kept, so no
# cell folds).
ENTITY_SERVICE = dict(SERVICE, capacity=10304, grid_x=16, grid_z=16)
ENTITY_SERVICE_SHARDS = 8
ENTITY_SERVICE_TICKS = 10
# multihost: OS processes of this script, 4 shards each, in one
# torch.distributed group on 127.0.0.1 (parallel/multihost.py): one process
# (the device route over NCCL), two on one card (the host route over Gloo)
# and, with two or more cards, two on two cards (NCCL), on the world of the
# JAX package's
# tests/test_parallel.py test_sharded_structural_at_scale: 65,536 slots,
# 64x64 cells of 100, 4 space slots, cell capacity 64, max_events 8,192
# (1,024 a shard, so the storm pages every shard), radius 80, 64 spaces,
# a half of the slots always active and the other half at 50%; the storm,
# then ticks of N(0, 3) drift.
MULTIHOST = dict(capacity=65536, cell_size=100.0, grid_x=64, grid_z=64,
                 space_slots=4, cell_capacity=64, max_events=8192)
MULTIHOST_PROCS = 2
MULTIHOST_LOCAL = 4
MULTIHOST_TICKS = 12
# multihost_1m: BASELINE.json's config 5 ("1M entities, 8 game processes
# sharded, all-gather positions over ICI") on four cards: strips_1m's
# world, 4 processes x 2 local shards (8 global shards, 16 grid rows a
# slab), the slab kernel, the device route over NCCL; the storm,
# MULTIHOST_1M_STEADY steady ticks (positions only uploaded) and a slow
# tick (1% despawned).
MULTIHOST_1M_PROCS = 4
MULTIHOST_1M_LOCAL = 2
MULTIHOST_1M_STEADY = 12
# Seconds a multihost phase's group join, or a collective, may wait.
MULTIHOST_TIMEOUT_S = 300.0
# multihost_cluster: the JAX package's tests/test_multihost.py
# MH_CLUSTER_INI (1 dispatcher, 2 games, 1 gate, [aoi]
# multihost_coordinator) started by the port's CLI with [aoi] platform =
# auto: each game's service on its rank's card, so on a one-card machine
# both share the card (the host route) and with two or more cards they
# take two (the device route); each game's debug HTTP on for /metrics. 10
# strict bots for 30 s, a reload at 15 s.
MH_CLUSTER_BOTS = 10
MH_CLUSTER_RUN_S = 30.0
MH_CLUSTER_RELOAD_S = 15.0
MH_CLUSTER_INI = """\
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = {disp}

[game_common]
boot_entity = Account
save_interval = 600

[game1]
http_addr = 127.0.0.1:{http1}

[game2]
http_addr = 127.0.0.1:{http2}

[gate1]
port = {gate}
heartbeat_timeout = 60

[storage]
type = filesystem
directory = {dir}/es

[kvdb]
type = sqlite
directory = {dir}/kv

[aoi]
backend = tpu
platform = auto
max_entities = 512
multihost_coordinator = 127.0.0.1:{coord}
"""
# The drain forms' small check: the lattice grid's slot/own plane, and an
# inline budget its events overflow.
# unity_demo: the port's examples/unity_demo in one in-process game runtime
# (a loopback kvreg, a sqlite kvdb) on the batched AOI service on the card:
# 16 spaces at SpaceService's cap of 100 players each
# (MAX_AVATAR_COUNT_PER_SPACE) plus MySpace's 3 monsters each, 1,648
# entities at AOI radius 100. Players enter at the spawn point Vector3()
# and monsters within +-10 of it, so each space starts as one crowd of 103
# mutually interested entities over the four cells at the origin (cell
# capacity 128 holds a whole crowd). Players then random-walk N(0, 1) a
# tick from a generator seeded by --seed; monsters run their own 100 ms AI
# and 30 ms Tick timers on the runtime's clock. 300 runtime ticks (each an
# AOI tick) at a 50 ms cadence, the interest sets checked after a flush
# every 30th; the service's [sync] tiers are service_10k's.
UNITY_SPACES = 16
UNITY_PLAYERS = 100
UNITY = dict(capacity=2048, cell_size=100.0, grid_x=16, grid_z=16,
             space_slots=32, cell_capacity=128, max_events=65536)
UNITY_TICKS = 300
UNITY_CHECK_EVERY = 30
UNITY_STEP = 1.0
UNITY_DT = 0.05
# sync_check: each dispatch recorded after SYNC_WARM unrecorded ticks of
# the same variant; the strip and entity-sharded engines at strips_1m cut
# to an eighth (its density, cell, radius and motion on 16 of its 128 grid
# rows: 131,072 slots, 114,688 active); the tier pass of the single-device
# engine over the storm's first SYNC_EDGES pairs.
SYNC_WARM = 3
SYNC_CHECK_TICKS = 3
SYNC_EDGES = 4096
SYNC_CUT = dict(STRIPS, capacity=131072, grid_z=16, max_events=131072)
SYNC_ACTIVE = 114688
LATTICE_CAPACITY = 8192
LATTICE_DRAIN = 500

# cluster_ci: the reference CI's deployment (.travis.yml:22-34 on
# goworld_travis.ini's shape, tests/test_stress.py TRAVIS_INI): 3
# dispatchers, 3 games, 3 gates, compression and TLS on, the batched AOI
# service on the card in every game ([aoi] backend = tpu, platform = auto,
# max_entities at its default), each game's debug HTTP on for /metrics and
# /opmon. Cut: 300 s -> 30 s a fleet run (TLS is cut too where the host
# has no openssl).
CLUSTER_SERVER = "goworld_tpu_torch.examples.test_game"
CLUSTER_BOTS = 200
CLUSTER_RUN_S = 30.0
CLUSTER_PLATFORM = "auto"
CLUSTER_INI = """\
[deployment]
dispatchers = 3
games = 3
gates = 3

[dispatcher_common]

[dispatcher1]
port = {disp1}

[dispatcher2]
port = {disp2}

[dispatcher3]
port = {disp3}

[game_common]
boot_entity = Account
save_interval = 600

[game1]
http_addr = 127.0.0.1:{http1}

[game2]
http_addr = 127.0.0.1:{http2}

[game3]
http_addr = 127.0.0.1:{http3}

[gate_common]
heartbeat_timeout = 60
compress_connection = true
{tls}
[gate1]
port = {gate1}

[gate2]
port = {gate2}

[gate3]
port = {gate3}

[storage]
type = filesystem
directory = {dir}/es

[kvdb]
type = sqlite
directory = {dir}/kv

[aoi]
backend = tpu
platform = {platform}
"""
# The event kernel at the games' own cells: the engine params the games
# take from [aoi] at its defaults (params_from_config: 16,384 slots, 32x32
# cells of 100, 4 space slots, cell capacity 64), holding more entities
# than the busiest game did in this phase's runs (980 at its peak, PR 7),
# in 64 spaces, at test_game's positions (integers in [-400, 400]) and AOI
# distance (100), a walk of up to 20 units a tick between the epochs.
CLUSTER_AOI_ENTITIES = 1024
CLUSTER_AOI_SPACES = 64
CLUSTER_AOI_HALF = 400
CLUSTER_AOI_STEP = 20.0
CLUSTER_TLS = """encrypt_connection = true
rsa_key = {dir}/rsa.key
rsa_cert = {dir}/rsa.crt
"""

# The scenario matrix (goworld_tpu_torch/scenarios), each at its registered
# config: the registry fixes the sizes and they are never tuned here.
SCENARIOS = ("hotspot", "battle_royale", "service_heavy")
# The port bench's headline (python -m goworld_tpu_torch.bench, BENCH_MODE
# aoi) at cut steps: its pipelined and synchronous ticks.
BENCH_ENV = {"BENCH_MODE": "aoi", "BENCH_STEPS": "20", "BENCH_SYNC_STEPS": "10"}
# bench_modes: the bench's device modes at full width, the default run's
# pipelined and synchronous ticks cut (bench.py: 45 and 15); the sweeps'
# ticks and the boids steps are bench.py's.
BENCH_MODES_ENV = {"BENCH_STEPS": "30", "BENCH_SYNC_STEPS": "10"}
# The default run's configs (its sweep points are the bench's CELL_SWEEP,
# EVENTS_SWEEP and DRAIN_SWEEP) and its phase keys.
BENCH_CONFIGS = ("multispace_32", "unity_200", "synthetic_10k", "boids_50k",
                 "cell_sweep", "events_sweep", "drain_sweep", "pod_1m")
BENCH_PHASES = ("table_ms", "feats_ms", "kernel_ms", "gather_ms",
                "events_in_mask", "drain_ms", "drain_bsearch_ms",
                "drain_grouped_ms", "drain_scatter_ms", "full_step_ms",
                "est_tick_ms")
BENCH_MODES_TIMEOUT_S = 900
# bench_cluster_modes: each cluster mode's process is killed past this.
CLUSTER_MODES_TIMEOUT_S = 420
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "backend", "device",
                "entities", "ticks_per_sec", "events_per_tick",
                "paged_ticks", "collect_p50_ms", "collect_p99_ms",
                "diff_latency_p50_ms", "diff_latency_p99_ms",
                "post_step_drain_p50_ms", "post_step_drain_p99_ms")
# The torch profiler window asked of one game in cluster_ci's first run.
PROFILE_S = 2.0

# Each kernel's source, and the TPU kernel it replaces.
KERNELS = {
    "event_kernel": ("goworld_tpu_torch/ops/csrc/event_kernel.cu",
                     "goworld_tpu/ops/neighbor.py:496"),
    "event_drain": ("goworld_tpu_torch/ops/csrc/event_kernel.cu",
                    "goworld_tpu/ops/neighbor.py:744"),
    "boids_kernel": ("goworld_tpu_torch/ops/csrc/boids_kernel.cu",
                     "goworld_tpu/ops/boids.py:140"),
}
SAMPLE = 1024

# bench.py's boids_50k (bench_boids / bench_boids_tuned): the agents, the
# interaction radius, the world's side, the supercell sweep and the steps.
BOIDS_N = 51200
BOIDS_RADIUS = 100.0
BOIDS_WORLD = 6400.0
BOIDS_CELL_SWEEP = (100.0, 160.0, 200.0, 320.0)
BOIDS_SWEEP_STEPS = 15
BOIDS_STEPS = 60
# Tolerances: the kernel and its plain version sum in another order, and the
# accelerations are clamped to |a| <= 2; positions up to 6,400 have an f32
# spacing of 4.9e-4; the oracle's is tests/test_boids.py's.
BOIDS_ATOL = 1e-4
BOIDS_POS_ATOL = 1e-3
BOIDS_ORACLE_TOL = 2e-3
# FP32 operations the boids kernel's function needs. Per pair of an occupied
# query and another occupied candidate: 2 subtractions, 2 multiplications
# and an addition for d2, and its comparison with r2; and per axis on which
# the pair lies more than half the world apart, the minimal image's
# division (counted as one), rint, multiplication and subtraction. Per pair
# in range: 5 additions (the count and four sums) and the comparison with
# sep_r2. Per close pair: 3 additions, a division and 2 multiplications.
# Per occupied query, after the loop: 33. (An earlier count charged the
# image to every pair, 14 operations a pair; PERF.md gives both bounds.)
OPS_PER_PAIR = 6
OPS_PER_IMAGE = 4
OPS_PER_NEIGHBOR = 6
OPS_PER_CLOSE = 6
OPS_PER_QUERY = 33
# Feature rows of a cell in boids_five_row_bytes (x, z, vx, vz, valid).
BOIDS_ROWS_READ = 5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 30) -> float:
    """Median device time of one call of ``fn()`` over ``reps`` calls, by
    CUDA events. Each call queues behind a ~1 ms device sleep, so the host
    has issued it before the device reaches it and the host's launch
    overhead stays out of the time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def pct(values_s, q) -> float:
    return float(np.percentile(np.asarray(values_s) * 1000.0, q))


def pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    return np.sort(pairs[:, 0].astype(np.int64) * n + pairs[:, 1])


def check_pairs(pairs: np.ndarray, n: int, what: str) -> None:
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.dtype != np.int32:
        raise AssertionError(f"{what}: malformed pairs {pairs.shape}")
    if len(pairs) and (pairs.min() < 0 or pairs.max() >= n):
        raise AssertionError(f"{what}: slot out of range")
    if len(pairs) and (pairs[:, 0] == pairs[:, 1]).any():
        raise AssertionError(f"{what}: self pair")


def lattice_cells(slots, rows, cols, seed):
    """Event-kernel input f32[slots, rows+2, cols+2, 8, 128] on an integer
    lattice, so pairs at exactly d == r (3-4-5 and 5-12-13 triples) are
    common and `<=` is told from `<`. It holds empty lanes, an empty and a
    full cell, lanes present in one epoch only, moves and radius changes
    between the epochs, three space ids, and a wrapped halo ring."""
    rng = np.random.default_rng(seed)
    shape = (slots, rows, cols, 128)
    occupied = rng.random(shape) < rng.uniform(0.2, 1.0, shape[:3])[..., None]
    occupied[0, 0, 0] = False
    occupied[-1, -1, -1] = True
    xz = rng.integers(0, 30, shape + (2,)).astype(np.float32)
    move = rng.integers(-4, 5, shape + (2,)).astype(np.float32)
    spc = rng.integers(0, 3, shape).astype(np.float32)
    rad = rng.choice(np.array([5, 10, 13, 25], np.float32), shape)
    feats = [xz[..., 0], xz[..., 1], spc, rad,
             xz[..., 0] + move[..., 0], xz[..., 1] + move[..., 1],
             np.where(rng.random(shape) < 0.1, (spc + 1) % 3, spc),
             np.where(rng.random(shape) < 0.2, rad + 5, rad)]
    cells = np.full(shape[:3] + (8, 128), np.nan, np.float32)
    for f, v in enumerate(feats):
        cells[..., f, :] = np.where(occupied, v, np.nan)
    absent_b = rng.random(shape) < 0.1  # no epoch-B position
    cells[..., 4, :] = np.where(absent_b, np.nan, cells[..., 4, :])
    zi = np.arange(-1, rows + 1) % rows
    xi = np.arange(-1, cols + 1) % cols
    return np.ascontiguousarray(cells[:, zi][:, :, xi])


def lattice_plane(cells, seed, capacity=LATTICE_CAPACITY,
                  either_epoch=False):
    """The drain forms' slot/own plane for ``lattice_cells``: a distinct
    slot id in every lane occupied in epoch A (in epoch A or B with
    ``either_epoch``; ``capacity`` elsewhere), 4 in 5 of them own, wrapped
    like the cells' halo ring."""
    rng = np.random.default_rng(seed)
    core = cells[:, 1:-1, 1:-1]
    slots_, rows, cols = core.shape[:3]
    occupied = ~np.isnan(core[..., 0, :])
    if either_epoch:
        occupied |= ~np.isnan(core[..., 4, :])
    ids = rng.permutation(capacity)[:occupied.size].reshape(occupied.shape)
    slot = np.where(occupied, ids, capacity)
    own = occupied & (rng.random(occupied.shape) < 0.8)
    plane = np.stack([slot, own], axis=-2).astype(np.int32)
    zi = np.arange(-1, rows + 1) % rows
    xi = np.arange(-1, cols + 1) % cols
    return np.ascontiguousarray(plane[:, zi][:, :, xi])


# The kinds of cell of ``skip_edge_cells``.
SKIP_EDGE_KINDS = ("random", "prefix", "empty", "full", "lane_31", "lane_127")


def skip_edge_cells(slots, rows, cols, seed):
    """Event-kernel input f32[slots, rows+2, cols+2, 8, 128] laid out to
    test a kernel that skips empty query lanes and empty 32-lane candidate
    chunks, on the integer lattice of ``lattice_cells``. Each cell is one
    of SKIP_EDGE_KINDS, in a seeded order: lanes occupied at random (not
    from lane 0 up); a prefix at the engine's density (40-64 lanes, the
    headline's ~53 a cell); empty; full; lane 31 the only occupied lane of
    lanes 0-31 (the others at random); lane 127 the only occupied lane (the
    query is then the only candidate of its chunk). Outside the prefix
    cells, 1 in 8 occupied lanes is present in epoch B only (NaN x in epoch
    A) and 1 in 8 in epoch A only. Slot 0 holds one space id, the other
    slots three (a kernel may leave out the space test where no pair can
    fail it). The halo ring wraps."""
    rng = np.random.default_rng(seed)
    shape = (slots, rows, cols, 128)
    n_kinds = len(SKIP_EDGE_KINDS)
    kind = rng.permutation(np.arange(slots * rows * cols) % n_kinds)
    kind = kind.reshape(shape[:3])[..., None]
    lane = np.arange(128)
    random = rng.random(shape) < rng.uniform(0.05, 0.9, shape[:3])[..., None]
    prefix = lane < rng.integers(40, 65, shape[:3])[..., None]
    occupied = np.select(
        [kind == k for k in range(n_kinds)],
        [random, prefix, np.zeros(shape, bool), np.ones(shape, bool),
         np.where(lane < 32, lane == 31, random),
         np.broadcast_to(lane == 127, shape)])
    xz = rng.integers(0, 30, shape + (2,)).astype(np.float32)
    move = rng.integers(-4, 5, shape + (2,)).astype(np.float32)
    n_spaces = np.where(np.arange(slots) == 0, 1, 3)[:, None, None, None]
    spc = (rng.integers(0, 3, shape) % n_spaces).astype(np.float32)
    rad = rng.choice(np.array([5, 10, 13, 25], np.float32), shape)
    feats = [xz[..., 0], xz[..., 1], spc, rad,
             xz[..., 0] + move[..., 0], xz[..., 1] + move[..., 1],
             np.where(rng.random(shape) < 0.1, (spc + 1) % n_spaces, spc),
             np.where(rng.random(shape) < 0.2, rad + 5, rad)]
    cells = np.full(shape[:3] + (8, 128), np.nan, np.float32)
    for f, v in enumerate(feats):
        cells[..., f, :] = np.where(occupied, v, np.nan)
    one_epoch = rng.random(shape)
    mixed = kind != SKIP_EDGE_KINDS.index("prefix")
    cells[..., 0, :][mixed & (one_epoch < 0.125)] = np.nan  # B only
    cells[..., 4, :][mixed & (one_epoch >= 0.875)] = np.nan  # A only
    zi = np.arange(-1, rows + 1) % rows
    xi = np.arange(-1, cols + 1) % cols
    return np.ascontiguousarray(cells[:, zi][:, :, xi])


def steady_cells(tn, p, pos, ppos, space, device, active=None):
    """The current grid's cells of a steady tick, built by the engine's own
    binning, table and scatter (as _step_pallas builds them); ``active``
    defaults to every slot."""
    n = p.capacity
    pos_t = torch.tensor(pos, device=device)
    ppos_t = torch.tensor(ppos, device=device)
    space = torch.tensor(space, device=device)
    radius = torch.full((n,), 100.0, device=device)
    active = (torch.ones(n, dtype=torch.bool, device=device) if active is None
              else torch.tensor(active, device=device))
    cx, cz, sm = tn._bins(p, pos_t, space)
    bucket = (sm * p.grid_z + cz) * p.grid_x + cx
    _, slot, _, order, dst = tn._build_table(p, bucket, active, tn.LANES)
    feats_a = (pos_t[:, 0], pos_t[:, 1], space, radius)
    feats_b = (ppos_t[:, 0], ppos_t[:, 1], space, radius)
    return tn._scatter_feats(p, dst, order, feats_a, feats_b)


def event_ops(ek, cells) -> int:
    """FP32 operations the event kernel's words need on these cells: in
    each epoch E, every query lane with x_E set against every candidate of
    its 3x3 block with x_E set, 7 operations a pair. A pair with x_E NaN on
    either side is invalid in epoch E whatever else it holds, so it needs
    no operation."""
    rows, cols = cells.shape[1] - 2, cells.shape[2] - 2
    pairs = 0
    for fx in (ek._FX_A, ek._FX_B):
        have = (~torch.isnan(cells[..., fx, :])).sum(-1, dtype=torch.int64)
        block = sum(have[:, di:di + rows, dj:dj + cols]
                    for di in range(3) for dj in range(3))
        pairs += int((have[:, 1:-1, 1:-1] * block).sum())
    return pairs * OPS_PER_PAIR_EPOCH


def event_bound(ek, ops, *tensors):
    """The least time for an event kernel form: each of ``tensors`` (its
    inputs and outputs) moved once over the memory rate, against ``ops``
    FP32 operations over the peak rate. Returns the row's bound keys."""
    bytes_moved = sum(x.numel() * x.element_size() for x in tensors)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bytes": bytes_moved, "fp32_ops": ops,
    }


def hold_kernel(ek, cells, dual, skip=None) -> int:
    """One form's words against its plain version on the same cells; the
    largest difference of a word, which must be 0. ``skip`` is passed to
    the kernel only (a false one, as a slow tick's leave launch gets)."""
    got = ek.event_mask(cells, dual, skip=skip)
    want = ek.event_mask_reference(cells, dual)
    err = int((got - want).abs().max())  # words are 0..65535
    if err:
        raise AssertionError(f"{ek.FORMS[int(dual)]}: kernel words differ "
                             f"from the plain version at "
                             f"{tuple(cells.shape)}")
    return err


def kernel_checks(tn, ek, p, pos, ppos, space, device, active=None):
    """``cell_checks`` at the given tick's cells."""
    return cell_checks(ek, steady_cells(tn, p, pos, ppos, space, device,
                                        active), device)


def cell_checks(ek, head, device):
    """Each form against its plain version, at the cells ``head``, a small
    lattice grid and a skip-edge grid, the single form also with a false
    skip flag; times at ``head``, and the single form's launch with a true
    skip flag."""
    small = [torch.tensor(lattice_cells(2, 6, 5, seed=1), device=device),
             torch.tensor(skip_edge_cells(2, 6, 5, seed=5), device=device)]
    ops = event_ops(ek, head)
    skip = torch.ones((), dtype=torch.bool, device=device)
    rows = []
    for dual in (False, True):
        name = ek.FORMS[int(dual)]
        err = max(hold_kernel(ek, cells, dual) for cells in (*small, head))
        if not dual:
            err = max(err, hold_kernel(ek, head, dual, skip=~skip))
        out = ek.event_mask(head, dual)
        ms = cuda_ms(lambda: ek.event_mask(head, dual))
        plain_ms = cuda_ms(lambda: ek.event_mask_reference(head, dual), 3)
        row = {
            "name": name, "form": "dual" if dual else "single",
            "route": "cuda", "source": KERNELS["event_kernel"][0],
            "replaces": KERNELS["event_kernel"][1],
            "launches": None, "bit_identical": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            **event_bound(ek, ops, head, out),
            "library_ms": None,
        }
        if not dual:  # what a fast tick pays for the skipped launch
            row["skipped_ms"] = cuda_ms(
                lambda: ek.event_mask(head, False, skip=skip))
        rows.append(row)
        print(f"kernel {name}: bit-identical at the lattice and skip-edge "
              f"grids {tuple(small[0].shape)} and {tuple(head.shape)}; "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del small
    torch.cuda.empty_cache()
    return rows


class SampleSets:
    """Incremental interest sets of a sample of query slots, from the event
    stream, held against brute force on the card."""

    def __init__(self, n, seed):
        self.n = n
        self.slots = np.sort(
            np.random.default_rng(seed).choice(n, SAMPLE, replace=False))
        self.row = np.full(n, -1, np.int64)
        self.row[self.slots] = np.arange(SAMPLE)
        self.sets = np.zeros((SAMPLE, n), bool)

    def apply(self, enters, leaves):
        for pairs, value in ((leaves, False), (enters, True)):
            r = self.row[pairs[:, 0]]
            hit = r >= 0
            self.sets[r[hit], pairs[hit, 1]] = value

    def check(self, pos, active, space, radius, device, what):
        p = torch.tensor(pos, device=device)
        a = torch.tensor(active, device=device)
        s = torch.tensor(space, device=device)
        r = torch.tensor(radius, device=device)
        for k in range(0, SAMPLE, 128):  # 128 queries at a time
            q = torch.tensor(self.slots[k:k + 128], device=device)
            dx = p[None, :, 0] - p[q, 0][:, None]
            dz = p[None, :, 1] - p[q, 1][:, None]
            d2 = dx * dx + dz * dz
            want = (a[q][:, None] & a[None, :]
                    & (s[q][:, None] == s[None, :])
                    & (d2 <= (r[q] * r[q])[:, None]))
            want[torch.arange(len(q), device=device), q] = False
            if not np.array_equal(self.sets[k:k + 128], want.cpu().numpy()):
                raise AssertionError(f"{what}: sample interest sets differ "
                                     f"from brute force")


def hold_against_reference(tn, p, device, compared, what):
    """Each compared tick again through the reference engine on the card,
    from the same previous epoch: the same pair sets and drop count."""
    ref = tn.NeighborEngine(p, backend="reference", device=device)
    for label, prev, cur, got in compared:
        if prev is None:
            ref.reset()
        else:
            ref.load_state(prev)
        want = ref.step(*cur)
        for k, side in ((0, "enters"), (1, "leaves")):
            if not np.array_equal(pair_keys(want[k], p.capacity),
                                  pair_keys(got[k], p.capacity)):
                raise AssertionError(f"{what} {label}: {side} differ from "
                                     f"the reference engine")
        if want[2] != got[2]:
            raise AssertionError(f"{what} {label}: dropped differs")
        print(f"{what} {label}: {len(got[0])} enters, {len(got[1])} leaves,"
              f" dropped {got[2]}: equal to the reference engine",
              flush=True)


def walk(pos, vel, world):
    """One tick of the walk, in place. Entities reflect off the world's
    edges: bench.py clips them there, which over a few hundred ticks piles
    them up on the edge cells past a cell's capacity."""
    pos += vel
    under = pos < 0
    over = pos > world
    pos[under] = -pos[under]
    pos[over] = 2 * world - pos[over]
    vel[under | over] *= -1


def slow_tick_inputs(rng, pos, active, world):
    """1% despawned, 1% teleported across the map."""
    n = len(pos)
    pos = pos.copy()
    active = active.copy()
    active[rng.choice(n, n // 100, replace=False)] = False
    hop = rng.choice(n, n // 100, replace=False)
    pos[hop] = rng.uniform(0, world, (len(hop), 2)).astype(np.float32)
    return pos, active


def drive_headline(tn, ek, device):
    """bench.py's accelerator headline loop through the port's engine."""
    p = tn.NeighborParams(**HEADLINE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    kernels = kernel_checks(tn, ek, p, pos + vel, pos, space, device)

    eng = tn.NeighborEngine(p)
    if eng.backend != "kernel" or eng.device != device:
        raise AssertionError("the default engine is not the CUDA kernel path")
    eng.reset()
    sample = SampleSets(n, seed=1)
    compared = []
    fasts = []
    torch.cuda.synchronize()
    ek.reset_launch_counts()

    # The enter storm (paged).
    t0 = time.perf_counter()
    pend = eng.step_async(pos, active, space, radius)
    storm = pend.collect()
    storm_ms = (time.perf_counter() - t0) * 1e3
    fasts.append(pend.fast)
    compared.append(("storm", None, (pos.copy(), active, space, radius),
                     storm))

    def consume(out, label):
        check_pairs(out[0], n, f"{label} enters")
        check_pairs(out[1], n, f"{label} leaves")
        if out[2]:
            raise AssertionError(f"{label}: {out[2]} entities dropped")
        sample.apply(out[0], out[1])

    consume(storm, "storm")

    # Pipelined steady ticks: dispatch t+1, then collect t. The timed
    # window holds only what a game does (move, step_async, collect); the
    # checks run over the kept outputs after it.
    steps = PIPELINED_TICKS
    k_cmp = steps // 2  # a steady tick compared with the reference engine
    outs = []
    dispatch_s, collect_s = [], []
    pending = None
    t_all0 = time.perf_counter()
    for k in range(1, steps + 2):
        nxt = None
        if k <= steps:
            prev = pos.copy() if k == k_cmp else None
            walk(pos, vel, world)
            t0 = time.perf_counter()
            nxt = eng.step_async(pos, active, space, radius, meta_dirty=False)
            dispatch_s.append(time.perf_counter() - t0)
            fasts.append(nxt.fast)
            if k == k_cmp:
                cmp_epochs = ((prev, active, space, radius),
                              (pos.copy(), active, space, radius))
        if pending is not None:
            t0 = time.perf_counter()
            outs.append(pending.collect())
            collect_s.append(time.perf_counter() - t0)
        pending = nxt
    t_all = time.perf_counter() - t_all0
    events = paged = 0
    for k, out in enumerate(outs, 1):
        events += len(out[0]) + len(out[1])
        paged += len(out[0]) > p.max_events or len(out[1]) > p.max_events
        consume(out, f"tick {k}")
    compared.append((f"steady tick {k_cmp}", *cmp_epochs, outs[k_cmp - 1]))
    del outs

    # Synchronous steady ticks: post-step drain latency.
    drain_s = []
    for j in range(SYNC_TICKS):
        prev = pos.copy()
        walk(pos, vel, world)
        pend = eng.step_async(pos, active, space, radius, meta_dirty=False)
        fasts.append(pend.fast)
        pend.wait_device()
        t0 = time.perf_counter()
        out = pend.collect()
        drain_s.append(time.perf_counter() - t0)
        consume(out, f"sync tick {j}")
        if j == SYNC_TICKS // 2:
            compared.append(("sync steady tick",
                             (prev, active, space, radius),
                             (pos.copy(), active, space, radius), out))

    # The slow tick.
    prev = (pos.copy(), active, space, radius)
    pos, active = slow_tick_inputs(rng, pos, active, world)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = eng.step_async(pos, active, space, radius)
    out = pend.collect()
    slow_ms = (time.perf_counter() - t0) * 1e3
    fasts.append(pend.fast)
    consume(out, "slow tick")
    compared.append(("slow tick", prev, (pos, active, space, radius), out))
    torch.cuda.synchronize()
    launches = dict(ek.launches)

    fast = [bool(f) for f in fasts]
    if fast[-1] or not all(fast[:-1]):
        raise AssertionError(f"unexpected fast/slow ticks: {fast}")
    if launches[ek.FORMS[1]] != len(fast) or launches[ek.FORMS[0]] != len(fast):
        raise AssertionError(f"launch counts {launches} for {len(fast)} ticks")
    sample.check(pos, active, space, radius, device, "headline")
    hold_against_reference(tn, p, device, compared, "headline")

    for row in kernels:
        row["launches"] = launches[row["name"]]
    metrics = {
        "config": HEADLINE,
        "aoi_entity_updates_per_sec": steps / t_all * n,
        "ticks_per_sec": steps / t_all,
        "events_per_tick": events / steps,
        "paged_ticks": int(paged),
        "storm_events": len(storm[0]),
        "storm_ms": storm_ms,
        "dispatch_p50_ms": pct(dispatch_s, 50),
        "dispatch_p99_ms": pct(dispatch_s, 99),
        "collect_p50_ms": pct(collect_s, 50),
        "collect_p99_ms": pct(collect_s, 99),
        "post_step_drain_p50_ms": pct(drain_s, 50),
        "post_step_drain_p99_ms": pct(drain_s, 99),
        "post_step_drain_samples": len(drain_s),
        "slow_tick_ms": slow_ms,
        "ticks": len(fast),
        "slow_ticks": fast.count(False),
        "launches": launches,
        "single_form_ticks_with_work": fast.count(False),
    }
    return metrics, kernels


def drive_multispace(tn, ek, device):
    """bench.py's multispace_32 accelerator shape, a few ticks."""
    p = tn.NeighborParams(**MULTISPACE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = (np.arange(n) % p.space_slots).astype(np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    # Both forms against their plain version at this path's cells.
    cells = steady_cells(tn, p, pos + vel, pos, space, device)
    ops = event_ops(ek, cells)
    kernel_err, kernel_ms, kernel_bound = {}, {}, {}
    for dual in (False, True):
        name = ek.FORMS[int(dual)]
        kernel_err[name] = hold_kernel(ek, cells, dual)
        kernel_ms[name] = cuda_ms(lambda: ek.event_mask(cells, dual), 5)
        kernel_bound[name] = event_bound(ek, ops, cells,
                                         ek.event_mask(cells, dual))
        print(f"kernel {name}: bit-identical at {tuple(cells.shape)}; "
              f"{kernel_ms[name]:.4f} ms, bound "
              f"{kernel_bound[name]['bound_ms']:.4f} ms "
              f"({kernel_bound[name]['bound_by']})", flush=True)
    del cells
    torch.cuda.empty_cache()

    eng = tn.NeighborEngine(p)
    eng.reset()
    sample = SampleSets(n, seed=2)
    compared, fasts = [], []
    torch.cuda.synchronize()
    ek.reset_launch_counts()
    prev = None
    tick_s = []
    for k in range(5):
        if k == 4:
            pos, active = slow_tick_inputs(rng, pos, active, world)
        elif k:
            pos = np.clip(pos + vel, 0.0, world).astype(np.float32)
        t0 = time.perf_counter()
        pend = eng.step_async(pos, active, space, radius,
                              meta_dirty=k in (0, 4))
        out = pend.collect()
        tick_s.append(time.perf_counter() - t0)
        fasts.append(pend.fast)
        for which, pairs in (("enters", out[0]), ("leaves", out[1])):
            check_pairs(pairs, n, f"multispace tick {k} {which}")
        if out[2]:
            raise AssertionError(f"multispace tick {k}: dropped {out[2]}")
        sample.apply(out[0], out[1])
        cur = (pos.copy(), active.copy(), space, radius)
        compared.append((f"tick {k}", prev, cur, out))
        prev = cur
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    fast = [bool(f) for f in fasts]
    if fast[-1] or min(launches[f] for f in ek.FORMS) != len(fast):
        raise AssertionError(f"multispace: fast {fast}, launches {launches}")
    sample.check(pos, active, space, radius, device, "multispace")
    hold_against_reference(tn, p, device, compared, "multispace")
    return {
        "config": MULTISPACE,
        "tick_ms": [s * 1e3 for s in tick_s],
        "events": [len(c[3][0]) + len(c[3][1]) for c in compared],
        "fast": fast,
        "launches": launches,
        "kernel_max_abs_err": kernel_err,
        "kernel_ms": kernel_ms,
        "kernel_bound": kernel_bound,
    }


def own_events(tn, words, plane, region):
    """Events of own query lanes in one region of drain-form words."""
    w = words[..., region * 72:(region + 1) * 72]
    own = plane[:, 1:-1, 1:-1, 1] > 0
    return int(tn._popcount16(w).sum(-1)[own].sum())


def drain_kernel_checks(tn, ek, slab, capacity, drain, device):
    """Each drain form against its plain version on the same inputs, at
    one strip's slab of the first steady tick (inline budget ``drain``), at
    a small lattice slab whose events overflow LATTICE_DRAIN, and at a
    skip-edge slab with and without overflow: words bit-identical, pairs
    identical in [0, cap); times and bounds at the strip slab."""
    def small(make, seed, either_epoch):
        cells = make(2, 6, 5, seed=seed)
        plane = lattice_plane(cells, seed=2, either_epoch=either_epoch)
        return (torch.tensor(cells, device=device),
                torch.tensor(plane, device=device))

    lattice = small(lattice_cells, 1, False)
    edges = small(skip_edge_cells, 5, True)
    cases = ((lattice, LATTICE_DRAIN, LATTICE_CAPACITY, True),
             (edges, LATTICE_DRAIN, LATTICE_CAPACITY, True),
             (edges, 1 << 20, LATTICE_CAPACITY, False),
             (slab, drain, capacity, False))
    ops = event_ops(ek, slab[0])
    rows = []
    for dual in (False, True):
        name = ek.DRAIN_FORMS[int(dual)]
        for (cells, plane), d, cap, overflows in cases:
            words, pairs = ek.event_drain(cells, plane, dual, d, cap)
            want_w, want_p = ek.event_drain_reference(cells, plane, dual, d,
                                                      cap)
            cols = d * (2 if dual else 1)
            err = max(int((words - want_w).abs().max()),
                      int((pairs[:, :cols] - want_p[:, :cols]).abs().max()))
            if err:
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version at {tuple(cells.shape)}, "
                                     f"budget {d}")
            for r in range(2 if dual else 1):
                if (own_events(tn, want_w, plane, r) > d) != overflows:
                    raise AssertionError(f"{name}: region {r} at "
                                         f"{tuple(cells.shape)} should "
                                         f"{'' if overflows else 'not '}"
                                         f"overflow {d}")
        cells, plane = slab
        words, pairs = ek.event_drain(cells, plane, dual, drain, capacity)
        ms = cuda_ms(lambda: ek.event_drain(cells, plane, dual, drain,
                                            capacity))
        plain_ms = cuda_ms(lambda: ek.event_drain_reference(
            cells, plane, dual, drain, capacity), 3)
        source, replaces = KERNELS["event_drain"]
        row = {
            "name": name, "form": "dual" if dual else "single",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "bit_identical": True, "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms,
            **event_bound(ek, ops, cells, plane, words, pairs),
            "library_ms": None,
            "events": [own_events(tn, words, plane, r)
                       for r in range(2 if dual else 1)],
        }
        if not dual:  # what a fast tick pays for the skipped launch
            skip = torch.ones((), dtype=torch.bool, device=device)
            row["skipped_ms"] = cuda_ms(lambda: ek.event_drain(
                cells, plane, False, drain, capacity, skip=skip))
        rows.append(row)
        print(f"kernel {name}: bit-identical at the lattice and skip-edge "
              f"slabs {tuple(lattice[0].shape)} (overflowing "
              f"{LATTICE_DRAIN}) and {tuple(cells.shape)}; {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
    return rows


def drive_strips(tn, ek, ts, make_mesh, device):
    """BASELINE config 5 through the strip tier's engine, 8 strips on one
    card: the enter storm, a first steady tick (synchronous; strip 0's slab
    kept for the kernel checks), STRIPS_PIPELINED pipelined steady ticks,
    STRIPS_SYNC synchronous ones, a slow tick (1% despawned) and a teleport
    tick (1% teleported across the map), with the launch counts zeroed
    just before and read just after. Then every tick again through the
    single-device engine on the card, a sample against brute force, and
    the drain forms against their plain version."""
    p = tn.NeighborParams(**STRIPS)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.arange(n) < STRIPS_ACTIVE
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    mesh = make_mesh(STRIPS_N, device)
    families0 = strip_families()
    eng = ts.SpatialShardedNeighborEngine(p, mesh)
    if eng.backend != "kernel" or eng.drain_inline != eng.events_inline:
        raise AssertionError("the default strip engine is not the kernel "
                             "path with the in-kernel drain")
    eng.reset()
    ticks = []  # (label, world, out, mode, fast)
    paged = []  # (full_repage, shard sides paged) of each tick
    bands = []  # each strip tick's occupied band rows [strips, 2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ek.reset_launch_counts()

    def world_now():
        return (pos.copy(), active.copy(), space, radius)

    def note_bands():
        if eng.last_mode == "spatial":
            bands.append(eng._last_band_counts.copy())

    def step(label, meta_dirty=True):
        w = world_now()
        pend = eng.step_async(*w, meta_dirty=meta_dirty)
        note_bands()
        mode = eng.last_mode
        out = pend.collect()
        ticks.append((label, w, out, mode, eng.last_fast_tick))
        paged.append((pend.full_repage, pend.paged))
        return out

    t0 = time.perf_counter()
    storm = step("storm")
    storm_ms = (time.perf_counter() - t0) * 1e3

    # The first steady tick, with strip 0's current slab kept.
    kept = {}
    drain_form = ts.event_drain

    def keep_slab(cells, plane, dual, *args, **kw):
        if dual and not kept:
            kept["slab"] = (cells, plane)
        return drain_form(cells, plane, dual, *args, **kw)

    walk(pos, vel, world)
    ts.event_drain = keep_slab
    try:
        step("tick 1", meta_dirty=False)
    finally:
        ts.event_drain = drain_form

    # Pipelined steady ticks: dispatch t+1, then collect t. The window
    # holds only what a game does; the checks run afterwards.
    dispatch_s, collect_s = [], []
    pending = None  # (label, world, mode at dispatch, pending step)
    t_all0 = time.perf_counter()
    for k in range(STRIPS_PIPELINED + 1):
        nxt = None
        if k < STRIPS_PIPELINED:
            walk(pos, vel, world)
            w = world_now()
            t0 = time.perf_counter()
            pend = eng.step_async(*w, meta_dirty=False)
            dispatch_s.append(time.perf_counter() - t0)
            note_bands()
            nxt = (f"pipelined {k + 2}", w, eng.last_mode, pend)
        if pending is not None:
            label, w_prev, mode, pend_prev = pending
            t0 = time.perf_counter()
            out = pend_prev.collect()
            collect_s.append(time.perf_counter() - t0)
            ticks.append((label, w_prev, out, mode, eng.last_fast_tick))
            paged.append((pend_prev.full_repage, pend_prev.paged))
        pending = nxt
    t_all = time.perf_counter() - t_all0

    drain_s = []
    for j in range(STRIPS_SYNC):
        walk(pos, vel, world)
        w = world_now()
        pend = eng.step_async(*w, meta_dirty=False)
        note_bands()
        mode = eng.last_mode
        pend.wait_device()
        t0 = time.perf_counter()
        out = pend.collect()
        drain_s.append(time.perf_counter() - t0)
        ticks.append((f"sync {j}", w, out, mode, eng.last_fast_tick))
        paged.append((pend.full_repage, pend.paged))

    despawn = rng.choice(np.flatnonzero(active), STRIPS_ACTIVE // 100,
                         replace=False)
    active[despawn] = False
    t0 = time.perf_counter()
    step("slow")
    slow_ms = (time.perf_counter() - t0) * 1e3

    hop = rng.choice(np.flatnonzero(active), STRIPS_ACTIVE // 100,
                     replace=False)
    pos[hop] = rng.uniform(0, world, (len(hop), 2)).astype(np.float32)
    t0 = time.perf_counter()
    step("teleport")
    teleport_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    peak = torch.cuda.max_memory_allocated()

    modes = [tk[3] for tk in ticks]
    fasts = [tk[4] for tk in ticks]
    steady = slice(1, len(ticks) - 2)
    if (set(modes[:-1]) != {"spatial"} or modes[-1] != "fallback:teleport"
            or not all(fasts[steady]) or fasts[-2]):
        raise AssertionError(f"strips_1m: modes {modes}, fast {fasts}")
    spatial_ticks = modes.count("spatial")
    for form in ek.DRAIN_FORMS:
        if launches[form] != spatial_ticks * STRIPS_N:
            raise AssertionError(f"strips_1m: launches {launches} for "
                                 f"{spatial_ticks} strip ticks")
    for label, _, out, _, _ in ticks:
        check_pairs(out[0], n, f"strips_1m {label} enters")
        check_pairs(out[1], n, f"strips_1m {label} leaves")
    telemetry = hold_strip_families(eng, families0, strip_families(),
                                    spatial_ticks, bands)
    metrics = {
        "config": {**STRIPS, "active": STRIPS_ACTIVE, "strips": STRIPS_N,
                   "strip_cols": eng.strip_cols, "halo_cap": eng.halo_cap,
                   "devices": [str(d) for d in mesh]},
        "sharded_updates_per_sec": STRIPS_PIPELINED / t_all * n,
        "ticks_per_sec": STRIPS_PIPELINED / t_all,
        "events_per_tick": float(np.mean([
            len(tk[2][0]) + len(tk[2][1]) for tk in ticks
            if tk[0].startswith("pipelined")])),
        "mode_ticks": {m: modes.count(m) for m in sorted(set(modes))},
        "fast_ticks": eng.total_fast_ticks,
        "shard_migrations": eng.total_migrations,
        "fallback_ticks": eng.total_fallbacks,
        "halo_bytes_per_tick": eng.halo_bytes_per_tick,
        "allgather_equiv_bytes_per_tick": eng.allgather_bytes_per_tick,
        "dispatch_p50_ms": pct(dispatch_s, 50),
        "collect_p50_ms": pct(collect_s, 50),
        "collect_p99_ms": pct(collect_s, 99),
        "post_step_drain_p50_ms": pct(drain_s, 50),
        "full_repage_ticks": sum(full and n > 0 for full, n in paged),
        "storm_events": len(storm[0]),
        "storm_ms": storm_ms,
        "slow_tick_ms": slow_ms,
        "teleport_tick_ms": teleport_ms,
        "dropped": [tk[2][2] for tk in ticks],
        "peak_memory_allocated_bytes": peak,
        "launches": launches,
        "telemetry": telemetry,
    }
    slab = kept["slab"]
    del eng, pend, pend_prev, kept
    torch.cuda.empty_cache()

    # Every tick again through the single-device engine on the card.
    single = tn.NeighborEngine(p, backend="kernel", device=device)
    single.reset()
    sample = SampleSets(n, seed=3)
    for label, w, out, _, _ in ticks:
        want = single.step(*w)
        for k, side in ((0, "enters"), (1, "leaves")):
            if (len(want[k]) != len(out[k])
                    or not np.array_equal(pair_keys(want[k], n),
                                          pair_keys(out[k], n))):
                raise AssertionError(f"strips_1m {label}: {side} differ "
                                     f"from the single-device engine")
        if want[2] != out[2]:
            raise AssertionError(f"strips_1m {label}: dropped differs")
        sample.apply(out[0], out[1])
    print(f"strips_1m: {len(ticks)} ticks equal to the single-device engine",
          flush=True)
    sample.check(*ticks[-1][1], device, "strips_1m")
    del single
    torch.cuda.empty_cache()
    rows = drain_kernel_checks(tn, ek, slab, n, p.max_events // STRIPS_N,
                               device)
    for row in rows:
        row["launches"] = launches[row["name"]]
    return metrics, rows


STRIP_FAMILIES = (
    "aoi_spatial_fast_ticks_total", "aoi_strip_ring_distance",
    "aoi_shard_count", "aoi_shard_entities", "aoi_halo_bytes_total",
    "aoi_allgather_bytes_total", "aoi_halo_bytes_per_tick",
    "aoi_allgather_equiv_bytes_per_tick", "aoi_shard_migrations_total",
    "aoi_shard_fallback_total", "aoi_shard_replans_total",
    "aoi_link_bytes_total",
)


def strip_families() -> dict:
    """The port registry's strip families: {name: {label values: value}}
    (of ``aoi_link_bytes_total`` the halo children only)."""
    from goworld_tpu_torch import telemetry

    out = {}
    for name in STRIP_FAMILIES:
        fam = telemetry.family(name)
        out[name] = {} if fam is None else {
            key: child.value for key, child in fam.children()
            if name != "aoi_link_bytes_total" or key[0] == "halo"}
    return out


def hold_strip_families(eng, before, after, strip_ticks, bands) -> dict:
    """The strip families over a run of ``eng`` (counters as their growth
    from ``before``) against the engine's attributes and the run's own
    counts: ``strip_ticks`` strip ticks whose bands held ``bands`` occupied
    rows. Returns them by name."""
    from goworld_tpu_torch.parallel.spatial import HALO_ROW_BYTES

    counters = {
        "aoi_spatial_fast_ticks_total": {(): eng.total_fast_ticks},
        "aoi_halo_bytes_total": {(): strip_ticks * eng.halo_bytes_per_tick},
        "aoi_allgather_bytes_total": {
            (): eng.total_fallbacks * eng.allgather_bytes_per_tick},
        "aoi_shard_migrations_total": {(): eng.total_migrations},
        "aoi_shard_fallback_total": {("teleport",): 1},
        "aoi_shard_replans_total": {(): eng.total_replans},
        "aoi_link_bytes_total": {},
    }
    d = eng.n_devices
    rows = np.sum(bands, axis=0)
    for s_ in range(d):
        for k, peer in ((0, (s_ - 1) % d), (1, (s_ + 1) % d)):
            counters["aoi_link_bytes_total"][("halo", f"{s_}->{peer}")] = (
                rows[s_, k] * HALO_ROW_BYTES)
    # A counter that did not grow has no growth to read.
    want = {name: {k: float(v) for k, v in vals.items() if v}
            for name, vals in counters.items()}
    grown = {name: {k: v - before[name].get(k, 0.0)
                    for k, v in after[name].items()
                    if v != before[name].get(k, 0.0)}
             for name in counters}
    gauges = {
        "aoi_shard_count": {(): float(d)},
        "aoi_shard_entities": {(str(k),): float(eng.shard_population[k])
                               for k in range(d)},
        "aoi_halo_bytes_per_tick": {(): float(eng.halo_bytes_per_tick)},
        "aoi_allgather_equiv_bytes_per_tick": {
            (): float(eng.allgather_bytes_per_tick)},
        "aoi_strip_ring_distance": {},
    }
    for name, values in gauges.items():
        if after[name] != values:
            raise AssertionError(f"strips_1m: {name} {after[name]}, the "
                                 f"engine's {values}")
    for name, values in want.items():
        if grown[name] != values:
            raise AssertionError(f"strips_1m: {name} grew {grown[name]}, "
                                 f"the run's {values}")
    out = {name: {",".join(k) or "": v for k, v in vals.items()}
           for name, vals in {**grown, **gauges}.items()}
    print(f"strips_1m: strip families equal the engine's and the run's "
          f"counts: {json.dumps(out)}", flush=True)
    return out


def drive_entity(tn, ek, tm, make_mesh, device):
    """BASELINE config 5 through the entity-sharded tier (entity_1m; the
    world of strips_1m): ENTITY_N shards on one card, each launching the
    mask forms on its slab of grid rows. The enter storm, a first steady
    tick (shard 0's slab kept for the kernel checks), ENTITY_PIPELINED
    pipelined and ENTITY_SYNC synchronous steady ticks and a slow tick (1%
    despawned), with the launch counts zeroed just before and read just
    after: each shard launches each mask form once a tick. Then every tick
    again through the single-device engine on the card, a sample against
    brute force, and both mask forms against their plain version at the
    kept slab."""
    from goworld_tpu_torch.telemetry import sentinel

    p = tn.NeighborParams(**STRIPS)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.arange(n) < STRIPS_ACTIVE
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    mesh = make_mesh(ENTITY_N, device)
    eng = tm.ShardedNeighborEngine(p, mesh)
    if eng.backend != "kernel":
        raise AssertionError("the default entity-sharded engine is not the "
                             "slab kernel")
    rows = p.grid_z // ENTITY_N
    eng.reset()
    ticks = []  # (label, world, out)
    paged = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ek.reset_launch_counts()
    steps0 = sentinel.launches_total("sharded_step_kernel")

    def world_now():
        return (pos.copy(), active.copy(), space, radius)

    def step(label, meta_dirty=True):
        w = world_now()
        pend = eng.step_async(*w, meta_dirty=meta_dirty)
        out = pend.collect()
        ticks.append((label, w, out))
        paged.append(pend.paged)
        return out

    t0 = time.perf_counter()
    storm = step("storm")
    storm_ms = (time.perf_counter() - t0) * 1e3

    # The first steady tick, with shard 0's current slab kept.
    kept = {}
    mask = tm.event_mask

    def keep_slab(cells, dual, *args, **kw):
        if dual and not kept:
            kept["slab"] = cells.clone()
        return mask(cells, dual, *args, **kw)

    walk(pos, vel, world)
    tm.event_mask = keep_slab
    try:
        step("tick 1", meta_dirty=False)
    finally:
        tm.event_mask = mask

    dispatch_s, collect_s = [], []
    pending = None
    t_all0 = time.perf_counter()
    for k in range(ENTITY_PIPELINED + 1):
        nxt = None
        if k < ENTITY_PIPELINED:
            walk(pos, vel, world)
            w = world_now()
            t0 = time.perf_counter()
            pend = eng.step_async(*w, meta_dirty=False)
            dispatch_s.append(time.perf_counter() - t0)
            nxt = (f"pipelined {k + 2}", w, pend)
        if pending is not None:
            label, w_prev, pend_prev = pending
            t0 = time.perf_counter()
            out = pend_prev.collect()
            collect_s.append(time.perf_counter() - t0)
            ticks.append((label, w_prev, out))
            paged.append(pend_prev.paged)
        pending = nxt
    t_all = time.perf_counter() - t_all0

    drain_s = []
    for j in range(ENTITY_SYNC):
        walk(pos, vel, world)
        w = world_now()
        pend = eng.step_async(*w, meta_dirty=False)
        pend.wait_device()
        t0 = time.perf_counter()
        out = pend.collect()
        drain_s.append(time.perf_counter() - t0)
        ticks.append((f"sync {j}", w, out))
        paged.append(pend.paged)

    despawn = rng.choice(np.flatnonzero(active), STRIPS_ACTIVE // 100,
                         replace=False)
    active[despawn] = False
    t0 = time.perf_counter()
    step("slow")
    slow_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    steps = sentinel.launches_total("sharded_step_kernel") - steps0
    peak = torch.cuda.max_memory_allocated()

    for form in ek.FORMS:
        if launches[form] != len(ticks) * ENTITY_N:
            raise AssertionError(f"entity_1m: launches {launches} for "
                                 f"{len(ticks)} ticks of {ENTITY_N} shards")
    if steps != len(ticks):
        raise AssertionError(f"entity_1m: {steps} step programs for "
                             f"{len(ticks)} ticks")
    for label, _, out in ticks:
        check_pairs(out[0], n, f"entity_1m {label} enters")
        check_pairs(out[1], n, f"entity_1m {label} leaves")
    metrics = {
        "config": {**STRIPS, "active": STRIPS_ACTIVE, "shards": ENTITY_N,
                   "slab_rows": rows, "backend": eng.backend,
                   "devices": [str(d) for d in mesh]},
        "sharded_updates_per_sec": ENTITY_PIPELINED / t_all * n,
        "ticks_per_sec": ENTITY_PIPELINED / t_all,
        "events_per_tick": float(np.mean([
            len(tk[2][0]) + len(tk[2][1]) for tk in ticks
            if tk[0].startswith("pipelined")])),
        "allgather_equiv_bytes_per_tick": eng.allgather_bytes_per_tick,
        "dispatch_p50_ms": pct(dispatch_s, 50),
        "dispatch_p99_ms": pct(dispatch_s, 99),
        "collect_p50_ms": pct(collect_s, 50),
        "collect_p99_ms": pct(collect_s, 99),
        "post_step_drain_p50_ms": pct(drain_s, 50),
        "paged_shard_sides": paged,
        "storm_events": len(storm[0]),
        "storm_ms": storm_ms,
        "slow_tick_ms": slow_ms,
        "dropped": [tk[2][2] for tk in ticks],
        "peak_memory_allocated_bytes": peak,
        "step_programs": steps,
        "launches": launches,
    }
    slab = kept["slab"]
    del eng, pend, pend_prev, kept
    torch.cuda.empty_cache()

    single = tn.NeighborEngine(p, backend="kernel", device=device)
    single.reset()
    sample = SampleSets(n, seed=3)
    for label, w, out in ticks:
        want = single.step(*w)
        for k, side in ((0, "enters"), (1, "leaves")):
            if (len(want[k]) != len(out[k])
                    or not np.array_equal(pair_keys(want[k], n),
                                          pair_keys(out[k], n))):
                raise AssertionError(f"entity_1m {label}: {side} differ "
                                     f"from the single-device engine")
        if want[2] != out[2]:
            raise AssertionError(f"entity_1m {label}: dropped differs")
        sample.apply(out[0], out[1])
    print(f"entity_1m: {len(ticks)} ticks equal to the single-device engine",
          flush=True)
    sample.check(*ticks[-1][1], device, "entity_1m")
    del single
    torch.cuda.empty_cache()
    if tuple(slab.shape) != (p.space_slots, rows + 2, p.grid_x + 2, 8, 128):
        raise AssertionError(f"entity_1m: kept slab {tuple(slab.shape)}")
    kernel_rows = cell_checks(ek, slab, device)
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        row["slab"] = list(slab.shape)
    return metrics, kernel_rows


def slab_entry(row):
    """A mask form's entry for one sharded phase in the kernels line: the
    phase's launches, the slab it was held at, its times and bound."""
    return {k: row[k] for k in (
        "launches", "slab", "ms", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err", *(("skipped_ms",) if "skipped_ms" in row else ()))}


def entity_service_run(em, tn, device, shards):
    """ENTITY_SERVICE_TICKS ticks of the service_10k world (unfused, no
    cadence tiers) on a service with ``shards`` entity shards (1: the
    single-device engine). Returns each tick's delivered interest pairs
    (sorted watcher * n + other keys, the last after the flush), the tick
    seconds and the service's engine."""
    rt, svc, ents, _, clock, _ = service_world(
        em, tn, device, False, config=ENTITY_SERVICE, tiers=None,
        entity_shards=shards)
    n = svc.engine.params.capacity

    def interest():
        return np.sort(np.fromiter(
            (e._slot * n + o._slot for e in ents for o in e.interested_in),
            np.int64))

    sets, tick_s = [], []
    for _ in range(ENTITY_SERVICE_TICKS):
        t = time.perf_counter()
        service_tick(rt, svc, clock)
        tick_s.append(time.perf_counter() - t)
        sets.append(interest())
    svc.flush()
    sets.append(interest())
    engine = svc.engine
    em.cleanup_for_tests()
    return sets, tick_s, engine


def drive_entity_service(tn, ek, tm, device):
    """entity_service: ENTITY_SERVICE_TICKS ticks of the service_10k world
    on an entity-sharded service (ENTITY_SERVICE_SHARDS shards on the card),
    with the launch counts zeroed just before and read just after, then the
    same ticks on the single-device service: the delivered interest sets
    equal after every tick and after the flush. Then both mask forms
    against their plain version at shard 0's slab of the last dispatch."""
    from goworld_tpu_torch.entity import entity_manager as em

    # Each dispatch launches the dual form once a shard, in shard order:
    # shard 0's slab of the last dispatch is kept for the kernel checks.
    kept = {"dual": 0}
    mask = tm.event_mask

    def keep_slab(cells, dual, *args, **kw):
        if dual:
            if kept["dual"] % ENTITY_SERVICE_SHARDS == 0:
                kept["slab"] = cells.clone()
            kept["dual"] += 1
        return mask(cells, dual, *args, **kw)

    torch.cuda.synchronize()
    ek.reset_launch_counts()
    tm.event_mask = keep_slab
    try:
        sharded, tick_s, eng = entity_service_run(em, tn, device,
                                                  ENTITY_SERVICE_SHARDS)
    finally:
        tm.event_mask = mask
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    if not isinstance(eng, tm.ShardedNeighborEngine) or (
            eng.backend != "kernel"
            or eng.n_devices != ENTITY_SERVICE_SHARDS):
        raise AssertionError(f"entity_service: the service's engine is "
                             f"{type(eng).__name__}")
    single, single_s, _ = entity_service_run(em, tn, device, 1)
    for k, (a, b) in enumerate(zip(sharded, single)):
        if not np.array_equal(a, b):
            raise AssertionError(f"entity_service: tick {k}'s interest sets "
                                 f"({len(a)} pairs) differ from the single-"
                                 f"device service's ({len(b)} pairs)")
    # Each shard launches each mask form once a dispatch: the warmup, the
    # ticks, and the warm-up step of each capacity tier grown on the way.
    for form in ek.FORMS:
        if launches[form] < (ENTITY_SERVICE_TICKS + 1) * ENTITY_SERVICE_SHARDS:
            raise AssertionError(f"entity_service: launches {launches}")
    print(f"entity_service: {ENTITY_SERVICE_TICKS} ticks and the flush, "
          f"interest sets equal to the single-device service's "
          f"({len(sharded[-1])} pairs at the flush)", flush=True)
    p = eng.params
    slab = kept["slab"]
    rows = p.grid_z // ENTITY_SERVICE_SHARDS
    if kept["dual"] % ENTITY_SERVICE_SHARDS or tuple(slab.shape) != (
            p.space_slots, rows + 2, p.grid_x + 2, 8, 128):
        raise AssertionError(f"entity_service: kept slab "
                             f"{tuple(slab.shape)} of {kept['dual']} dual "
                             f"launches")
    kernel_rows = cell_checks(ek, slab, device)
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        row["slab"] = list(slab.shape)
    return {
        "config": {**ENTITY_SERVICE, "shards": ENTITY_SERVICE_SHARDS,
                   "shard_mode": "entity", "entities": SERVICE_ENTITIES,
                   "radius": SERVICE_RADIUS, "ticks": ENTITY_SERVICE_TICKS},
        "tick_p50_ms": pct(tick_s, 50),
        "single_device_tick_p50_ms": pct(single_s, 50),
        "interest_pairs": [len(x) for x in sharded],
        "launches": launches,
    }, kernel_rows


def multihost_world(n):
    """The multihost phase's world (see MULTIHOST): (rng, pos, active,
    space, radius)."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 6400, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[n // 2:] = rng.random(n - n // 2) < 0.5
    space = rng.integers(0, 64, n).astype(np.int32)
    radius = np.full(n, 80.0, np.float32)
    return rng, pos, active, space, radius


def multihost_drift(rng, pos):
    return np.clip(pos + rng.normal(0, 3, pos.shape), 0,
                   6400).astype(np.float32)


def multihost_trace(n):
    """The multihost phase's ticks: (label, (pos, active, space, radius),
    meta_dirty); only positions change after the storm."""
    rng, pos, active, space, radius = multihost_world(n)
    for tick in range(MULTIHOST_TICKS):
        yield f"tick {tick}", (pos, active, space, radius), tick == 0
        pos = multihost_drift(rng, pos)


def multihost_1m_trace(n):
    """multihost_1m's ticks (strips_1m's world, see MULTIHOST_1M_PROCS):
    the storm, the steady ticks, the slow tick."""
    world = STRIPS["grid_x"] * STRIPS["cell_size"]
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.arange(n) < STRIPS_ACTIVE
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    yield "storm", (pos.copy(), active.copy(), space, radius), True
    for k in range(MULTIHOST_1M_STEADY):
        walk(pos, vel, world)
        yield f"steady {k + 1}", (pos.copy(), active, space, radius), False
    despawn = rng.choice(np.flatnonzero(active), STRIPS_ACTIVE // 100,
                         replace=False)
    active = active.copy()
    active[despawn] = False
    yield "slow", (pos.copy(), active, space, radius), True


# Each worker configuration: (params, local shards, backends, trace).
MULTIHOST_CONFIGS = {
    "multihost": (MULTIHOST, MULTIHOST_LOCAL, ("reference", "kernel"),
                  multihost_trace),
    "multihost_1m": (STRIPS, MULTIHOST_1M_LOCAL, ("kernel",),
                     multihost_1m_trace),
}


def multihost_worker(rank: int, nprocs: int, coord: str, outfile: str,
                     config: str) -> int:
    """One process of a multihost phase: joins the group of ``nprocs``
    processes, steps ``config``'s engines (MULTIHOST_CONFIGS) with its own
    rows, and saves its gather route, events, tick and gather times,
    kernel launches and peak memory; rank 0 also global shard 0's slab of
    the kernel backend's tick 1."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from goworld_tpu_torch.ops import event_kernel as ek
    from goworld_tpu_torch.ops.neighbor import NeighborParams
    from goworld_tpu_torch.parallel import mesh as tm
    from goworld_tpu_torch.parallel import multihost as mh
    from goworld_tpu_torch.parallel.mesh import make_mesh

    params, local, backends, trace = MULTIHOST_CONFIGS[config]
    mh.init_multihost(coord, nprocs, rank, timeout_s=MULTIHOST_TIMEOUT_S)
    p = NeighborParams(**params)
    dump = {"route": np.array(mh.gather_route()),
            "card": np.array(torch.cuda.get_device_name())}
    kept = {}
    mask = tm.event_mask

    def keep_slab(cells, dual, *args, **kw):
        if dual and not kept:
            kept["slab"] = cells.clone()
        return mask(cells, dual, *args, **kw)
    for backend in backends:
        eng = mh.MultiHostNeighborEngine(p, make_mesh(local, "cuda"),
                                         backend=backend)
        eng.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ek.reset_launch_counts()
        lo, lc = eng.local_lo, eng.local_capacity
        gather, tick_s = [], []
        for tick, (_, world, meta_dirty) in enumerate(trace(p.capacity)):
            if backend == "kernel" and tick == 1 and rank == 0:
                tm.event_mask = keep_slab
            t0 = time.perf_counter()
            try:
                pend = eng.step_async(*(a[lo:lo + lc] for a in world),
                                      meta_dirty=meta_dirty)
                e, l, dropped = pend.collect()
            finally:
                tm.event_mask = mask
            tick_s.append(time.perf_counter() - t0)
            gather.append(pend.gather_ms)
            dump[f"{backend}_enter_{tick}"] = e
            dump[f"{backend}_leave_{tick}"] = l
            dump[f"{backend}_dropped_{tick}"] = np.array([dropped])
        torch.cuda.synchronize()
        dump[f"{backend}_gather_ms"] = np.array(gather)
        dump[f"{backend}_tick_ms"] = np.array(tick_s) * 1000.0
        dump[f"{backend}_launches"] = np.array(
            [ek.launches[f] for f in ek.FORMS])
        dump[f"{backend}_peak_bytes"] = np.array(
            [torch.cuda.max_memory_allocated()])
        dump["local_lo"] = np.array([lo])
        dump["local_capacity"] = np.array([lc])
        del eng, pend
    if "slab" in kept:
        dump["kernel_slab"] = kept["slab"].cpu().numpy()
    torch.distributed.barrier()
    mh.leave()
    np.savez(outfile, **dump)
    print(f"multihost worker {rank}/{nprocs} ({config}): ok", flush=True)
    return 0


def visible_cards() -> list[str]:
    """The cards this process sees, as CUDA_VISIBLE_DEVICES names them."""
    import os

    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (seen.split(",") if seen
             else [str(k) for k in range(torch.cuda.device_count())])
    return cards[:torch.cuda.device_count()]


def run_multihost_workers(root: Path, run_dir: Path, config: str,
                          nprocs: int, cards: list[str], timeout=600):
    """``nprocs`` worker processes of ``config`` that see only ``cards``
    (rank r takes the (r % len(cards))-th); their saved dumps, rank order.
    Every worker is killed in a ``finally``."""
    import os

    coord = f"127.0.0.1:{free_port()}"
    outs = [run_dir / f"{config}_{nprocs}p{len(cards)}c_{i}.npz"
            for i in range(nprocs)]
    env = dict(os.environ, PYTHONPATH=str(root),
               CUDA_VISIBLE_DEVICES=",".join(cards))
    procs = [subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"), "--multihost-worker",
         str(i), str(nprocs), coord, str(outs[i]), config],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nprocs)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for i, (proc, log) in enumerate(zip(procs, logs)):
        (run_dir / f"{outs[i].stem}.log").write_text(log)
        if proc.returncode != 0:
            raise AssertionError(f"{config}: worker {i} of {nprocs} on "
                                 f"{len(cards)} card(s) failed "
                                 f"({proc.returncode}):\n{log[-3000:]}")
    return [dict(np.load(f)) for f in outs]


def hold_multihost_run(data, want, n, backend, what):
    """Each tick: the union of the processes' events equals the single-
    device engine's (``want``), every pair once, and every process reports
    its dropped count; under "reference" each process holds exactly its own
    rows' events."""
    spans = [(int(d["local_lo"][0]), int(d["local_capacity"][0]))
             for d in data]
    for tick, (we, wl, wd) in enumerate(want):
        for side, w in (("enter", we), ("leave", wl)):
            parts = [d[f"{backend}_{side}_{tick}"] for d in data]
            union = np.concatenate(parts)
            if len(union) != len(w) or not np.array_equal(
                    pair_keys(union, n), pair_keys(w, n)):
                raise AssertionError(
                    f"{what} {backend} tick {tick}: the processes' "
                    f"{side}s ({len(union)}) differ from the single-"
                    f"device engine's ({len(w)})")
            if backend == "reference":
                for (lo, lc), part in zip(spans, parts):
                    if ((part[:, 0] < lo) | (part[:, 0] >= lo + lc)).any():
                        raise AssertionError(
                            f"{what} reference tick {tick}: a process "
                            f"got another's rows' {side}s")
        for d in data:
            if int(d[f"{backend}_dropped_{tick}"][0]) != wd:
                raise AssertionError(f"{what} {backend} tick {tick}: "
                                     f"dropped differs")


def multihost_times(data, backend):
    """A run's gather, step (the tick less its gather) and tick times over
    its processes, the storm left out, and its storm's."""
    gather = np.concatenate([d[f"{backend}_gather_ms"][1:] for d in data])
    ticks = np.concatenate([d[f"{backend}_tick_ms"][1:] for d in data])
    steps = np.concatenate([d[f"{backend}_tick_ms"][1:]
                            - d[f"{backend}_gather_ms"][1:] for d in data])
    return {
        "gather_p50_ms": float(np.percentile(gather, 50)),
        "gather_p99_ms": float(np.percentile(gather, 99)),
        "step_p50_ms": float(np.percentile(steps, 50)),
        "step_p99_ms": float(np.percentile(steps, 99)),
        "tick_p50_ms": float(np.percentile(ticks, 50)),
        "tick_p99_ms": float(np.percentile(ticks, 99)),
        "storm_gather_ms": [float(d[f"{backend}_gather_ms"][0])
                            for d in data],
        "storm_tick_ms": [float(d[f"{backend}_tick_ms"][0]) for d in data],
    }


def drive_multihost(tn, ek, root: Path, device):
    """multihost (see MULTIHOST): the runs of ``multihost_runs`` on both
    backends, each held tick by tick against the single-device engine on
    the card (the storm pages); the two-card run's events also equal the
    host route's process by process. Reports each run's route and times.
    Then both mask forms against their plain version at the slab the host
    route's rank 0 kept (the copied slab of 4 space slots)."""
    import shutil

    run_dir = root / "multihost_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    cards = visible_cards()
    p = tn.NeighborParams(**MULTIHOST)
    n = p.capacity
    single = tn.NeighborEngine(p, backend="kernel", device=device)
    single.reset()
    want = [single.step(*w) for _, w, _ in multihost_trace(n)]
    del single
    if len(want[0][0]) <= p.max_events:
        raise AssertionError("multihost: the storm did not page")
    plan = {"one_process": (1, cards[:1], "device"),
            "two_processes_one_card": (2, cards[:1], "host")}
    if len(cards) >= 2:
        plan["two_processes_two_cards"] = (2, cards[:2], "device")
    else:
        print("multihost: the two-card run did not run: it needs two CUDA "
              "devices and this machine has 1", flush=True)
    metrics = {"config": {**MULTIHOST, "local_shards": MULTIHOST_LOCAL,
                          "ticks": MULTIHOST_TICKS}, "runs": {}}
    runs = {}
    for name, (nprocs, run_cards, route) in plan.items():
        data = run_multihost_workers(root, run_dir, "multihost", nprocs,
                                     run_cards)
        routes = [str(d["route"]) for d in data]
        if routes != [route] * nprocs:
            raise AssertionError(f"multihost {name}: routes {routes}, "
                                 f"not {route}")
        run = {"processes": nprocs, "cards": len(run_cards),
               "route": route, "backends": {}}
        for backend in ("reference", "kernel"):
            hold_multihost_run(data, want, n, backend, f"multihost {name}")
            launches = sum(d[f"{backend}_launches"] for d in data)
            run["backends"][backend] = {
                **multihost_times(data, backend),
                "launches": dict(zip(ek.FORMS, map(int, launches))),
            }
            if backend == "kernel" and any(
                    v != MULTIHOST_TICKS * nprocs * MULTIHOST_LOCAL
                    for v in launches):
                raise AssertionError(f"multihost {name}: kernel launches "
                                     f"{run['backends'][backend]}")
        runs[name] = data
        metrics["runs"][name] = run
        print(f"multihost {name}: {nprocs} process(es) x {MULTIHOST_LOCAL} "
              f"shards on {len(run_cards)} card(s), route {route}, both "
              f"backends, {MULTIHOST_TICKS} ticks equal to the single-device "
              f"engine; gather p50 "
              f"{run['backends']['kernel']['gather_p50_ms']:.3f} ms "
              f"(kernel), {run['backends']['reference']['gather_p50_ms']:.3f}"
              f" ms (reference)", flush=True)
    if "two_processes_two_cards" in runs:
        for a, b in zip(runs["two_processes_two_cards"],
                        runs["two_processes_one_card"]):
            for key in a:
                if key.split("_")[1:2] in (["enter"], ["leave"]) and not (
                        np.array_equal(pair_keys(a[key], n),
                                       pair_keys(b[key], n))):
                    raise AssertionError(f"multihost: the device route's "
                                         f"{key} differs from the host "
                                         f"route's")
    metrics["storm_enters"] = len(want[0][0])
    host0 = runs["two_processes_one_card"][0]
    slab = torch.tensor(host0["kernel_slab"], device=device)
    rows = p.grid_z // (MULTIHOST_PROCS * MULTIHOST_LOCAL)
    if tuple(slab.shape) != (p.space_slots, rows + 2, p.grid_x + 2, 8, 128):
        raise AssertionError(f"multihost: kept slab {tuple(slab.shape)}")
    kernel_rows = cell_checks(ek, slab, device)
    launches = metrics["runs"]["two_processes_one_card"]["backends"][
        "kernel"]["launches"]
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        row["slab"] = list(slab.shape)
    del runs, host0, slab
    shutil.rmtree(run_dir, ignore_errors=True)
    return metrics, kernel_rows


def drive_multihost_1m(tn, ek, root: Path, device):
    """multihost_1m (see MULTIHOST_1M_PROCS): four worker processes, one
    card each, the device route over NCCL; every tick's union of events
    equal to the single-device engine's on the card (run after the workers
    left), the storm paged. Reports tick, gather and step times, each
    card's peak memory and the kernel launches, and holds both mask forms
    against their plain version at the slab rank 0 kept. Returns (None,
    None), after a line saying so, on fewer than four cards."""
    import shutil

    cards = visible_cards()
    if len(cards) < MULTIHOST_1M_PROCS:
        print(f"multihost_1m: did not run: it needs {MULTIHOST_1M_PROCS} "
              f"CUDA devices and this machine has {len(cards)}", flush=True)
        return None, None
    run_dir = root / "multihost_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    data = run_multihost_workers(root, run_dir, "multihost_1m",
                                 MULTIHOST_1M_PROCS,
                                 cards[:MULTIHOST_1M_PROCS], timeout=900)
    workers_s = time.perf_counter() - t0
    routes = [str(d["route"]) for d in data]
    if routes != ["device"] * MULTIHOST_1M_PROCS:
        raise AssertionError(f"multihost_1m: routes {routes}")
    p = tn.NeighborParams(**STRIPS)
    n = p.capacity
    n_dev = MULTIHOST_1M_PROCS * MULTIHOST_1M_LOCAL
    single = tn.NeighborEngine(p, backend="kernel", device=device)
    single.reset()
    want, labels = [], []
    for label, w, _ in multihost_1m_trace(n):
        out = single.step(*w)
        check_pairs(out[0], n, f"multihost_1m {label} enters")
        check_pairs(out[1], n, f"multihost_1m {label} leaves")
        want.append(out)
        labels.append(label)
    del single
    torch.cuda.empty_cache()
    if len(want[0][0]) <= p.max_events // n_dev:
        raise AssertionError("multihost_1m: the storm did not page")
    hold_multihost_run(data, want, n, "kernel", "multihost_1m")
    launches = sum(d["kernel_launches"] for d in data)
    if any(v != len(want) * n_dev for v in launches):
        raise AssertionError(f"multihost_1m: kernel launches {launches} "
                             f"for {len(want)} ticks of {n_dev} shards")
    metrics = {
        "config": {**STRIPS, "active": STRIPS_ACTIVE,
                   "processes": MULTIHOST_1M_PROCS,
                   "local_shards": MULTIHOST_1M_LOCAL,
                   "slab_rows": p.grid_z // n_dev, "backend": "kernel",
                   "route": "device", "ticks": labels},
        "cards": [str(d["card"]) for d in data],
        **multihost_times(data, "kernel"),
        "events_per_tick": [len(e) + len(l) for e, l, _ in want],
        "peak_memory_allocated_bytes": [int(d["kernel_peak_bytes"][0])
                                        for d in data],
        "launches": dict(zip(ek.FORMS, map(int, launches))),
        "workers_seconds": workers_s,
    }
    print(f"multihost_1m: {MULTIHOST_1M_PROCS} processes x "
          f"{MULTIHOST_1M_LOCAL} shards on {MULTIHOST_1M_PROCS} cards, "
          f"{len(want)} ticks equal to the single-device engine; tick p50 "
          f"{metrics['tick_p50_ms']:.2f} ms, gather p50 "
          f"{metrics['gather_p50_ms']:.3f} ms", flush=True)
    slab = torch.tensor(data[0]["kernel_slab"], device=device)
    rows = p.grid_z // n_dev
    if tuple(slab.shape) != (p.space_slots, rows + 2, p.grid_x + 2, 8, 128):
        raise AssertionError(f"multihost_1m: kept slab {tuple(slab.shape)}")
    del data
    kernel_rows = cell_checks(ek, slab, device)
    for row in kernel_rows:
        row["launches"] = metrics["launches"][row["name"]]
        row["slab"] = list(slab.shape)
    shutil.rmtree(run_dir, ignore_errors=True)
    return metrics, kernel_rows


def drive_multihost_cluster(root: Path, device_name: str):
    """multihost_cluster (see MH_CLUSTER_INI): the port's CLI starts the
    deployment, both games join one group and run their AOI services in
    lockstep, each on its rank's card: with two or more cards on two cards
    over the device route, on one card sharing it over the host route;
    MH_CLUSTER_BOTS strict bots for MH_CLUSTER_RUN_S with a live reload at
    MH_CLUSTER_RELOAD_S; zero errors, each game's log naming its card and
    the join on that route twice, each game counting AOI steps in both
    incarnations. The cluster is killed in a ``finally`` and no process of
    it may be left."""
    import asyncio
    import shutil

    from goworld_tpu_torch.client.bot_runner import run_fleet

    run_dir = root / "multihost_cluster_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    ports = {k: free_port() for k in ("disp", "gate", "coord", "http1",
                                      "http2")}
    (run_dir / "goworld.ini").write_text(MH_CLUSTER_INI.format(
        dir=run_dir, **ports))
    https = {"game1": ports["http1"], "game2": ports["http2"]}
    joined = "AOI multihost mesh joined: 2 processes"
    n_cards = len(visible_cards())
    route = "device" if n_cards >= 2 else "host"
    if route == "host":
        print("multihost_cluster: the device route did not run: it needs "
              "two CUDA devices and this machine has 1; both games share "
              "the card over the host route", flush=True)
    on_route = f"{joined}, 2 global devices, gather route {route}"

    def steps():
        return {g: game_reading(port)["steps"].get("sharded_step", 0.0)
                for g, port in https.items()}

    async def scenario():
        fleet = asyncio.create_task(run_fleet(
            MH_CLUSTER_BOTS, [("127.0.0.1", ports["gate"])],
            MH_CLUSTER_RUN_S, strict=True, seed=11, thing_timeout=40.0))
        await asyncio.sleep(MH_CLUSTER_RELOAD_S)
        before = await asyncio.to_thread(steps)
        t0 = time.perf_counter()
        r = await asyncio.to_thread(cluster_cli, root, run_dir, "reload",
                                    CLUSTER_SERVER)
        reload_s = time.perf_counter() - t0
        if r.returncode != 0 or "reload complete" not in r.stdout:
            raise AssertionError(f"multihost_cluster: reload failed:\n"
                                 f"{r.stdout}\n{r.stderr}")
        return await fleet, before, reload_s

    t_all = time.perf_counter()
    try:
        r = cluster_cli(root, run_dir, "start", CLUSTER_SERVER)
        if r.returncode != 0 or "cluster started" not in r.stdout:
            raise AssertionError(f"multihost_cluster: start failed:\n"
                                 f"{r.stdout}\n{r.stderr}")
        report, before, reload_s = asyncio.run(scenario())
        after = steps()
        if report["errors"]:
            raise AssertionError(f"multihost_cluster: "
                                 f"{len(report['errors'])} errors: "
                                 f"{report['errors'][:5]}")
        done = {k: v["count"] for k, v in report["things"].items()}
        logs = {g: (run_dir / f"{g}.out.log").read_text() for g in https}
        game_cards = {}
        for g, text in logs.items():
            if text.count(on_route) < 2:
                raise AssertionError(f"multihost_cluster: {g} joined the "
                                     f"group on route {route} "
                                     f"{text.count(on_route)} times")
            for k in (0, 1):
                if ("AOI device: cuda" not in incarnation(text, k)
                        or device_name not in incarnation(text, k)):
                    raise AssertionError(f"multihost_cluster: {g}'s "
                                         f"incarnation {k} does not name "
                                         f"the card")
                game_cards.setdefault(g, set()).update(re.findall(
                    r"AOI device: (cuda:\d+)", incarnation(text, k)))
        if route == "device" and len(set().union(*game_cards.values())) < 2:
            raise AssertionError(f"multihost_cluster: the games did not "
                                 f"take a card each: {game_cards}")
            if before[g] <= 0 or after[g] <= 0:
                raise AssertionError(f"multihost_cluster: {g} counted no "
                                     f"AOI step: {before[g]}, {after[g]}")
        r = cluster_cli(root, run_dir, "stop", CLUSTER_SERVER)
        if r.returncode != 0:
            raise AssertionError(f"multihost_cluster: stop failed:\n"
                                 f"{r.stdout}")
        print(f"multihost_cluster: {MH_CLUSTER_BOTS} strict bots, zero "
              f"errors, both games joined twice", flush=True)
        return {
            "shape": "1 dispatcher x 2 games x 1 gate, [aoi] "
                     "multihost_coordinator, platform auto",
            "bots": MH_CLUSTER_BOTS, "run_s": MH_CLUSTER_RUN_S,
            "errors": 0, "things": done, "timeouts": report["timeouts"],
            "reload_at_s": MH_CLUSTER_RELOAD_S, "reload_window_s": reload_s,
            "joins": {g: t.count(joined) for g, t in logs.items()},
            "route": route,
            "game_cards": {g: sorted(c) for g, c in game_cards.items()},
            "aoi_steps_first_incarnation": before,
            "aoi_steps_restored": after,
            "seconds": time.perf_counter() - t_all,
        }
    finally:
        cluster_cli(root, run_dir, "kill", CLUSTER_SERVER, timeout=120)
        deadline = time.monotonic() + 30
        while cluster_procs(run_dir) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = cluster_procs(run_dir)
        if left:
            raise AssertionError(f"multihost_cluster: processes left: {left}")


def boids_params(tb, cell):
    """bench_boids's configuration at one supercell size: the grid keeps the
    world's side within half a cell."""
    grid = max(4, int(round(BOIDS_WORLD / cell)))
    return tb.BoidsParams(capacity=BOIDS_N, cell_size=cell, grid_x=grid,
                          grid_z=grid, radius=BOIDS_RADIUS)


def boids_world(p, seed=0):
    """bench_boids's start: uniform positions, velocities N(0, 3), all
    active."""
    rng = np.random.default_rng(seed)
    n = p.capacity
    pos = rng.uniform(0, [p.world_x, p.world_z], (n, 2)).astype(np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    return pos, vel, np.ones(n, bool)


def seam_world(p, seed=2):
    """A dense cluster straddling the torus seam at the origin, 400 of the
    agents active (tests/test_boids.py's dense-wrap case)."""
    rng = np.random.default_rng(seed)
    n = p.capacity
    pos = np.mod(rng.normal(0, 60.0, (n, 2)), p.world_x).astype(np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    return pos, vel, np.arange(n) < 400


def boids_cells(tb, p, world, device):
    pos, vel, active = (torch.tensor(a, device=device) for a in world)
    return tb._build_cells(p, pos, vel, active)[0]


# ``boids_skip_edge_cells``'s configuration. Two columns make the x-world
# 256 wide, so |dx| = wx/2 = r, and the image across the x seam decides
# whether a pair in range adds +128 or -127.99999 to its sums. Both worlds
# are powers of two, so dividing by one is exact scaling: XLA lowers the
# Pallas body's division by a constant to a multiplication by its
# reciprocal, which elsewhere moves the image one float above w/2
# (tests/test_torch_boids_skips.py).
BOIDS_SKIP_EDGE = dict(capacity=2048, cell_size=128.0, grid_x=2, grid_z=8,
                       radius=128.0)


def boids_skip_edge_cells(seed=0):
    """Boids-kernel input f32[10, 4, 8, 128] (BOIDS_SKIP_EDGE: 8x2 cells of
    128, radius 128) built by hand, not by ``_build_cells``, to test a
    kernel that walks only occupied candidates, shares lanes across a sparse
    cell's queries and divides by the world size only across the seam.
    Agents sit on integer coordinates in their own cell, at lanes that are
    not a prefix: cell (0, 0) holds one near z = 0 whose only neighbors
    lie across the z seam in row 7, with (0, 1) and row 1 empty; (7, 1)
    holds only lane 127; (2, 1) only lanes 31 and 32; (2, 0) and (6, 1) are
    full; (6, 0) is empty; the rest hold random lanes at 10-80%. Row 3
    holds pairs at d2 == r2 ((128, 0) and (0, 128) apart), at (60, 80),
    inside sep_frac * r, and queries at x = 0 whose candidates lie at
    x = 128 (|dx| = wx/2) and one float above; (4, 0) holds two coincident
    agents. Empty lanes hold finite garbage in x, z, vx and vz and a valid
    row of 0, -0 or -1. The halo ring wraps."""
    rng = np.random.default_rng(seed)
    gz, gx = BOIDS_SKIP_EDGE["grid_z"], BOIDS_SKIP_EDGE["grid_x"]
    cs = BOIDS_SKIP_EDGE["cell_size"]
    core = np.zeros((gz, gx, 8, 128), np.float32)
    core[:, :, :4] = rng.uniform(-1e4, 1e4, (gz, gx, 4, 128))  # garbage
    core[:, :, 4] = rng.choice(np.float32([0.0, -0.0, -1.0]), (gz, gx, 128))
    core[:, :, 5:] = rng.uniform(-1e4, 1e4, (gz, gx, 3, 128))
    free = {(i, j): list(rng.permutation(128)) for i in range(gz)
            for j in range(gx)}

    def put(x, z, lane=None):
        i, j = int(z // cs), int(x // cs)
        lane = free[i, j].pop() if lane is None else lane
        if lane in free[i, j]:
            free[i, j].remove(lane)
        core[i, j, :5, lane] = (x, z, *rng.normal(0, 3.0, 2), 1.0)

    def fill(i, j, n, z_lo=0, z_hi=cs):
        for _ in range(n):
            put(j * cs + rng.integers(0, cs),
                i * cs + rng.integers(z_lo, z_hi))

    put(rng.integers(20, 100), rng.integers(0, 20))  # neighbors: row 7 only
    fill(7, 0, 6, cs - 18, cs)
    put(cs + rng.integers(0, cs), 8 * cs - rng.integers(1, 10), lane=127)
    put(cs + 40, 2 * cs + 50, lane=31)
    put(cs + 43, 2 * cs + 54, lane=32)
    fill(2, 0, 128)
    fill(6, 1, 128)
    z3 = 3 * cs + 16
    for x, z in [(10, z3), (70, z3 + 80), (10 + cs, z3), (10, z3 + cs),
                 (15, z3 + 4), (18, z3)]:
        put(x, z)  # from the first: (60, 80), (128, 0), (0, 128), ...
    put(50, 4 * cs + 50)
    put(50, 4 * cs + 50)  # coincident
    for z in (z3 + 30, z3 + 60):
        put(0.0, z)
        put(cs, z)  # dx = wx/2 exactly
        put(np.nextafter(np.float32(cs), np.float32(2 * cs)), z)
    for i, j in [(3, 0), (3, 1), (4, 0), (4, 1), (5, 0), (5, 1), (7, 0)]:
        n = 128 - len(free[i, j])
        fill(i, j, max(0, int(rng.uniform(0.1, 0.8) * 128) - n))
    zi = np.arange(-1, gz + 1) % gz
    xi = np.arange(-1, gx + 1) % gx
    return np.ascontiguousarray(core[zi][:, xi])


def boids_work(bk, p, cells):
    """(bytes, FP32 operations) that these cells need: the valid row of
    every cell, halo ring included, and x, z, vx and vz of each occupied
    lane (16 B), read once, and the accelerations written once; the
    operations on the pairs of occupied lanes (OPS_PER_*), counted from the
    data. (boids_five_row_bytes gives the earlier count of bytes.)"""
    gz, gx = cells.shape[0] - 2, cells.shape[1] - 2
    wx, wz, _, sep_r2 = bk.step_constants(p)[:4]
    pairs = images = neighbors = close = queries = 0
    for start in range(0, gz * gx, 64):
        idx = torch.arange(start, min(start + 64, gz * gx),
                           device=cells.device)
        q, cand, _, _, d2, nb = bk.halo_pairs(cells, idx, p)
        q_ok = q[:, 4] > 0
        c_ok = cand[:, 4] > 0
        pairs += int((q_ok.sum(1) * c_ok.sum(1) - q_ok.sum(1)).sum())
        both = q_ok[:, :, None] & c_ok[:, None, :]  # self pairs cross nothing
        for f, w in ((0, wx), (1, wz)):
            apart = (cand[:, f][:, None, :] - q[:, f][:, :, None]).abs()
            images += int((both & (apart > w / 2)).sum())
        queries += int(q_ok.sum())
        neighbors += int(nb.sum())
        close += int((nb & (d2 < sep_r2)).sum())
    ops = (OPS_PER_PAIR * pairs + OPS_PER_IMAGE * images
           + OPS_PER_NEIGHBOR * neighbors + OPS_PER_CLOSE * close
           + OPS_PER_QUERY * queries)
    occupied = int((cells[..., 4, :] > 0).sum())
    needed = (gz + 2) * (gx + 2) * 128 * 4 + occupied * 4 * 4
    return needed + gz * gx * 2 * 128 * 4, ops


def boids_five_row_bytes(cells) -> int:
    """The bytes counted for the boids kernel before the count followed the
    occupied lanes: the five used rows (x, z, vx, vz, valid) of every cell,
    halo ring included, and the accelerations."""
    gz, gx = cells.shape[0] - 2, cells.shape[1] - 2
    return (BOIDS_ROWS_READ * (gz + 2) * (gx + 2) * 128 * 4
            + gz * gx * 2 * 128 * 4)


def boids_read_bytes(cells) -> int:
    """Bytes of the cells the kernel loads, each cell counted once (nine
    CTAs read it, mostly from L2): every valid row, and x, z, vx and vz
    only in the 32-byte sectors (8 lanes) that hold an occupied lane."""
    occupied = (cells[..., 4, :] > 0).reshape(*cells.shape[:2], 16, 8)
    sectors = int(occupied.any(-1).sum())
    return cells.shape[0] * cells.shape[1] * 128 * 4 + sectors * 4 * 32


def hold_boids(bk, p, cells, what) -> float:
    """The kernel's accelerations against its plain version on the same
    cells; the largest absolute difference."""
    got = bk.boids_accel(cells, p)
    want = bk.boids_accel_reference(cells, p)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"boids kernel {what}: non-finite output")
    err = float((got - want).abs().max())
    if err > BOIDS_ATOL:
        raise AssertionError(f"boids kernel {what}: differs from the plain "
                             f"version by {err} > {BOIDS_ATOL}")
    return err


def boids_kernel_checks(tb, bk, device):
    """The kernel against its plain version at the start cells of every
    sweep grid and at a small grid with a cluster across the seam; times and
    bounds at each sweep grid, keyed by grid."""
    small = tb.BoidsParams(capacity=512, cell_size=100.0, grid_x=8, grid_z=8)
    seam_err = hold_boids(bk, small, boids_cells(tb, small, seam_world(small),
                                                 device), "seam 8x8")
    print(f"kernel boids: seam grid 8x8, max abs err {seam_err:.3g}",
          flush=True)
    edge = tb.BoidsParams(**BOIDS_SKIP_EDGE)
    edge_cells = torch.tensor(boids_skip_edge_cells(), device=device)
    edge_err = hold_boids(bk, edge, edge_cells, "skip edge")
    edge_ms = cuda_ms(lambda: bk.boids_accel(edge_cells, edge))
    edge_plain = cuda_ms(lambda: bk.boids_accel_reference(edge_cells, edge), 3)
    print(f"kernel boids: skip-edge cells, max abs err {edge_err:.3g}; "
          f"{edge_ms:.4f} ms, plain {edge_plain:.3f} ms", flush=True)
    seam_err = max(seam_err, edge_err)
    by_grid = {}
    for cell in BOIDS_CELL_SWEEP:
        p = boids_params(tb, cell)
        cells = boids_cells(tb, p, boids_world(p), device)
        err = hold_boids(bk, p, cells, f"grid {p.grid_x}")
        ms = cuda_ms(lambda: bk.boids_accel(cells, p))
        plain_ms = cuda_ms(lambda: bk.boids_accel_reference(cells, p), 3)
        bytes_moved, ops = boids_work(bk, p, cells)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        by_grid[p.grid_x] = {
            "cell_size": cell, "max_abs_err": max(err, seam_err),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "bytes": bytes_moved, "bytes_read": boids_read_bytes(cells),
            "bytes_five_rows": boids_five_row_bytes(cells), "fp32_ops": ops,
        }
        print(f"kernel boids: grid {p.grid_x} (cell {cell:g}), max abs err "
              f"{err:.3g}; {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{by_grid[p.grid_x]['bound_ms']:.4f} ms "
              f"({by_grid[p.grid_x]['bound_by']}; {bytes_moved} bytes "
              f"needed, {by_grid[p.grid_x]['bytes_read']} of the cells "
              f"read, {by_grid[p.grid_x]['bytes_five_rows']} in the "
              f"five-row count)", flush=True)
        del cells
    torch.cuda.empty_cache()
    return by_grid


def run_boids(tb, p, steps, device, keep=()):
    """bench_boids at one configuration: a warm-up step, then ``steps``
    chained steps timed on the host clock; the drop counts are read after
    the timed loop. Returns (result, kept) where ``kept[k]`` holds step k's
    inputs and outputs for each k in ``keep``."""
    eng = tb.BoidsEngine(p)
    if eng.backend != "kernel" or eng.device != device:
        raise AssertionError("the default boids engine is not the CUDA "
                             "kernel path")
    pos, vel, active = boids_world(p)
    active = torch.as_tensor(active, device=device)
    pos, vel, _ = eng.step(pos, vel, active)
    torch.cuda.synchronize()
    drops, kept, dispatch = [], {}, []
    t0 = time.perf_counter()
    for k in range(steps):
        inputs = (pos, vel, active)
        t_step = time.perf_counter()
        pos, vel, accel = eng.step(pos, vel, active)
        dispatch.append(time.perf_counter() - t_step)
        drops.append(eng.last_dropped)
        if k in keep:
            kept[k] = (inputs, (pos, vel, accel, eng.last_dropped))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    dropped = int(torch.stack(drops).sum())
    if not bool(torch.isfinite(pos).all() & torch.isfinite(vel).all()):
        raise AssertionError(f"boids grid {p.grid_x}: non-finite state")
    ticks_per_sec = steps / t_all
    return {
        "agents": p.capacity,
        "cell_size": p.cell_size,
        "grid": p.grid_x,
        "steps": steps,
        "ticks_per_sec": ticks_per_sec,
        "boids_agent_updates_per_sec": ticks_per_sec * p.capacity,
        "cell_overflow_dropped": dropped,
        "dispatch_p50_ms": float(np.median(dispatch) * 1e3),
    }, kept


def hold_boids_steps(tb, p, kept, device):
    """Each kept step again through the reference backend on the card, from
    the same inputs (one step at a time: a free-running flock diverges)."""
    ref = tb.BoidsEngine(p, backend="reference", device=device)
    world = torch.tensor([p.world_x, p.world_z], dtype=torch.float64,
                         device=device)
    for k, (inputs, got) in sorted(kept.items()):
        pos, vel, accel = ref.step(*inputs)
        errs = {
            "accel": float((got[2] - accel).abs().max()),
            "vel": float((got[1] - vel).abs().max()),
        }
        d = (got[0].double() - pos.double()).abs()
        errs["pos"] = float(torch.minimum(d, world - d).max())
        if (errs["accel"] > BOIDS_ATOL or errs["vel"] > BOIDS_ATOL
                or errs["pos"] > BOIDS_POS_ATOL):
            raise AssertionError(f"boids step {k}: differs from the "
                                 f"reference backend: {errs}")
        if int(got[3]) != int(ref.last_dropped):
            raise AssertionError(f"boids step {k}: dropped differs")
        print(f"boids step {k}: equal to the reference backend within "
              f"tolerance ({errs}), dropped {int(got[3])}", flush=True)


def kept_agents(p, pos, active):
    """The agents the grid keeps, by the engine's rule, from numpy: the
    active ones less those past a cell's 128 lanes in index order. The rest
    are dropped: zero steering, and invisible to their neighbors."""
    cell = np.float32(p.cell_size)
    cx = np.floor(pos[:, 0] / cell).astype(np.int64) % p.grid_x
    cz = np.floor(pos[:, 1] / cell).astype(np.int64) % p.grid_z
    key = np.where(active, cz * p.grid_x + cx, -1)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    first = np.searchsorted(sorted_key, sorted_key, side="left")
    kept = np.zeros(len(pos), bool)
    kept[order] = (sorted_key >= 0) & (np.arange(len(pos)) - first < 128)
    return kept


def hold_boids_oracle(tb, p, inputs, out, what):
    """A sample of agents' accelerations against the float64 oracle, which
    sees only the agents the grid keeps (flocks condense past a cell's
    lanes over a run); the drop count against the same rule."""
    rows = np.sort(np.random.default_rng(3).choice(p.capacity, SAMPLE,
                                                   replace=False))
    pos, vel, active = (t.cpu().numpy() for t in inputs)
    kept = kept_agents(p, pos, active)
    if int(out[3]) != int((active & ~kept).sum()):
        raise AssertionError(f"boids {what}: dropped {int(out[3])}, the "
                             f"rule drops {int((active & ~kept).sum())}")
    want = tb.reference_accel(p, pos, vel, kept, rows)
    accel = out[2]
    got = accel[torch.as_tensor(rows, device=accel.device)].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=BOIDS_ORACLE_TOL,
                               atol=BOIDS_ORACLE_TOL, err_msg=what)
    print(f"boids oracle {what}: {SAMPLE} agents ({int((~kept[rows]).sum())}"
          f" dropped) within {BOIDS_ORACLE_TOL} of the float64 oracle",
          flush=True)


def drive_boids(tb, bk, device):
    """bench.py's bench_boids_tuned through the port's engine: the sweep at
    BOIDS_SWEEP_STEPS, then the fastest drop-free configuration at
    BOIDS_STEPS, the next one if that run drops agents. Launch counts are
    zeroed just before and read just after."""
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    steps_run = 0
    sweep, candidates = {}, []
    for cell in BOIDS_CELL_SWEEP:
        r, _ = run_boids(tb, boids_params(tb, cell), BOIDS_SWEEP_STEPS, device)
        steps_run += 1 + BOIDS_SWEEP_STEPS
        print(f"boids sweep: {json.dumps(r)}", flush=True)
        sweep[f"cell_{int(cell)}"] = {
            "updates_per_sec": r["boids_agent_updates_per_sec"],
            "dropped": r["cell_overflow_dropped"],
        }
        if r["cell_overflow_dropped"] == 0:
            candidates.append((r["boids_agent_updates_per_sec"], cell))
    candidates.sort(reverse=True)
    order = [c for _, c in candidates] or [BOIDS_CELL_SWEEP[0]]
    keep = (0, BOIDS_STEPS // 2, BOIDS_STEPS - 1)
    for cell in order:
        p = boids_params(tb, cell)
        result, kept = run_boids(tb, p, BOIDS_STEPS, device, keep)
        steps_run += 1 + BOIDS_STEPS
        print(f"boids full run: {json.dumps(result)}", flush=True)
        if result["cell_overflow_dropped"] == 0:
            break
        sweep[f"cell_{int(cell)}"]["disqualified_full_run_dropped"] = (
            result["cell_overflow_dropped"])
    torch.cuda.synchronize()
    launches = bk.launches["boids"]
    if launches != steps_run:
        raise AssertionError(f"boids: {launches} kernel launches for "
                             f"{steps_run} steps")
    hold_boids_steps(tb, p, kept, device)
    for k in (keep[0], keep[-1]):
        hold_boids_oracle(tb, p, *kept[k], f"step {k}")
    result.update({
        "metric": "boids_agent_updates_per_sec",
        "value": result["boids_agent_updates_per_sec"],
        "unit": "agent-updates/sec",
        "vs_baseline": result["boids_agent_updates_per_sec"] / (50_000 * 30),
        "cell_sweep": sweep,
        "launches": launches,
    })
    return result


class FixedClock:
    """The service's and the runtime's clock in ``drive_service``: both runs
    read the same times, so the fused and the unfused programs see the same
    dt sequence."""

    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def interest_pairs(pos, active, space, radius, device):
    """Every (watcher, other) slot pair of the epoch by brute force on the
    card, with the engine's predicate (same space, dx*dx + dz*dz <= r*r of
    the watcher, not itself), as sorted int64 keys watcher * n + other."""
    n = len(pos)
    p = torch.tensor(pos, device=device)
    a = torch.tensor(active, device=device)
    s = torch.tensor(space, device=device)
    r = torch.tensor(radius, device=device)
    keys = []
    for lo in range(0, n, 1024):
        q = torch.arange(lo, min(n, lo + 1024), device=device)
        dx = p[None, :, 0] - p[q, 0][:, None]
        dz = p[None, :, 1] - p[q, 1][:, None]
        d2 = dx * dx + dz * dz
        hit = (a[q][:, None] & a[None, :] & (s[q][:, None] == s[None, :])
               & (d2 <= (r[q] * r[q])[:, None]))
        hit[torch.arange(len(q), device=device), q] = False
        w, o = torch.nonzero(hit, as_tuple=True)
        keys.append(((w + lo) * n + o).cpu().numpy())
    return np.sort(np.concatenate(keys))


def service_world(em, tn, device, fuse, config=SERVICE, tiers=SERVICE_TIERS,
                  entity_shards=1):
    """The service_10k world (see SERVICE) built through the port's
    runtime: returns (runtime, service, avatars, their class, the fixed
    clock, the spawn seconds). The service is the runtime's default, on
    the card; on another ``device`` only to rehearse. ``config`` is the
    engine's params, ``tiers`` the [sync] cadences (None: no tiers) and
    ``entity_shards`` > 1 the entity-sharded tier's shards."""
    from goworld_tpu_torch.entity.columns import columnar_tick
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.slabs import SyncTuning
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.entity.vector import Vector3

    def drift(x, y, z, yaw, dt, vx, vz):
        return x + vx * dt, y, z + vz * dt, yaw + 10.0 * dt, vx, vz

    class ServiceSpace(Space):
        def on_space_created(self):
            if self.kind == 1:
                self.enable_aoi(SERVICE_RADIUS)

    class Walker(Entity):
        on_tick_batch = columnar_tick(drift, ("vx", "vz"))

        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, SERVICE_RADIUS)
            desc.define_attr("vx", "Column")
            desc.define_attr("vz", "Column")

    em.cleanup_for_tests()
    rt = em.runtime
    rt.aoi_backend = "batched"
    rt.aoi_device = None if device.type == "cuda" else str(device)
    rt.aoi_fuse_logic = fuse
    rt.aoi_params = tn.NeighborParams(**config)
    rt.aoi_mesh_shards = entity_shards
    rt.aoi_shard_mode = "entity"
    if tiers is not None:
        rt.slabs.configure_sync(SyncTuning(tier_cadences=tiers))
    em.register_space(ServiceSpace)
    em.register_entity(Walker)
    svc = rt.get_aoi_service()
    if svc.device.type != device.type:
        raise AssertionError(f"the runtime's service is on {svc.device}")
    svc.warmup()  # game boot, before the first login
    world = SERVICE["grid_x"] * SERVICE["cell_size"]
    rng = np.random.default_rng(0)
    xz = rng.uniform(0, world, (SERVICE_ENTITIES, 2))
    vel = rng.normal(0, 3.0, (SERVICE_ENTITIES, 2))
    t0 = time.perf_counter()
    space = em.create_space_locally(1)
    ents = []
    for i in range(SERVICE_ENTITIES):
        e = em.create_entity_locally(
            "Walker", space=space,
            pos=Vector3(float(xz[i, 0]), 0.0, float(xz[i, 1])))
        e.attrs["vx"] = float(vel[i, 0])
        e.attrs["vz"] = float(vel[i, 1])
        ents.append(e)
    spawn_s = time.perf_counter() - t0
    if svc._prewarm_thread is not None:
        svc._prewarm_thread.join()
    eng = svc.engine
    want_backend = "kernel" if device.type == "cuda" else eng.backend
    if eng.backend != want_backend or eng.params.capacity != config[
            "capacity"]:
        raise AssertionError(f"service engine {eng.backend} at "
                             f"{eng.params.capacity} slots")
    # The unfused hook's first dt is now - the class's registration time,
    # the fused step's first dt is 0: the clock starts at the registration.
    clock = FixedClock(rt.slabs._tick_buckets[Walker].last_tick)
    rt.now = clock
    svc.clock = clock
    return rt, svc, ents, Walker, clock, spawn_s


def service_tick(rt, svc, clock):
    """One game-loop tick of the runtime (timers, host tick programs, the
    AOI service); the clock then moves on by SERVICE_DT. Returns the
    delivered (enters, leaves) and the entity logic's host seconds."""
    t = time.perf_counter()
    rt.timer_service.tick()
    rt.slabs.run_tick_batches(rt.now())
    t_logic = time.perf_counter() - t
    out = svc.tick()
    clock.t += SERVICE_DT
    return out, t_logic


def run_service(em, tn, ek, device, fuse):
    """One run of the service_10k drive through the port's runtime (see
    SERVICE): returns its metrics, its final slab state and the last
    dispatched epoch."""
    from goworld_tpu_torch.entity.aoi import batched
    from goworld_tpu_torch.entity.slabs import classify_tiers
    from goworld_tpu_torch.utils import opmon

    rt, svc, ents, Walker, clock, spawn_s = service_world(em, tn, device,
                                                          fuse)
    n = SERVICE["capacity"]
    eng = svc.engine

    # Capture each dispatch's epoch, tiers payload and pending step.
    fasts, captured = [], {}
    step_async = eng.step_async

    def spy(pos, active, space, radius, **kw):
        pending = step_async(pos, active, space, radius, **kw)
        fasts.append(pending.fast)
        k = len(fasts)
        if k in (SERVICE_WARM + 29, SERVICE_WARM + 30):
            captured[k] = (np.array(pos), np.array(radius),
                           kw.get("tiers"), pending.tiers)
        return pending

    eng.step_async = spy
    phase = {"dispatch": 0.0, "deliver": 0.0}

    def timed(name, fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                phase[name] += time.perf_counter() - t
        return run

    svc._dispatch = timed("dispatch", svc._dispatch)
    svc._deliver = timed("deliver", svc._deliver)
    delivery = batched._M_HOST_PHASE.labels("delivery")
    applied = batched._M_FUSED_DELIVERY_EVENTS.labels("applied")
    dropped = batched._M_FUSED_DELIVERY_EVENTS.labels("dropped")
    applied0, dropped0 = applied.value, dropped.value
    hook = Walker.on_tick_batch.__func__
    landed = []
    apply_tiers = rt.slabs.apply_device_tiers

    def count_landed(*args):
        landed.append(apply_tiers(*args))
        return landed[-1]

    rt.slabs.apply_device_tiers = count_landed

    torch.cuda.synchronize()
    ek.reset_launch_counts()
    counts, ticks = [], []
    t_loop = 0.0
    for k in range(SERVICE_WARM + SERVICE_TICKS):
        if k == SERVICE_LOGOUT_TICK:
            for e in ents[::100]:
                e.destroy()
        d0, v0 = dict(phase), delivery.value
        t = time.perf_counter()
        out, t_logic = service_tick(rt, svc, clock)
        counts.append(out)
        t_tick = time.perf_counter() - t
        if k >= SERVICE_WARM:
            t_loop += t_tick
            deliver = phase["deliver"] - d0["deliver"]
            host_delivery = delivery.value - v0
            ticks.append((t_tick, t_logic, phase["dispatch"] - d0["dispatch"],
                          deliver - host_delivery, host_delivery))
    counts.append(svc.flush())
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    dispatches = len(fasts)

    # Interest sets at the flush checkpoint: every entity's interested_in
    # against brute force over the last dispatched epoch.
    ents = [e for e in ents if not e.is_destroyed()]
    epoch = eng.carried_epoch()
    want = interest_pairs(*epoch, device)
    got = np.sort(np.fromiter(
        (e._slot * n + o._slot for e in ents for o in e.interested_in),
        np.int64))
    if not np.array_equal(got, want):
        raise AssertionError(f"service_10k fuse={fuse}: interest sets "
                             f"({len(got)} pairs) differ from brute force "
                             f"({len(want)} pairs)")
    # The device tier vector of a steady tick against classify_tiers on the
    # same snapshot, with that tick's and the previous dispatched epochs.
    k = SERVICE_WARM + 30
    prev_pos = captured[k - 1][0]
    pos, radius, payload, tiers = captured[k]
    if payload is None or tiers is None or payload[4] is None:
        raise AssertionError(f"service_10k: tick {k} carried no tier pass")
    ne = payload[1]
    subj, wat = payload[2][:ne], payload[3][:ne]
    d = pos[subj] - pos[wat]
    pd = prev_pos[subj] - prev_pos[wat]
    host_tiers = classify_tiers(
        (d * d).sum(axis=1), radius[wat], *payload[4],
        (pd * pd).sum(axis=1).astype(np.float32))
    dev_tiers = np.asarray(tiers[2])[:ne]
    if not np.array_equal(dev_tiers, host_tiers):
        raise AssertionError(f"service_10k: device tiers differ from "
                             f"classify_tiers at {int((dev_tiers != host_tiers).sum())} "
                             f"of {ne} edges")
    if fuse and hook.jit_cache_size():
        raise AssertionError("service_10k: the fused class's host hook ran")

    fast = [bool(f) for f in fasts]
    loop = np.asarray(ticks)
    events = np.asarray(counts, np.int64)
    n_edges = rt.slabs.edge_count()
    tier_hist = np.bincount(rt.slabs._e_tier[:n_edges],
                            minlength=len(SERVICE_TIERS))
    tag = f"service_10k fuse_logic={'on' if fuse else 'off'}"
    print(f"{tag}: interest sets of {len(want)} pairs equal brute force at "
          f"the flush; device tiers of tick {k} equal classify_tiers over "
          f"{ne} edges", flush=True)
    metrics = {
        "fuse_logic": fuse,
        "entities": SERVICE_ENTITIES,
        "spawn_s": spawn_s,
        "ticks_per_sec": SERVICE_TICKS / t_loop,
        "aoi_entity_updates_per_sec": (
            SERVICE_TICKS / t_loop * SERVICE_ENTITIES),
        "tick_p50_ms": pct(loop[:, 0], 50),
        "tick_p99_ms": pct(loop[:, 0], 99),
        "entity_logic_p50_ms": pct(loop[:, 1], 50),
        "entity_logic_p99_ms": pct(loop[:, 1], 99),
        "dispatch_p50_ms": pct(loop[:, 2], 50),
        "dispatch_p99_ms": pct(loop[:, 2], 99),
        "collect_p50_ms": pct(loop[:, 3], 50),
        "collect_p99_ms": pct(loop[:, 3], 99),
        "delivery_p50_ms": pct(loop[:, 4], 50),
        "delivery_p99_ms": pct(loop[:, 4], 99),
        "storm_enters": int(events[1, 0]),
        "enters_delivered": int(events[:, 0].sum()),
        "leaves_delivered": int(events[:, 1].sum()),
        "events_per_steady_tick": float(
            events[SERVICE_WARM:-1].sum() / SERVICE_TICKS),
        "paged_ticks": int((events > SERVICE["max_events"]).any(1).sum()),
        "edges": n_edges,
        "tier_histogram": tier_hist.tolist(),
        "device_tier_vectors_landed": int(sum(landed)),
        "device_tier_vectors_discarded": len(landed) - int(sum(landed)),
        "fused_delivery_applied_rows": int(applied.value - applied0),
        "fused_delivery_dropped_rows": int(dropped.value - dropped0),
        "dispatches": dispatches,
        "slow_ticks": fast.count(False),
        "launches": launches,
        "launches_per_tick": {f: launches[f] / dispatches
                              for f in ek.FORMS},
        "aoi_drain_p99_ms": opmon.dump().get(
            "aoi.drain", {}).get("p99", 0.0) * 1e3,
    }
    slots = [e._slot for e in ents]
    final = (rt.slabs.xz[slots].copy(), rt.slabs.y[slots].copy(),
             rt.slabs.yaw[slots].copy(),
             rt.slabs.columns["vx"][slots].copy(),
             rt.slabs.columns["vz"][slots].copy())
    em.cleanup_for_tests()
    return metrics, final, epoch


def drive_service(tn, ek, device):
    """service_10k: the port's main path from ``BatchAOIService.tick``, with
    [aoi] fuse_logic off and then on (see SERVICE). Holds the interest sets
    at each flush against brute force, the device tiers against
    classify_tiers, and the fused run's final positions and columns bit for
    bit against the unfused run's; then holds both mask forms against their
    plain version at the service's cells. Returns the metrics and the
    forms' rows for the kernel line."""
    from goworld_tpu_torch.entity import entity_manager as em

    runs = {}
    finals = {}
    for fuse in (False, True):
        runs[fuse], finals[fuse], epoch = run_service(em, tn, ek, device, fuse)
        print(json.dumps({"service_10k_run": runs[fuse]}), flush=True)
    names = ("positions", "y", "yaw", "vx", "vz")
    for name, a, b in zip(names, finals[False], finals[True]):
        if not np.array_equal(a, b):
            raise AssertionError(f"service_10k: fused {name} differ from the "
                                 f"unfused run's")
    print("service_10k: the fused run's positions and columns are "
          "bit-identical to the unfused run's", flush=True)
    for fuse in (False, True):
        if runs[fuse]["slow_ticks"] < 1:
            raise AssertionError("service_10k: no slow tick ran")
    # Both mask forms at the service's cells (the fused run's last epoch
    # against a step of the walk).
    p = tn.NeighborParams(**SERVICE)
    pos = epoch[0]
    ppos = (pos - np.float32(SERVICE_DT)).astype(np.float32)
    rows = kernel_checks(tn, ek, p, pos, ppos, epoch[2], device)
    metrics = {"config": SERVICE, "radius": SERVICE_RADIUS,
               "tiers": SERVICE_TIERS, "unfused": runs[False],
               "fused": runs[True]}
    return metrics, rows


def endgame_cells(spec):
    """A scenario's world after its last tick, and the tick before: the
    engine params the runner builds for it and the (pos, ppos, space,
    active) of that steady step."""
    from goworld_tpu_torch.scenarios.runner import make_engine

    world = spec.make()
    world.setup()
    try:
        prev = world.pos
        for t in range(1, int(world.config["ticks"])):
            prev = world.pos
            world.tick(t)
    finally:
        world.teardown()
    p = make_engine(world.config, "batched", device="cpu").params
    return p, (world.pos, prev, world.space, world.active)


def drive_scenarios(tn, ek, device):
    """scenarios: each scenario of the matrix on the card through
    ``run_scenario``, on the batched engine (the event kernel's mask forms)
    and on the 8-strip engine with its strips on the one card (the drain
    forms, and the all-gather fallback), each run's ``invariants`` held
    bit for bit against the batched engine on the CPU, the one-launch pin
    read, and the event kernel's launches counted from 0 around each run.
    Then both mask forms at hotspot's endgame cells (the densest cells the
    kernel sees), and the port bench's headline at cut steps. Returns the
    metrics and the mask rows (from the endgame cells)."""
    from goworld_tpu_torch.bench import headline_of
    from goworld_tpu_torch.scenarios import get_scenario
    from goworld_tpu_torch.scenarios.runner import run_scenario

    card = torch.cuda.get_device_name(0)
    runs = {}
    for name in SCENARIOS:
        t0 = time.perf_counter()
        cpu = run_scenario(name, "batched", device="cpu")
        cpu_s = time.perf_counter() - t0
        for engine in ("batched", "sharded"):
            ek.reset_launch_counts()
            t0 = time.perf_counter()
            r = run_scenario(name, engine, device=device, backend="kernel")
            seconds = time.perf_counter() - t0
            launches = dict(ek.launches)
            what = f"scenarios {name} {engine}"
            if r["backend"] != "kernel" or r["device"] != card:
                raise AssertionError(f"{what}: ran on {r['backend']} / "
                                     f"{r['device']}, not the kernel on "
                                     f"{card}")
            if r["invariants"] != cpu["invariants"]:
                raise AssertionError(f"{what}: invariants differ from the "
                                     f"CPU run's: {r['invariants']} vs "
                                     f"{cpu['invariants']}")
            if r["step_launches"] != r["ticks_dispatched"]:
                raise AssertionError(f"{what}: {r['step_launches']} step "
                                     f"launches for {r['ticks_dispatched']} "
                                     f"ticks")
            forms = ek.FORMS if engine == "batched" else ek.DRAIN_FORMS
            for form in forms:
                if launches[form] <= 0:
                    raise AssertionError(f"{what}: {form} was never "
                                         f"launched")
            if (name, engine) == ("hotspot", "sharded") \
                    and r["fallback_ticks"] <= 0:
                raise AssertionError(f"{what}: the crowd never took the "
                                     f"strip-overflow fallback")
            line = {k: r[k] for k in (
                "metric", "value", "unit", "runs", "engine", "backend",
                "device", "seed", "step_launches", "ticks_dispatched",
                "invariants")}
            line.update(
                {k: r[k] for k in ("fallback_ticks", "shard_migrations",
                                   "fast_ticks", "service_op_p95_ms")
                 if k in r},
                event_kernel_launches=launches, seconds=seconds,
                cpu_value=cpu["value"], cpu_seconds=cpu_s)
            print(json.dumps({"scenario": line}), flush=True)
            runs[f"{name}_{engine}"] = line
    print("scenarios: every card run's invariants equal the CPU run's, one "
          "step program a tick, the kernel launched in every run", flush=True)

    # Both mask forms at hotspot's endgame cells.
    p, (pos, ppos, space, active) = endgame_cells(get_scenario("hotspot"))
    cells = steady_cells(tn, p, pos, ppos, space, device, active)
    have = (~torch.isnan(cells[..., ek._FX_A, :])).sum(-1)
    occupied = have[have > 0].float()
    density = {"max_lanes": int(have.max()),
               "mean_lanes_occupied_cells": float(occupied.mean()),
               "occupied_cells": int(occupied.numel())}
    del cells
    rows = kernel_checks(tn, ek, p, pos, ppos, space, device, active)
    print(json.dumps({"hotspot_endgame_cells": density}), flush=True)

    # The port bench's headline at cut steps, as a user runs it: the full
    # record, then the compact headline last.
    out = run_bench(BENCH_ENV, [], 600)
    headline = json.loads(out[-2])
    if json.loads(out[-1]) != headline_of(headline):
        raise AssertionError(f"scenarios: the bench's last line is not its "
                             f"headline: {out[-1]}")
    missing = [k for k in BENCH_FIELDS if k not in headline]
    if missing or headline.get("error"):
        raise AssertionError(f"scenarios: the bench's headline lacks "
                             f"{missing}: {headline.get('error')}")
    if headline["backend"] != "kernel" or headline["device"] != card \
            or not headline["value"] > 0:
        raise AssertionError(f"scenarios: the bench ran {headline}")
    print(json.dumps({"bench_aoi": headline}), flush=True)
    metrics = {"runs": runs, "hotspot_endgame_cells": density,
               "bench_aoi": headline, "bench_env": BENCH_ENV}
    return metrics, rows


def run_bench(env_extra: dict, args: list, timeout: float,
              log: Path | None = None) -> list[str]:
    """``python -m goworld_tpu_torch.bench ARGS`` from the checkout's root,
    as a user runs it: its stdout lines (a non-zero exit raises). The
    process is killed at ``timeout`` seconds; ``log`` keeps its stderr."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = str(root)
    r = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.bench", *args], env=env,
        capture_output=True, text=True, timeout=timeout, cwd=root)
    if log is not None:
        log.write_text(r.stderr)
    r.check_returncode()
    return r.stdout.strip().splitlines()


def bench_sweeps() -> dict:
    """The default run's sweep points, by sweep."""
    from goworld_tpu_torch import bench

    return {
        "cell_sweep": [f"cell_{int(c)}" for c, _ in bench.CELL_SWEEP],
        "events_sweep": [f"max_events_{me}" for me in bench.EVENTS_SWEEP],
        "drain_sweep": [f"drain_{dm}" for dm in bench.DRAIN_SWEEP],
    }


def hold_bench_all(result: dict, card: str) -> dict:
    """The default run's record: every config and sweep point, none with an
    error, the kernel on the card, the boids winner chosen by bench.py's
    drop rule, every phase key positive. Returns its readings."""
    from goworld_tpu_torch.bench import headline_of

    what = "bench_modes all"
    if result.get("error") or result.get("backend") != "kernel" \
            or result.get("device") != card:
        raise AssertionError(f"{what}: the headline ran {headline_of(result)}")
    configs = result["configs"]
    sweeps = bench_sweeps()
    missing = [c for c in BENCH_CONFIGS if c not in configs]
    for name, points in sweeps.items():
        missing += [f"{name}.{k}" for k in points
                    if k not in configs.get(name, {})]
    if missing:
        raise AssertionError(f"{what}: missing {missing}")
    for name, points in sweeps.items():
        for k in points:
            entry = configs[name][k]
            if "error" in entry or not entry["updates_per_sec"] > 0:
                raise AssertionError(f"{what}: {name}.{k}: {entry}")
    for name in ("multispace_32", "synthetic_10k", "boids_50k"):
        entry = configs[name]
        if entry.get("error") or entry.get("backend") != "kernel" \
                or entry.get("device") != card or not entry["value"] > 0:
            raise AssertionError(f"{what}: {name} ran "
                                 f"{headline_of(entry)}: "
                                 f"{entry.get('error')}")
    boids = configs["boids_50k"]
    sweep = boids["cell_sweep"]
    for k, entry in sweep.items():
        if "error" in entry:
            raise AssertionError(f"{what}: boids {k}: {entry['error']}")
    # bench.py's rule: the fastest point drop-free in the sweep runs at
    # full length, the next on a drop; a winner with drops is reported only
    # when every drop-free point dropped at full length (flocks condense
    # past a cell's 128 lanes: on this world from the 18th step at cell 100).
    if boids["cell_overflow_dropped"] != 0:
        clean = [k for k, e in sweep.items() if e["dropped"] == 0]
        if not all(sweep[k].get("disqualified_full_run_dropped", 0) > 0
                   for k in clean) or f"cell_{int(boids['cell_size'])}" \
                not in (clean or ["cell_100"]):
            raise AssertionError(f"{what}: the boids winner dropped "
                                 f"{boids['cell_overflow_dropped']} agents "
                                 f"while a drop-free point remained: "
                                 f"{sweep}")
    # A promoted self-tune keeps the phases with the default config.
    default = configs.get("default_config_headline")
    phases = (default or result).get("phases", {})
    bad = {k: phases.get(k) for k in BENCH_PHASES
           if not (phases.get(k) or 0) > 0}
    if bad or "error" in phases:
        raise AssertionError(f"{what}: phases {bad}: {phases.get('error')}")
    tune = [k for k in ("self_tune", "default_config_headline",
                        "tuned_not_better") if k in configs]
    if len(tune) != 1 or "error" in configs.get("self_tune", {}):
        raise AssertionError(f"{what}: the self-tune outcome is "
                             f"{ {k: configs[k] for k in tune} }")
    return {
        "value": result["value"],
        "default_config_value": (default or result)["value"],
        "config": {k: result[k] for k in ("cell_size", "grid", "max_events",
                                          "drain_mode")},
        "paged_ticks": result["paged_ticks"],
        "post_step_drain_p99_ms": result["post_step_drain_p99_ms"],
        "self_tune": tune[0],
        **{name: configs[name]["value"]
           for name in ("multispace_32", "synthetic_10k")},
        "boids_50k": {k: boids[k] for k in ("value", "cell_size", "grid",
                                            "cell_overflow_dropped")},
        "boids_sweep": boids["cell_sweep"],
        "phases": phases,
        **{name: {k: v["updates_per_sec"] for k, v in configs[name].items()}
           for name in sweeps},
    }


def drive_bench_modes(headline: dict, card: str) -> dict:
    """bench_modes: the port bench's device modes, each in its own process
    as a user runs it: the default run (``BENCH_MODE=all``) at full width
    with its steps cut, ``--sharded`` on each backend, ``--fused`` and
    ``--pinned-floor`` (under ``--history-dir``). Every mode must run the
    kernel on the card and hold its own checks; the bench's headline is
    printed beside the ``headline`` phase's at the same shapes."""
    import shutil

    from goworld_tpu_torch.bench import headline_of
    from goworld_tpu_torch.telemetry import history

    root = Path(__file__).resolve().parent
    run_dir = root / "bench_modes_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir()
    readings = {"env": BENCH_MODES_ENV}
    seconds = {}

    def bench(name, env_extra, args):
        t0 = time.perf_counter()
        lines = run_bench(dict(BENCH_MODES_ENV, **env_extra), args,
                          BENCH_MODES_TIMEOUT_S)
        seconds[name] = time.perf_counter() - t0
        (run_dir / f"{name}.out").write_text("\n".join(lines) + "\n")
        return lines

    lines = bench("all", {"BENCH_MODE": "all"}, [])
    result = json.loads(lines[-2])
    if json.loads(lines[-1]) != headline_of(result):
        raise AssertionError(f"bench_modes all: the last line is not the "
                             f"headline: {lines[-1]}")
    readings["all"] = hold_bench_all(result, card)
    phase_value = headline["aoi_entity_updates_per_sec"]
    readings["headline_beside_phase"] = {
        "bench": readings["all"]["default_config_value"],
        "headline_phase": phase_value,
        "ratio": readings["all"]["default_config_value"] / phase_value,
    }

    for backend in ("kernel", "reference"):
        name = f"sharded_{backend}"
        r = json.loads(bench(name, {}, ["--sharded", "--sharded-backend",
                                        backend])[-1])
        if r.get("error") or r.get("backend") != backend \
                or r.get("device") != card \
                or r.get("parity_with_single_device") is not True \
                or r.get("fallback_ticks") != 0 \
                or r.get("halo_smaller_than_allgather") is not True:
            raise AssertionError(f"bench_modes {name}: {r}")
        readings[name] = {k: r[k] for k in (
            "value", "runs", "parity_with_single_device", "fallback_ticks",
            "fast_ticks", "shard_migrations", "halo_bytes_per_tick",
            "allgather_equiv_bytes_per_tick", "comms_reduction")}

    r = json.loads(bench("fused", {}, ["--fused"])[-1])
    if r.get("error") or r.get("backend") != "kernel" \
            or r.get("device") != card \
            or r.get("fused_hook_never_traced") is not True:
        raise AssertionError(f"bench_modes fused: {r}")
    readings["fused"] = {k: r[k] for k in ("value", "entities", "steps",
                                           "unfused", "fused")}

    hist_dir = run_dir / "history"
    r = json.loads(bench("pinned_floor", {}, [
        "--pinned-floor", "--history-dir", str(hist_dir)])[-1])
    if r.get("error") or r.get("backend") != "kernel" \
            or r.get("device") != card or not r.get("value", 0) > 0:
        raise AssertionError(f"bench_modes pinned_floor: {r}")
    frames, torn = history.read_frames(str(hist_dir / "bench"))
    if torn or not frames or frames[-1].get("process") != "bench" \
            or frames[-1].get("final") is not True:
        raise AssertionError(f"bench_modes: the history ring holds "
                             f"{len(frames)} frames ({torn} torn), the last "
                             f"{frames[-1] if frames else None}")
    # The ring's final frame counts the run's step programs: a storm and
    # ``steps`` ticks a repeat, each one launch of the kernel step.
    steps = {labels["fn"]: n for labels, n in
             frames[-1]["counters"].get("jit_launches_total", [])}
    want = r["config"]["repeats"] * (r["config"]["steps"] + 1)
    if steps != {"aoi_step_kernel": want}:
        raise AssertionError(f"bench_modes: the history ring counts {steps} "
                             f"step programs, not {want} of the kernel's")
    readings["pinned_floor"] = {k: r[k] for k in ("value", "runs")}
    readings["history"] = {"frames": len(frames), "jit_launches_total": steps}
    readings["seconds"] = seconds
    return readings


def pinned_floor_kernel_checks(tn, ek, device):
    """Both mask forms against their plain version at the cells of the
    pinned floor's first steady tick (``bench_pinned_floor``'s world: its
    seed, positions and one step of its walk), timed there."""
    from goworld_tpu_torch.bench import PINNED_FLOOR_CONFIG

    c = PINNED_FLOOR_CONFIG
    p = tn.NeighborParams(
        capacity=c["n"], cell_size=c["cell_size"], grid_x=c["grid"],
        grid_z=c["grid"], space_slots=c["space_slots"],
        cell_capacity=c["cell_capacity"], max_events=c["max_events"],
        drain_mode=c["drain_mode"])
    world = c["grid"] * c["cell_size"]
    rng = np.random.default_rng(0)
    ppos = rng.uniform(0, world, (c["n"], 2)).astype(np.float32)
    vel = rng.normal(0, 3.0, (c["n"], 2)).astype(np.float32)
    pos = np.clip(ppos + vel, 0.0, world)
    space = np.zeros(c["n"], np.int32)
    return kernel_checks(tn, ek, p, pos, ppos, space, device)


def hold_fanout(r: dict, clients: int, gates: int, what: str) -> dict:
    """A fan-out line: records delivered, the fixed shape, every hop busy.
    Returns its readings."""
    from goworld_tpu_torch.bench import FANOUT_HOPS

    busy = r.get("hop_busy_ms", {})
    if r.get("error") or not r.get("value", 0) > 0 \
            or (r.get("clients"), r.get("gates")) != (clients, gates) \
            or (r.get("backend"), r.get("device")) != ("xzlist", "cpu") \
            or not all(busy.get(h, 0) > 0 for h in FANOUT_HOPS):
        raise AssertionError(f"bench_cluster_modes {what}: {r}")
    return {k: r[k] for k in ("value", "runs", "clients", "gates",
                              "hop_busy_ms", "hop_shares", "slab_entities")}


def drive_bench_cluster_modes(tn, ek, device, card: str):
    """bench_cluster_modes: the port bench's cluster modes, each in its own
    process as a user runs it, at its fixed config. The fan-outs and the
    multigame runs are the host pipeline (xzlist games); the pinned floor
    of ``--trace-overhead`` runs the event kernel on the card, under
    ``--history-dir``, whose final frame counts both mask forms' launches
    (the wrapper's own counts, one of each a step program). Returns the
    readings and the mask forms' rows, held and timed at the pinned
    floor's cells."""
    import shutil

    from goworld_tpu_torch.bench import (
        PINNED_FLOOR_CONFIG,
        TRACE_OVERHEAD_RATES,
    )
    from goworld_tpu_torch.telemetry import history

    root = Path(__file__).resolve().parent
    run_dir = root / "bench_cluster_modes_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir()
    hist_dir = run_dir / "history"
    seconds = {}

    def bench(mode, extra=()):
        t0 = time.perf_counter()
        lines = run_bench({}, [f"--{mode}", *extra], CLUSTER_MODES_TIMEOUT_S,
                          log=run_dir / f"{mode}.err")
        seconds[mode] = time.perf_counter() - t0
        (run_dir / f"{mode}.out").write_text("\n".join(lines) + "\n")
        return json.loads(lines[-1])

    readings = {
        "fanout": hold_fanout(bench("fanout"), 80, 1, "fanout"),
        "fanout_multi": hold_fanout(bench("fanout-multi"), 104, 2,
                                    "fanout-multi"),
    }

    r = bench("fanout-massive")
    storm = r.get("reconnect_storm", {})
    if r.get("error") or r.get("clients", 0) < 1000 or r.get("gates", 0) < 2 \
            or r.get("bot_errors") != 0 or not r.get("value", 0) > 0 \
            or r["full"]["bytes_per_client_s"] \
            < 3.0 * r["tiered"]["bytes_per_client_s"] \
            or storm.get("bot_errors") != 0 \
            or storm.get("census_clients") != r["clients"]:
        raise AssertionError(f"bench_cluster_modes fanout-massive: {r}")
    readings["fanout_massive"] = {k: r[k] for k in (
        "value", "clients", "gates", "fleets", "edges", "full", "tiered",
        "bytes_per_client_s", "full_equiv_bytes_per_client_s",
        "bytes_reduction", "records_reduction", "tier_edges",
        "reconnect_storm", "bot_errors")}

    r = bench("trace-overhead", ["--history-dir", str(hist_dir)])
    keys = ["off" if rate == 0 else f"1/{rate}"
            for rate in TRACE_OVERHEAD_RATES]
    rates = r.get("rates", {})
    if r.get("error") or list(rates) != keys \
            or (r.get("backend"), r.get("device")) != ("kernel", card) \
            or any((e["backend"], e["device"]) != ("kernel", card)
                   or not e["fanout"] > 0 or not e["pinned_floor"] > 0
                   for e in rates.values()):
        raise AssertionError(f"bench_cluster_modes trace-overhead: {r}")
    frames, torn = history.read_frames(str(hist_dir / "bench"))
    final = frames[-1] if frames else {}
    if torn or final.get("process") != "bench" \
            or final.get("final") is not True:
        raise AssertionError(f"bench_cluster_modes: the history ring holds "
                             f"{len(frames)} frames ({torn} torn)")
    launches = {labels["form"]: int(n) for labels, n in
                final["gauges"].get("event_kernel_launches", [])}
    steps: dict = {}  # counters are deltas a frame
    for frame in frames:
        for labels, n in frame["counters"].get("jit_launches_total", []):
            steps[labels["fn"]] = steps.get(labels["fn"], 0) + n
    c = PINNED_FLOOR_CONFIG
    want = len(TRACE_OVERHEAD_RATES) * c["repeats"] * (c["steps"] + 1)
    # Each step program launches each mask form once (the single form
    # returning at once on a fast tick).
    if steps != {"aoi_step_kernel": want} \
            or any(launches.get(f) != want for f in ek.FORMS):
        raise AssertionError(f"bench_cluster_modes trace-overhead: "
                             f"{launches} mask launches and {steps} step "
                             f"programs, not {want} of each")
    readings["trace_overhead"] = {
        "value": r["value"],
        "full_sampling_cost_pct": r.get("full_sampling_cost_pct"),
        "rates": {k: {f: e[f] for f in ("pinned_floor", "fanout",
                                        "fanout_runs")}
                  for k, e in rates.items()},
        "event_kernel_launches": launches,
        "step_programs": steps,
    }

    r = bench("multigame")
    restart = r.get("dispatcher_restart_phase", {})
    if r.get("error") or r.get("zero_loss") is not True \
            or r.get("bot_errors") != 0 or not r.get("value", 0) > 0 \
            or restart.get("zero_loss") is not True \
            or restart.get("bot_errors") != 0:
        raise AssertionError(f"bench_cluster_modes multigame: {r}")
    readings["multigame"] = {k: r[k] for k in (
        "value", "convergence_s", "migrations_done", "census",
        "skew_initial", "zero_loss", "bot_errors")}
    readings["multigame"]["dispatcher_restart_phase"] = restart

    r = bench("multigame-spaces")
    phases = r.get("phases", {})
    if r.get("error") or len(phases) < 3 or r.get("value") != len(phases):
        raise AssertionError(f"bench_cluster_modes multigame-spaces: {r}")
    readings["multigame_spaces"] = {
        "value": r["value"],
        "phases": {k: {f: p.get(f) for f in ("recovery_s", "failover_s",
                                             "zero_loss", "bot_errors")
                       if f in p}
                   for k, p in phases.items()},
    }
    readings["seconds"] = seconds

    rows = pinned_floor_kernel_checks(tn, ek, device)
    for row in rows:
        row["launches"] = launches[row["name"]]
    return readings, rows


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cluster_cli(root: Path, run_dir: Path, *args, timeout=600):
    """``python -m goworld_tpu_torch.cli <args>`` in the cluster's run
    directory, with the checkout on PYTHONPATH."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.cli", *args],
        cwd=run_dir, env=env, capture_output=True, text=True,
        timeout=timeout)


def scrape(port: int, path: str, timeout: float = 10) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


def profile_game(port: int) -> dict:
    """One game's ``/profile?mode=torch`` window of PROFILE_S seconds: the
    trace must exist, name the event kernel's entry point (``gw_event_mask``,
    the wrapper's record around its launch) and hold that entry point's
    device kernel (``event_mask_kernel``) among the card's kernels of the
    window; the kernels' summed device time over the window is the game's
    device busy share. ``request_s`` is the request's wall time: the
    window plus the trace's set-up off the game's loop and its export."""
    t0 = time.perf_counter()
    answer = json.loads(scrape(
        port, f"/profile?mode=torch&seconds={PROFILE_S}", timeout=120))
    request_s = time.perf_counter() - t0
    events = json.loads(Path(answer["trace"]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    masks = [e for e in kernels if "event_mask_kernel" in e["name"]]
    if not answer["cuda"] or "gw_event_mask" not in names or not masks:
        raise AssertionError(f"cluster_ci: the game's torch trace "
                             f"{answer['trace']} names no gw_event_mask "
                             f"launch or holds no event_mask_kernel on the "
                             f"card: {answer}")
    by_name = {}
    for e in kernels:
        k = e["name"].replace("(anonymous namespace)::", "").split("(")[0]
        by_name[k] = by_name.get(k, 0.0) + e["dur"] / 1000.0
    busy_ms = sum(by_name.values())
    return {"trace": answer["trace"], "window_s": answer["seconds"],
            "request_s": request_s,
            "device_kernels": len(kernels),
            # Events named after the entry point: the host record, and
            # the trace may copy it onto the card's timeline.
            "gw_event_mask_records": sum(
                1 for e in events if e.get("name") == "gw_event_mask"),
            "event_mask_kernels": len(masks),
            "event_mask_kernel_ms": sum(e["dur"] for e in masks) / 1000.0,
            "kernel_ms": busy_ms,
            "busy_share": busy_ms / (1000.0 * answer["seconds"]),
            "top_kernels_ms": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8])}


def metric_series(text: str, name: str) -> dict:
    """{labels: value} of one Prometheus family of a ``/metrics`` page."""
    out = {}
    for m in re.finditer(rf"^{re.escape(name)}(?:\{{([^}}]*)\}})? (\S+)$",
                         text, re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def game_reading(port: int) -> dict:
    """One game's counters: AOI steps by label, the event kernel's launches
    by form, tick phase seconds and ticks, live entities, and
    ``aoi.drain`` from /opmon."""
    text = scrape(port, "/metrics")
    steps = {k.split('"')[1]: v for k, v in
             metric_series(text, "jit_launches_total").items()}
    forms = {k.split('"')[1]: v for k, v in
             metric_series(text, "event_kernel_launches").items()}
    sums = metric_series(text, "game_tick_phase_seconds_sum")
    counts = metric_series(text, "game_tick_phase_seconds_count")
    phases = {k.split('"')[1]: (v, counts.get(k, 0.0))
              for k, v in sums.items()}
    ents = sum(metric_series(text, "game_entities").values())
    drain = json.loads(scrape(port, "/opmon")).get("aoi.drain", {})
    return {"steps": steps, "forms": forms, "phases": phases,
            "entities": ents, "drain": drain}


def log_time(line: str) -> float:
    """The wall-clock time of one gwlog text line."""
    from datetime import datetime

    stamp = " ".join(line.split()[:2])
    return datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S.%f").timestamp()


def proc_start_wall(pid_and_start: str) -> float:
    """A process's start on the wall clock, from a CLI pidfile ("pid
    starttime", the kernel's start time in clock ticks since boot)."""
    import os

    ticks = int(pid_and_start.split()[1])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    boot = time.time() - uptime
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def incarnation(log_text: str, k: int) -> str:
    """The part of a CLI-kept log that spawn ``k`` wrote (0 = first)."""
    parts = log_text.split("\n--- spawn ")
    return parts[k + 1] if len(parts) > k + 1 else ""


def cluster_procs(run_dir: Path) -> list:
    """Live processes whose command line names the run directory."""
    import os

    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if str(run_dir) in cmd:
            out.append((int(pid), cmd))
    return out


def drive_cluster(root: Path, device_name: str):
    """cluster_ci (see CLUSTER_INI): the port's CLI starts the deployment,
    the port's strict fleet runs twice across a live reload, then the CLI
    stops it. Raises on any error; returns the metrics. The cluster is
    killed in a ``finally`` and no process of it may be left."""
    import asyncio
    import shutil

    from goworld_tpu_torch.client.bot_runner import run_fleet

    run_dir = root / "cluster_ci_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    names = ("disp1", "disp2", "disp3", "gate1", "gate2", "gate3",
             "http1", "http2", "http3")
    ports = {k: free_port() for k in names}
    tls = shutil.which("openssl") is not None
    if tls:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(run_dir / "rsa.key"),
             "-out", str(run_dir / "rsa.crt"), "-days", "1",
             "-subj", "/CN=localhost"],
            check=True, capture_output=True, timeout=120)
    (run_dir / "goworld.ini").write_text(CLUSTER_INI.format(
        dir=run_dir, platform=CLUSTER_PLATFORM,
        tls=CLUSTER_TLS.format(dir=run_dir) if tls else "", **ports))
    gates = [("127.0.0.1", ports[f"gate{i}"]) for i in (1, 2, 3)]
    https = {f"game{i}": ports[f"http{i}"] for i in (1, 2, 3)}
    label = "aoi_step_kernel" if CLUSTER_PLATFORM != "cpu" \
        else "aoi_step_reference"

    def readings():
        return {g: game_reading(port) for g, port in https.items()}

    def logs():
        return {g: (run_dir / f"{g}.out.log").read_text() for g in https}

    async def fleet(seed, peaks, profile=None):
        async def sample():
            while True:
                for g, port in https.items():
                    r = await asyncio.to_thread(game_reading, port)
                    peaks[g] = max(peaks.get(g, 0.0), r["entities"])
                await asyncio.sleep(1.0)

        async def profiled():
            # Once the fleet has spawned (its 4 s stagger), one game's
            # torch profiler window.
            await asyncio.sleep(8.0)
            profile.update(await asyncio.to_thread(
                profile_game, https["game1"]))

        sampler = asyncio.create_task(sample())
        prof = (asyncio.create_task(profiled()) if profile is not None
                else None)
        try:
            report = await run_fleet(
                CLUSTER_BOTS, gates, CLUSTER_RUN_S, strict=True,
                compress=True, tls=tls, seed=seed, thing_timeout=20.0)
            if prof is not None:
                await prof
            return report
        finally:
            sampler.cancel()
            if prof is not None:
                prof.cancel()

    def check_run(report, label_run):
        done = {k: v["count"] for k, v in report["things"].items()}
        if report["errors"]:
            raise AssertionError(f"cluster_ci {label_run}: "
                                 f"{len(report['errors'])} errors: "
                                 f"{report['errors'][:5]}")
        if sum(done.values()) < CLUSTER_BOTS * 2:
            raise AssertionError(f"cluster_ci {label_run}: too little work "
                                 f"done: {done}")
        return {"bots": report["bots"], "errors": len(report["errors"]),
                "timeouts": report["timeouts"], "things": done,
                "retries": report.get("retries")}

    def check_card(text, what):
        if CLUSTER_PLATFORM != "cpu" and (
                "AOI device: cuda" not in text or device_name not in text):
            raise AssertionError(f"cluster_ci: {what}'s log does not name "
                                 f"the card")

    def steps_grew(before, after, what):
        for g in https:
            b = before[g]["steps"].get(label, 0.0)
            a = after[g]["steps"].get(label, 0.0)
            if a <= b:
                raise AssertionError(f"cluster_ci: {g} counted no AOI step "
                                     f"({label}) during {what}")
            if CLUSTER_PLATFORM == "cpu":
                continue
            for form in ("event_mask_single", "event_mask_dual"):
                if (after[g]["forms"].get(form, 0.0)
                        <= before[g]["forms"].get(form, 0.0)):
                    raise AssertionError(f"cluster_ci: {g} launched no "
                                         f"{form} during {what}")

    def per_game(before, after):
        out = {}
        for g in https:
            phases = {}
            for ph, (s, c) in after[g]["phases"].items():
                s0, c0 = before[g]["phases"].get(ph, (0.0, 0.0))
                phases[ph] = {"ticks": c - c0,
                              "ms_per_tick": (1000.0 * (s - s0) / (c - c0)
                                              if c > c0 else None)}
            d = after[g]["drain"]
            out[g] = {
                "aoi_steps": after[g]["steps"].get(label, 0.0)
                - before[g]["steps"].get(label, 0.0),
                "event_kernel_launches": {
                    f: v - before[g]["forms"].get(f, 0.0)
                    for f, v in after[g]["forms"].items()},
                "tick_phases": phases,
                "aoi_drain_ms": {
                    "count": d.get("count"),
                    "p50": 1000.0 * d["p50"] if "p50" in d else None,
                    "p99": 1000.0 * d["p99"] if "p99" in d else None},
            }
        return out

    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        r = cluster_cli(root, run_dir, "start", CLUSTER_SERVER)
        start_s = time.perf_counter() - t0
        if r.returncode != 0 or "cluster started" not in r.stdout:
            raise AssertionError(f"cluster_ci: start failed:\n{r.stdout}\n"
                                 f"{r.stderr}")
        print(f"cluster_ci: started in {start_s:.1f} s", flush=True)
        for name in ("dispatcher1", "gate1"):
            if "-m goworld_tpu_torch." not in \
                    (run_dir / f"{name}.out.log").read_text():
                raise AssertionError(f"cluster_ci: {name} is not the port's")
        for g, text in logs().items():
            check_card(incarnation(text, 0), g)
        peaks1, peaks2 = {}, {}
        profile = {} if CLUSTER_PLATFORM != "cpu" else None
        before1 = readings()
        rep1 = asyncio.run(fleet(42, peaks1, profile))
        after1 = readings()
        run1 = check_run(rep1, "run 1")
        steps_grew(before1, after1, "run 1")
        print(json.dumps({"cluster_ci_run": run1}), flush=True)
        if profile is not None:
            print(f"cluster_ci: game1's torch profile, {PROFILE_S} s window "
                  f"({profile['request_s']:.2f} s request): "
                  f"{profile['kernel_ms']:.3f} ms of kernels, busy share "
                  f"{profile['busy_share']:.5f}, "
                  f"{profile['gw_event_mask_records']} gw_event_mask "
                  f"records, {profile['event_mask_kernels']} "
                  f"event_mask_kernel runs in "
                  f"{profile['event_mask_kernel_ms']:.3f} ms", flush=True)

        t0 = time.perf_counter()
        r = cluster_cli(root, run_dir, "reload", CLUSTER_SERVER)
        reload_s = time.perf_counter() - t0
        if r.returncode != 0 or "reload complete" not in r.stdout:
            raise AssertionError(f"cluster_ci: reload failed:\n{r.stdout}\n"
                                 f"{r.stderr}")
        # Boot-to-ready of each restored game: its process's start to its
        # "deployment ready" line (logged after the dispatchers' ack,
        # which may land just after the CLI saw the started tag).
        boot_to_ready = {}
        deadline = time.monotonic() + 60
        while len(boot_to_ready) < len(https):
            for g, text in logs().items():
                new = incarnation(text, 1)
                ready = [ln for ln in new.splitlines()
                         if "deployment ready" in ln]
                if ready and g not in boot_to_ready:
                    check_card(new, f"restored {g}")
                    start = proc_start_wall(
                        (run_dir / f"{g}.pid").read_text())
                    boot_to_ready[g] = log_time(ready[0]) - start
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_ci: restored games not ready: "
                                     f"{sorted(set(https) - set(boot_to_ready))}")
            time.sleep(0.1)
        print(f"cluster_ci: reload in {reload_s:.1f} s, boot-to-ready "
              f"{boot_to_ready}", flush=True)
        before2 = readings()
        rep2 = asyncio.run(fleet(43, peaks2))
        after2 = readings()
        run2 = check_run(rep2, "run 2")
        steps_grew(before2, after2, "run 2")
        print(json.dumps({"cluster_ci_run": run2}), flush=True)

        r = cluster_cli(root, run_dir, "stop", CLUSTER_SERVER)
        if r.returncode != 0:
            raise AssertionError(f"cluster_ci: stop failed:\n{r.stdout}")
        peak_mem = {}
        for g, text in logs().items():
            found = re.findall(r"peak device memory: (\d+) bytes allocated, "
                               r"(\d+) reserved", text)
            peak_mem[g] = [{"allocated": int(a), "reserved": int(b)}
                           for a, b in found]
            if CLUSTER_PLATFORM != "cpu" and len(found) != 2:
                raise AssertionError(f"cluster_ci: {g} logged its peak "
                                     f"device memory {len(found)} times")
        games1, games2 = per_game(before1, after1), per_game(before2, after2)
        for g in https:
            games1[g]["peak_entities"] = peaks1.get(g)
            games2[g]["peak_entities"] = peaks2.get(g)
            games1[g]["peak_device_memory"] = (peak_mem[g] or [None])[0]
            games2[g]["peak_device_memory"] = (peak_mem[g] or [None])[-1]
        return {
            "shape": "3 dispatchers x 3 games x 3 gates",
            "compress": True, "tls": tls, "platform": CLUSTER_PLATFORM,
            "bots": CLUSTER_BOTS, "run_s": CLUSTER_RUN_S,
            "cut": ["300 s -> 30 s a fleet run"]
            + ([] if tls else ["TLS off: no openssl"]),
            "start_s": start_s,
            "run1": run1, "run2": run2,
            "reload_window_s": reload_s,
            "restored_boot_to_ready_s": boot_to_ready,
            "games_run1": games1, "games_run2": games2,
            "game1_torch_profile": profile,
            "seconds": time.perf_counter() - t_all,
        }
    finally:
        cluster_cli(root, run_dir, "kill", CLUSTER_SERVER, timeout=120)
        deadline = time.monotonic() + 30
        while cluster_procs(run_dir) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = cluster_procs(run_dir)
        if left:
            raise AssertionError(f"cluster_ci: processes left: {left}")


def cluster_kernel_checks(tn, ek, device):
    """Both mask forms against their plain version at the cluster games'
    cells (see CLUSTER_AOI_ENTITIES), timed there. Returns the forms' rows
    and the cells' configuration."""
    from goworld_tpu_torch.config.read_config import AOIConfig
    from goworld_tpu_torch.entity.aoi.batched import params_from_config

    p = params_from_config(AOIConfig())
    rng = np.random.default_rng(7)
    n, k = p.capacity, CLUSTER_AOI_ENTITIES
    ppos = np.zeros((n, 2), np.float32)
    ppos[:k] = rng.integers(-CLUSTER_AOI_HALF, CLUSTER_AOI_HALF + 1, (k, 2))
    pos = ppos.copy()
    pos[:k] += rng.uniform(-CLUSTER_AOI_STEP, CLUSTER_AOI_STEP,
                           (k, 2)).astype(np.float32)
    space = np.zeros(n, np.int32)
    space[:k] = 1 + rng.integers(0, CLUSTER_AOI_SPACES, k)
    active = np.zeros(n, bool)
    active[:k] = True
    rows = kernel_checks(tn, ek, p, pos, ppos, space, device, active)
    config = {"capacity": p.capacity, "grid": [p.grid_x, p.grid_z],
              "cell_size": p.cell_size, "space_slots": p.space_slots,
              "cell_capacity": p.cell_capacity, "entities": k,
              "spaces": CLUSTER_AOI_SPACES, "radius": 100.0}
    return rows, config


def hold_graft_entry(device):
    """``graft_entry.entry()`` once on the card: its packed output against
    the reference step on the same epochs (the enter and leave counts and
    the drop count equal; every emitted enter pair is one of the
    reference's enters)."""
    from goworld_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device)
    t0 = time.perf_counter()
    out = fn(*args)[2]
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    rfn, rargs = graft_entry.reference(device)
    enter_ids, _, rout, _ = rfn(*rargs)
    got, want = out.cpu().numpy(), rout.cpu().numpy()
    n, cap = graft_entry.PARAMS.capacity, graft_entry.PARAMS.max_events
    if not (np.array_equal(got[0], want[0]) and got[1, 0] == want[1, 0]):
        raise AssertionError(f"graft entry: counts {got[:2].tolist()} differ "
                             f"from the reference's {want[:2].tolist()}")
    k = min(int(got[0, 0]), cap)
    emitted = got[3:3 + k]
    check_pairs(emitted, n, "graft entry enters")
    ids = enter_ids.cpu().numpy()
    rows, cols = np.nonzero(ids < n)
    ref = np.sort(rows.astype(np.int64) * n + ids[rows, cols])
    keys = emitted[:, 0].astype(np.int64) * n + emitted[:, 1]
    if len(np.unique(keys)) != k or not np.isin(keys, ref).all():
        raise AssertionError("graft entry: emitted enters are not the "
                             "reference's")
    print(f"graft entry: {int(got[0, 0])} enters, {int(got[0, 1])} leaves, "
          f"dropped {int(got[1, 0])}, {k} emitted: equal to the reference "
          f"step ({ms:.1f} ms, first call)", flush=True)
    return {"enters": int(got[0, 0]), "leaves": int(got[0, 1]),
            "dropped": int(got[1, 0]), "emitted": k, "first_call_ms": ms}


_RECORDER_FRAMES = {"_frames", "_note", "hook", "event_wait", "stream_wait",
                    "device_wait"}


class SyncRecorder:
    """The syncs of the calls this thread makes inside ``recording()``:
    each warning of ``torch.cuda.set_sync_debug_mode("warn")`` ("called a
    synchronizing CUDA operation") and each ``torch.cuda.Event`` or
    ``Stream`` ``synchronize()`` and ``torch.cuda.synchronize()`` (host
    waits on the device; on torch 2.11 the mode reports only the
    Stream's), as a site: the innermost frame of the stack in
    a file under ``root`` whose path starts with one of ``prefixes``
    (repo-relative path, line, function), the frames around it, and what
    was seen. The mode is process-wide, so warnings raised on other threads
    (the service's warm threads) are counted apart and not recorded."""

    def __init__(self, root, prefixes=("goworld_tpu_torch/",)):
        self.root = Path(root).resolve()
        self.prefixes = prefixes
        self.sites = []
        self.other_threads = 0
        self._thread = None

    def _frames(self):
        out = []
        for fr in traceback.extract_stack():
            if fr.name in _RECORDER_FRAMES:
                continue
            try:
                rel = Path(fr.filename).resolve().relative_to(self.root)
            except ValueError:
                continue
            if rel.as_posix().startswith(self.prefixes):
                out.append((rel.as_posix(), fr.lineno, fr.name))
        return out

    def _note(self, what, warned_at=None):
        if threading.get_ident() != self._thread:
            self.other_threads += 1
            return
        frames = self._frames()
        site = frames[-1] if frames else ("<outside>", 0, "?")
        self.sites.append({"path": site[0], "line": site[1],
                           "function": site[2], "what": what,
                           "warned_at": warned_at, "stack": frames})

    @contextmanager
    def recording(self):
        self._thread = threading.get_ident()
        event_sync = torch.cuda.Event.synchronize
        stream_sync = torch.cuda.Stream.synchronize
        device_sync = torch.cuda.synchronize
        rec = self

        def event_wait(ev):
            rec._note("Event.synchronize")
            return event_sync(ev)

        def stream_wait(st):
            rec._note("Stream.synchronize")
            return stream_sync(st)

        def device_wait(device=None):
            rec._note("torch.cuda.synchronize")
            return device_sync(device)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown = warnings.showwarning

            def hook(message, category, filename, lineno, file=None,
                     line=None):
                if "synchronizing" in str(message):
                    try:
                        at = Path(filename).resolve().relative_to(
                            self.root).as_posix()
                    except ValueError:
                        at = filename
                    self._note("sync debug mode", (at, lineno))
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = hook
            torch.cuda.Event.synchronize = event_wait
            torch.cuda.Stream.synchronize = stream_wait
            torch.cuda.synchronize = device_wait
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.Event.synchronize = event_sync
                torch.cuda.Stream.synchronize = stream_sync
                torch.cuda.synchronize = device_sync


def sync_calibration(root, device):
    """Which PyTorch calls the recorder sees on this card and torch, and
    whether the mode's warning names the caller's line: each probe runs
    once inside ``recording()``; returns {probe: [what, ...]} and
    {probe: whether each warning's file and line were the probe's}."""
    x = torch.arange(1, 1025, device=device)
    pinned = torch.empty(1024, dtype=torch.int64, pin_memory=True)
    pageable = torch.empty(1024, dtype=torch.int64)
    event = torch.cuda.Event()
    event.record()
    probes = {
        "item": lambda: x[0].item(),
        "tolist": lambda: x[:4].tolist(),
        "cpu": lambda: x.cpu(),
        "float": lambda: float(x[0]),
        "nonzero": lambda: torch.nonzero(x),
        "unique": lambda: torch.unique(x),
        "masked_select": lambda: torch.masked_select(x, x > 3),
        "bool_index": lambda: x[x > 3],
        "repeat_interleave": lambda: torch.repeat_interleave(x[:4], x[:4]),
        "repeat_interleave_output_size": lambda: torch.repeat_interleave(
            x[:4], x[:4], output_size=10),
        "h2d_pageable": lambda: pageable.to(device),
        "h2d_pageable_non_blocking": lambda: pageable.to(
            device, non_blocking=True),
        "h2d_pinned": lambda: pinned.to(device),
        "h2d_pinned_non_blocking": lambda: pinned.to(device,
                                                     non_blocking=True),
        "d2h_pinned_non_blocking": lambda: pinned.copy_(x, non_blocking=True),
        "tensor_device": lambda: torch.tensor([1, 2], device=device),
        "full_device": lambda: torch.full((), 1.0, device=device),
        "event_synchronize": lambda: event.synchronize(),
        "stream_synchronize": lambda: (
            torch.cuda.current_stream().synchronize()),
        "cuda_synchronize": lambda: torch.cuda.synchronize(),
    }
    seen, caller_line = {}, {}
    for name, fn in probes.items():
        torch.cuda.synchronize()
        rec = SyncRecorder(root, ("chip_smoke.py",))
        with rec.recording():
            fn()
        seen[name] = [s["what"] for s in rec.sites]
        caller_line[name] = [s["warned_at"] == (s["path"], s["line"])
                             for s in rec.sites
                             if s["warned_at"] is not None]
    torch.cuda.synchronize()
    return seen, caller_line


# The recorder's positive control: probes it must see (by the sync debug
# mode, or by its wraps of the host waits the mode does not report) and
# probes that must stay silent, so a mode that stays quiet on this torch
# fails the phase instead of passing (a).
CALIBRATION_SEEN = {
    "item": "sync debug mode", "cpu": "sync debug mode",
    "nonzero": "sync debug mode", "h2d_pageable": "sync debug mode",
    "stream_synchronize": "sync debug mode",
    "event_synchronize": "Event.synchronize",
    "cuda_synchronize": "torch.cuda.synchronize",
}
CALIBRATION_SILENT = ("repeat_interleave_output_size",
                      "h2d_pageable_non_blocking", "h2d_pinned_non_blocking",
                      "d2h_pinned_non_blocking")


def calibration_check(seen):
    """Fails unless each CALIBRATION_SEEN probe was recorded as its kind
    and no CALIBRATION_SILENT probe was recorded."""
    bad = {k: seen[k] for k, what in CALIBRATION_SEEN.items()
           if what not in seen[k]}
    bad.update({k: seen[k] for k in CALIBRATION_SILENT if seen[k]})
    if bad:
        raise AssertionError(f"sync_check: the recorder's calibration "
                             f"failed: {bad}")


def r1_covers(raw, site) -> bool:
    """Whether a recorded site lies on one of R1's raw findings: its
    innermost port frame, or a frame around it (a wait inside a helper
    that a flagged call reached), within a finding's lines."""
    for path, line, _ in reversed(site["stack"]):
        for v in raw:
            if v.path == path and v.line <= line <= max(v.end_line, v.line):
                return True
    return False


def sync_dispatches(rec, eng, ticks, world, kw=None):
    """``ticks`` steps of ``eng`` with each ``step_async`` recorded (the
    collects are not); ``world()`` gives each step's arrays."""
    for _ in range(ticks):
        w = world()
        with rec.recording():
            pend = eng.step_async(*w, **(kw or {}))
        pend.collect()
    torch.cuda.synchronize()


def sync_single(tn, root, device):
    """The single-device engine at the headline: a steady tick, a slow
    tick (1% despawned) and a tick with ``logic=`` and ``tiers=``, each on
    an engine warmed on the same variant. Returns the recorder."""
    from goworld_tpu_torch.entity.columns import FusedProgram

    p = tn.NeighborParams(**HEADLINE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    def drift(x, y, z, yaw, dt, vx, vz):
        return x + vx * dt, y, z + vz * dt, yaw + 10.0 * dt, vx, vz

    def world_now():
        pos[:] = (pos + vel) % world
        return pos.copy(), active.copy(), space, radius

    eng = tn.NeighborEngine(p, device=device)
    eng.reset()
    storm = eng.step_async(*world_now()).collect()
    sync_dispatches(SyncRecorder(root), eng, SYNC_WARM, world_now,
                    {"meta_dirty": False})
    rec = SyncRecorder(root)
    sync_dispatches(rec, eng, SYNC_CHECK_TICKS, world_now,
                    {"meta_dirty": False})
    active[rng.choice(n, n // 100, replace=False)] = False
    sync_dispatches(rec, eng, 1, world_now)
    edges = np.asarray(storm[0][:SYNC_EDGES], np.int32)
    cap = tn.tier_edge_capacity(len(edges))
    subj = np.full(cap, n, np.int32)
    wat = np.full(cap, n, np.int32)
    subj[:len(edges)], wat[:len(edges)] = edges[:, 1], edges[:, 0]
    logic = ((FusedProgram(drift, ("vx", "vz")),),
             active.astype(np.int32), np.zeros(n, np.float32),
             np.zeros(n, np.float32), 1.0,
             (vel[:, 0].copy(), vel[:, 1].copy()))
    kw = {"meta_dirty": False, "logic": logic,
          "tiers": (1, len(edges), subj, wat, (len(SERVICE_TIERS), 0.5, 0.9),
                    True)}
    sync_dispatches(SyncRecorder(root), eng, 1, world_now, kw)
    sync_dispatches(rec, eng, SYNC_CHECK_TICKS, world_now, kw)
    return rec


def sync_service(em, tn, root, device, fuse, tiers):
    """``BatchAOIService._dispatch`` at service_10k's world (fused
    delivery; ``fuse``: [aoi] fuse_logic, ``tiers``: the [sync] cadences
    or None), SYNC_CHECK_TICKS recorded dispatches after SERVICE_WARM +
    SYNC_WARM unrecorded ticks. Returns the recorder."""
    rt, svc, ents, Walker, clock, _ = service_world(em, tn, device, fuse,
                                                    tiers=tiers)
    rec = SyncRecorder(root)
    dispatch = svc._dispatch

    def recorded():
        with rec.recording():
            return dispatch()

    try:
        for k in range(SERVICE_WARM + SYNC_WARM + SYNC_CHECK_TICKS):
            if k == SERVICE_WARM + SYNC_WARM:
                svc._dispatch = recorded
            service_tick(rt, svc, clock)
        svc.flush()
        torch.cuda.synchronize()
    finally:
        em.cleanup_for_tests()
    return rec


def sync_sharded(engine_cls, tn, make_mesh, root, device):
    """An 8-way engine (the strip or the entity-sharded tier) at a cut
    strips_1m world (SYNC_CUT): the storm and SYNC_WARM steady ticks, then
    SYNC_CHECK_TICKS recorded steady dispatches. Returns the recorder."""
    p = tn.NeighborParams(**SYNC_CUT)
    n = p.capacity
    world_x = p.grid_x * p.cell_size
    world_z = p.grid_z * p.cell_size
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(0, world_x, n),
                    rng.uniform(0, world_z, n)], 1).astype(np.float32)
    active = np.arange(n) < SYNC_ACTIVE
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    def world_now():
        pos[:, 0] = (pos[:, 0] + vel[:, 0]) % world_x
        pos[:, 1] = (pos[:, 1] + vel[:, 1]) % world_z
        return pos.copy(), active, space, radius

    eng = engine_cls(p, make_mesh(8, device))
    eng.reset()
    eng.step_async(*world_now()).collect()
    sync_dispatches(SyncRecorder(root), eng, SYNC_WARM, world_now,
                    {"meta_dirty": False})
    rec = SyncRecorder(root)
    sync_dispatches(rec, eng, SYNC_CHECK_TICKS, world_now,
                    {"meta_dirty": False})
    del eng
    torch.cuda.empty_cache()
    return rec


def sync_multihost(tn, make_mesh, root, device):
    """The multi-process engine's device route over NCCL, in a one-process
    group of this process, 8 local shards on the card and the slab kernel,
    at the cut of ``sync_sharded``. Returns the recorder."""
    from goworld_tpu_torch.parallel import multihost as mh

    mh.init_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                      timeout_s=MULTIHOST_TIMEOUT_S)
    try:
        if mh.gather_route() != "device":
            raise AssertionError(f"sync_check: one process took the "
                                 f"{mh.gather_route()} route")
        return sync_sharded(
            lambda p, mesh: mh.MultiHostNeighborEngine(p, mesh, "kernel"),
            tn, make_mesh, root, device)
    finally:
        mh.leave()


def drive_sync_check(tn, tm, ts, make_mesh, root, device):
    """R1's ground truth on the card (see SYNC_CUT): the syncs each engine's
    dispatch makes, by ``SyncRecorder``. Asserts (a) none at all in the
    single-device engine's ``step_async`` and in the service's
    ``_dispatch`` at the default [aoi] and [sync] (no fused logic, one
    tier), the main path's contract, and none that the sync debug mode
    reports in the service's ``_dispatch`` with fused logic and
    service_10k's tiers, whose Event waits (the previous step's fused
    outputs and tier vector, which this dispatch's epoch and edge table
    are built from) are printed, and none in the multi-process engine's
    ``step_async`` on the device route over NCCL; and (b) every site seen on any engine
    lies on one of R1's raw findings (``run_lint`` for R1 without a
    baseline, its line pragmas' findings included): static covers
    dynamic. Prints each engine's sites and
    counts. The recorder is calibrated first (``calibration_check``): a
    probe it should see and does not fails the phase."""
    from goworld_tpu_torch.analysis import core
    from goworld_tpu_torch.entity import entity_manager as em

    t0 = time.perf_counter()
    seen, caller_line = sync_calibration(root, device)
    print(json.dumps({"sync_calibration": seen,
                      "warning_names_caller_line": caller_line}), flush=True)
    calibration_check(seen)
    recs = {
        "single_device": sync_single(tn, root, device),
        "service_dispatch": sync_service(em, tn, root, device, False, None),
        "service_dispatch_fused_tiers": sync_service(
            em, tn, root, device, True, SERVICE_TIERS),
        "strips_8": sync_sharded(ts.SpatialShardedNeighborEngine, tn,
                                 make_mesh, root, device),
        "entity_8": sync_sharded(tm.ShardedNeighborEngine, tn, make_mesh,
                                 root, device),
        "multihost_device_route": sync_multihost(tn, make_mesh, root,
                                                 device),
    }
    lint = core.run_lint(str(root), rules=("R1",))
    raw = lint.violations + lint.suppressed
    out = {"r1_raw_findings": len(raw), "engines": {}}
    uncovered = []
    for name, rec in recs.items():
        sites = {}
        for s in rec.sites:
            key = f"{s['path']}:{s['line']} {s['function']} ({s['what']})"
            sites[key] = sites.get(key, 0) + 1
            if not r1_covers(raw, s):
                uncovered.append((name, key, s["stack"]))
        out["engines"][name] = {"syncs": len(rec.sites), "sites": sites,
                                "other_threads": rec.other_threads}
        print(f"sync_check {name}: {len(rec.sites)} syncs at "
              f"{len(sites)} sites {sites}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"sync_check": out}), flush=True)
    for name, key, stack in uncovered:
        print(f"sync_check {name}: {key} is not in R1's raw findings; "
              f"stack {stack}", flush=True)
    for name in ("single_device", "service_dispatch",
                 "multihost_device_route"):
        if recs[name].sites:
            raise AssertionError(f"sync_check: the main path's {name} "
                                 f"synced: {out['engines'][name]['sites']}")
    mode = [s for s in recs["service_dispatch_fused_tiers"].sites
            if s["what"] == "sync debug mode"]
    if mode:
        raise AssertionError(f"sync_check: the fused service dispatch "
                             f"synced: {mode}")
    if uncovered:
        raise AssertionError(f"sync_check: sites not in R1's raw findings: "
                             f"{uncovered}")
    return out


def unity_runtime(em, tn, device, kvdb_dir):
    """A fresh in-process game runtime (a loopback kvreg, a sqlite kvdb in
    ``kvdb_dir``) with unity_demo registered and its services up, its
    batched AOI service on ``device`` at UNITY with the [sync] tiers of
    service_10k. Returns (runtime, restore) where ``restore()`` undoes the
    loopback."""
    from goworld_tpu_torch import kvdb, kvreg, service
    from goworld_tpu_torch.entity.slabs import SyncTuning
    from goworld_tpu_torch.examples import unity_demo
    from goworld_tpu_torch.kvdb.sqlite import SQLiteKVDB
    from goworld_tpu_torch.utils import post

    em.cleanup_for_tests()
    service.clear_for_tests()
    kvreg.clear_for_tests()
    post.clear()
    kvdb.set_backend(SQLiteKVDB(kvdb_dir))
    register = kvreg.register
    # One game: a registration applies at once, as if the dispatcher had
    # echoed it back.
    kvreg.register = lambda k, v, force=False: kvreg.on_registered(k, v)

    def restore():
        kvreg.register = register
        kvdb.set_backend(None)
        em.cleanup_for_tests()
        service.clear_for_tests()
        kvreg.clear_for_tests()
        post.clear()

    rt = em.runtime
    rt.aoi_backend = "batched"
    rt.aoi_device = None if device.type == "cuda" else str(device)
    rt.aoi_params = tn.NeighborParams(**UNITY)
    rt.slabs.configure_sync(SyncTuning(tier_cadences=SERVICE_TIERS))
    unity_demo.register()
    em.create_nil_space(1)
    service.setup(1)
    service.on_deployment_ready()
    unity_pump(em, lambda: all(service.check_service_entities_ready(s)
                               for s in ("OnlineService", "SpaceService")))
    return rt, restore


def unity_pump(em, cond, timeout=60.0):
    """Tick the runtime until ``cond()``."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("unity_demo: the runtime timed out")
        em.runtime.tick()
        time.sleep(0.005)


def unity_crowd(em, spaces, players):
    """``players`` Players a space in ``spaces`` spaces of kind 1, logged in
    a space's worth at a time (SpaceService sends every request pending
    when a space loads to that space, so a larger batch would overfill
    it): each enters at the spawn point beside the space's monsters."""
    from goworld_tpu_torch.entity.game_client import GameClient

    out = []
    for k in range(spaces):
        batch = []
        for i in range(players):
            p = em.create_entity_locally("Player")
            p.set_client(GameClient(f"{k:04d}{i:012d}", 1, p.id))
            batch.append(p)
        unity_pump(em, lambda: all(p.space is not None
                                   and not p.space.is_nil() for p in batch))
        out += batch
    by_space = {}
    for p in out:
        by_space.setdefault(p.space.id, []).append(p)
    if sorted(map(len, by_space.values())) != [players] * spaces:
        raise AssertionError(f"unity_demo: players a space "
                             f"{sorted(map(len, by_space.values()))}")
    return out


def drive_unity(tn, ek, device, seed):
    """unity_demo's AOI crowd on the card (see UNITY) with the port's
    lock-order detector installed over the whole phase (the service's
    prewarm thread runs during the logins; the tier-warm thread never
    starts, since every variant is ready in the port, and the phase says
    whether it did): engine locks seen, their order acyclic, no blocking
    call under an engine lock, no deadlock. Checks every UNITY_CHECK_EVERY
    ticks, after a flush, every entity's interest set against brute force
    over the last dispatched epoch; no entity dropped; a monster chased a
    player and landed a hit; each mask form launched once a dispatch of
    the loop (the counts are reset after the prewarm thread has ended) and
    held against its plain version at the run's last cells. Returns the
    metrics and the forms' rows."""
    import random
    import tempfile

    from goworld_tpu_torch.analysis.lockgraph import LockGraphMonitor
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.vector import Vector3
    from goworld_tpu_torch.examples.unity_demo import server as ud
    from goworld_tpu_torch.utils import opmon

    random.seed(seed)  # the monsters' spawn offsets
    rng = np.random.default_rng(seed)
    hits, chases = [], []
    attack, move_to = ud.Monster._attack, ud.Monster._move_to

    def counted_attack(self, player):
        if player.attrs.get_int("hp") > 0:
            hits.append(self.id)
        return attack(self, player)

    def counted_move_to(self, player):
        if self.moving_to is not player:
            chases.append(self.id)
        return move_to(self, player)

    ud.Monster._attack, ud.Monster._move_to = counted_attack, counted_move_to
    mon = LockGraphMonitor()
    checked, ticks, dropped = [], [], 0
    try:
        with tempfile.TemporaryDirectory() as kvdb_dir, mon.installed():
            rt, restore = unity_runtime(em, tn, device, kvdb_dir)
            try:
                players = unity_crowd(em, UNITY_SPACES, UNITY_PLAYERS)
                svc = rt.aoi_service
                monsters = [e for s in {p.space for p in players}
                            for e in s.entities if e.typename == "Monster"]
                want = UNITY_SPACES * ud.MySpace.MONSTERS_PER_SPACE
                if len(monsters) != want:
                    raise AssertionError(f"unity_demo: {len(monsters)} "
                                         f"monsters")
                if svc._prewarm_thread is not None:
                    svc._prewarm_thread.join()
                torch.cuda.synchronize()
                ek.reset_launch_counts()
                dispatched = svc._dispatch_count
                opmon.reset()
                for k in range(UNITY_TICKS):
                    step = rng.normal(0, UNITY_STEP, (len(players), 2))
                    for p, (dx, dz) in zip(players, step):
                        q = p.position
                        p.set_position(Vector3(q.x + dx, q.y, q.z + dz))
                    t = time.perf_counter()
                    rt.tick()
                    ticks.append(time.perf_counter() - t)
                    dropped = max(dropped, svc.engine.last_grid_dropped)
                    if (k + 1) % UNITY_CHECK_EVERY == 0:
                        svc.flush()
                        dropped = max(dropped, svc.engine.last_grid_dropped)
                        checked.append(unity_check(
                            svc, players + monsters, device, k + 1))
                    rest = UNITY_DT - (time.perf_counter() - t)
                    if rest > 0:
                        time.sleep(rest)
                svc.flush()
                torch.cuda.synchronize()
                launches = dict(ek.launches)
                dispatched = svc._dispatch_count - dispatched
                drain = opmon.dump().get("aoi.drain", {})
                epoch = svc.engine.carried_epoch()
                params = svc.params
                threads = {"prewarm": svc._prewarm_thread is not None,
                           "tier_warm": svc._tier_warm_thread is not None}
            finally:
                restore()
    finally:
        ud.Monster._attack, ud.Monster._move_to = attack, move_to
    report = mon.report()
    assert_lock_clean(report, "unity_demo")
    if dropped:
        raise AssertionError(f"unity_demo: {dropped} entities dropped")
    if not chases or not hits:
        raise AssertionError(f"unity_demo: {len(chases)} chases, "
                             f"{len(hits)} hits landed")
    want = {f: dispatched if f in ek.FORMS else 0 for f in launches}
    if not dispatched or launches != want:
        raise AssertionError(f"unity_demo: launches {launches} for "
                             f"{dispatched} dispatches")
    if not threads["prewarm"]:
        raise AssertionError(f"unity_demo: warm threads {threads}")
    pos, active, space, _ = epoch
    rows = kernel_checks(tn, ek, params, pos, pos - np.float32(UNITY_STEP),
                         space, device, active=active)
    metrics = {
        "config": UNITY, "spaces": UNITY_SPACES,
        "players_a_space": UNITY_PLAYERS,
        "monsters": len(monsters), "entities": int(active.sum()),
        "ticks": UNITY_TICKS, "checked_ticks": checked,
        "dropped": dropped, "chases": len(chases), "hits": len(hits),
        "tick_p50_ms": pct(ticks, 50), "tick_p99_ms": pct(ticks, 99),
        "aoi_drain_p50_ms": drain.get("p50", 0.0) * 1e3,
        "aoi_drain_p99_ms": drain.get("p99", 0.0) * 1e3,
        "launches": launches, "dispatches": dispatched,
        "warm_threads": threads,
        "lock_graph": {
            "locks_created": report["locks_created"],
            "engine_sites": len(report["goworld_sites"]),
            "engine_edges": sum(
                1 for e in report["edges"]
                if all(s.strip() in report["goworld_sites"]
                       for s in e.split("->"))),
            "engine_cycles": len(report["goworld_cycles"]),
            "engine_blocking": len(report["goworld_blocking"]),
            "deadlocks": len(report["deadlocks"]),
        },
    }
    print(f"unity_demo: {metrics['entities']} entities in "
          f"{UNITY_SPACES} spaces, interest sets equal brute force at "
          f"ticks {checked}; {len(chases)} chases, {len(hits)} hits; "
          f"lock graph clean over {len(report['goworld_sites'])} engine "
          f"lock sites", flush=True)
    return metrics, rows


def unity_check(svc, ents, device, tick):
    """Every entity's interest set against brute force over the service's
    last dispatched epoch (call after a flush). Returns ``tick``."""
    n = svc.params.capacity
    epoch = svc.engine.carried_epoch()
    want = interest_pairs(*epoch, device)
    ents = [e for e in ents if not e.is_destroyed()]
    got = np.sort(np.fromiter(
        (e._slot * n + o._slot for e in ents for o in e.interested_in),
        np.int64))
    if not np.array_equal(got, want):
        raise AssertionError(f"unity_demo tick {tick}: interest sets "
                             f"({len(got)} pairs) differ from brute force "
                             f"({len(want)} pairs)")
    return tick


def assert_lock_clean(report, what):
    """The lock-order detector's conditions (the JAX package's
    ``_assert_lock_clean``): engine locks were seen, their acquisition
    order is acyclic, no blocking call ran under an engine lock, no lock
    was re-acquired by its holder."""
    if report["locks_created"] <= 0 or not report["goworld_sites"]:
        raise AssertionError(f"{what}: the lock monitor saw no engine lock")
    for key in ("goworld_cycles", "goworld_blocking", "deadlocks"):
        if report[key]:
            raise AssertionError(f"{what}: lock graph {key}: {report[key]}")


def ptxas_resources(log):
    """Each kernel's ptxas resource lines from an ``nvcc -Xptxas -v`` log:
    {function: "Used N registers, ...; S bytes stack frame, ..."}."""
    found, name = {}, None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found[name] = []
        elif name is not None and ("registers" in line or "spill" in line):
            found[name].append(line.removeprefix("ptxas info    : "))
    return {k: "; ".join(v) for k, v in found.items()}


def spills(resources) -> bool:
    """Whether a ptxas resource line reports bytes of spill or of stack
    frame."""
    return re.search(r"\b[1-9]\d* bytes (spill|stack frame)",
                     resources) is not None


def build_kernels(_build):
    """Every kernel source built at once, one nvcc each; prints each one's
    build time and each kernel's ptxas resource line. No kernel may spill
    or keep a stack frame."""
    def one(name):
        t0 = time.perf_counter()
        log = _build.build(name)
        return time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        done = dict(zip(_build.SOURCES, pool.map(one, _build.SOURCES)))
    for name, (seconds, log) in done.items():
        print(f"build: {seconds:.1f} s for {KERNELS[name][0]}", flush=True)
        for fn, res in ptxas_resources(log).items():
            print(f"  ptxas {fn}: {res}", flush=True)
            if spills(res):
                raise AssertionError(f"{fn} spills: {res}")


def run_multi_card_phases(tn, ek, device):
    """The multi-process phases, each printing its line; {phase: its mask
    rows} of those that held the mask forms at a slab."""
    root = Path(__file__).resolve().parent
    multihost, rows = drive_multihost(tn, ek, root, device)
    print(json.dumps({"multihost": multihost}), flush=True)
    rows = {"multihost": rows}
    mh_1m, mh_1m_rows = drive_multihost_1m(tn, ek, root, device)
    if mh_1m is not None:
        print(json.dumps({"multihost_1m": mh_1m}), flush=True)
        rows["multihost_1m"] = mh_1m_rows
    mh_cluster = drive_multihost_cluster(root, torch.cuda.get_device_name(0))
    print(json.dumps({"multihost_cluster": mh_cluster}), flush=True)
    return rows


def device_entry() -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multihost-worker"]:  # a multihost process
        return multihost_worker(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5], sys.argv[6])
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) \
        if "--seed" in sys.argv else 0
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import boids as tb
    from goworld_tpu_torch.ops import boids_kernel as bk
    from goworld_tpu_torch.ops import event_kernel as ek
    from goworld_tpu_torch.ops import neighbor as tn
    from goworld_tpu_torch.parallel import make_mesh
    from goworld_tpu_torch.parallel import mesh as tm
    from goworld_tpu_torch.parallel import spatial as ts

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    build_kernels(_build)
    headline, kernels = drive_headline(tn, ek, device)
    print(json.dumps({"headline": headline}), flush=True)
    multispace = drive_multispace(tn, ek, device)
    print(json.dumps({"multispace_32": multispace}), flush=True)
    for row in kernels:  # the kernel checks of both paths
        row["max_abs_err"] = max(row["max_abs_err"],
                                 multispace["kernel_max_abs_err"][row["name"]])

    by_grid = boids_kernel_checks(tb, bk, device)
    boids = drive_boids(tb, bk, device)
    print(json.dumps({"boids_50k": boids}), flush=True)
    source, replaces = KERNELS["boids_kernel"]
    kernels.append({
        "name": "boids", "route": "cuda", "source": source,
        "replaces": replaces, "launches": boids["launches"],
        **{k: v for k, v in by_grid[boids["grid"]].items()
           if k != "max_abs_err"},
        "max_abs_err": max(g["max_abs_err"] for g in by_grid.values()),
        "library_ms": None,
        "by_grid": by_grid,
    })
    strips, drain_rows = drive_strips(tn, ek, ts, make_mesh, device)
    print(json.dumps({"strips_1m": strips}), flush=True)
    entity, entity_rows = drive_entity(tn, ek, tm, make_mesh, device)
    print(json.dumps({"entity_1m": entity}), flush=True)
    for row, erow in zip(kernels, entity_rows):  # the mask forms
        row["entity_1m"] = slab_entry(erow)
        row["max_abs_err"] = max(row["max_abs_err"], erow["max_abs_err"])
    service, service_rows = drive_service(tn, ek, device)
    print(json.dumps({"service_10k": service}), flush=True)
    entity_service, es_rows = drive_entity_service(tn, ek, tm, device)
    print(json.dumps({"entity_service": entity_service}), flush=True)
    for row, srow in zip(kernels, service_rows):  # the mask forms
        run = service["fused"]
        row["service_10k"] = {
            "launches": run["launches"][row["name"]],
            "launches_per_tick": run["launches_per_tick"][row["name"]],
            **{k: srow[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err")},
        }
        row["max_abs_err"] = max(row["max_abs_err"], srow["max_abs_err"])
    for row, erow in zip(kernels, es_rows):  # the mask forms
        row["entity_service"] = slab_entry(erow)
        row["max_abs_err"] = max(row["max_abs_err"], erow["max_abs_err"])
    kernels[2:2] = drain_rows
    scenarios, scenario_rows = drive_scenarios(tn, ek, device)
    print(json.dumps({"scenarios": scenarios}), flush=True)
    for row in kernels[:4]:  # the mask forms by the batched runs, the
        # drain forms by the strip runs
        engine = "batched" if row["name"] in ek.FORMS else "sharded"
        row["scenarios"] = {"launches": sum(
            r["event_kernel_launches"][row["name"]]
            for key, r in scenarios["runs"].items()
            if key.endswith(engine))}
    for row, srow in zip(kernels, scenario_rows):  # the mask forms
        row["scenarios"]["hotspot_endgame"] = {
            k: srow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_abs_err")}
        row["max_abs_err"] = max(row["max_abs_err"], srow["max_abs_err"])
    graft = hold_graft_entry(device)
    cluster_rows, cluster_cells = cluster_kernel_checks(tn, ek, device)
    cluster = drive_cluster(Path(__file__).resolve().parent,
                            torch.cuda.get_device_name(0))
    cluster["graft_entry"] = graft
    cluster["kernel_cells"] = cluster_cells
    print(json.dumps({"cluster_ci": cluster}), flush=True)
    games = [cluster[run][g]["event_kernel_launches"]
             for run in ("games_run1", "games_run2") for g in cluster[run]]
    for row, crow in zip(kernels, cluster_rows):  # the mask forms
        row["cluster_ci"] = {
            "launches": sum(c.get(row["name"], 0.0) for c in games),
            **{k: crow[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err")},
            **({"skipped_ms": crow["skipped_ms"]}
               if "skipped_ms" in crow else {}),
        }
        row["max_abs_err"] = max(row["max_abs_err"], crow["max_abs_err"])
    root = Path(__file__).resolve().parent
    for phase, phase_rows in run_multi_card_phases(tn, ek, device).items():
        for row, mrow in zip(kernels, phase_rows):  # the mask forms
            row[phase] = slab_entry(mrow)
            row["max_abs_err"] = max(row["max_abs_err"], mrow["max_abs_err"])
    unity, unity_rows = drive_unity(tn, ek, device, seed)
    print(json.dumps({"unity_demo": unity}), flush=True)
    for row, urow in zip(kernels, unity_rows):  # the mask forms
        row["unity_demo"] = {
            "launches": unity["launches"][row["name"]],
            **{k: urow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "max_abs_err", "skipped_ms")
               if k in urow},
        }
        row["max_abs_err"] = max(row["max_abs_err"], urow["max_abs_err"])
    drive_sync_check(tn, tm, ts, make_mesh, root, device)
    bench_modes = drive_bench_modes(headline, torch.cuda.get_device_name(0))
    print(json.dumps({"bench_modes": bench_modes}), flush=True)
    cluster_modes, cm_rows = drive_bench_cluster_modes(
        tn, ek, device, torch.cuda.get_device_name(0))
    print(json.dumps({"bench_cluster_modes": cluster_modes}), flush=True)
    for row, crow in zip(kernels, cm_rows):  # the mask forms
        row["trace_overhead"] = {
            k: crow[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "max_abs_err", "skipped_ms")
            if k in crow}
        row["max_abs_err"] = max(row["max_abs_err"], crow["max_abs_err"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": device_entry()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
