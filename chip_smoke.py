#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port — the quickest proof that it
builds and runs on the GPU, and the source of its kernel timings.

    python3 chip_smoke.py [--seed 0] [--detail-dir build/chip_smoke] [--phases all|14|15|16]

With no ``--phases`` (or ``all``) every phase runs, as the proof runs it;
``--phases 14`` runs the build (phase 1) and the tooling phase alone, and
``--phases 15`` the build and the mesh phase alone, ``--phases 16`` the
build and the 2D mesh phase alone, each on data of its own, and prints
no kernel line.

Needs one CUDA card (NVIDIA H100 class, sm_90a), nvcc, a host C++
compiler, and scipy; imports nothing of JAX.  Phases (any failure exits
non-zero; nothing is caught):

1. print the card (nvidia-smi name, power limit); build the CUDA kernels
   from csrc/ (fourteen sources, twenty-three entry points) in parallel and the
   native host runtime
   (runtime/loader.cpp), and time both builds; print the host's CPUs and
   the native runtime's thread count;
2. hold each kernel against its plain torch version on the card, bit for
   bit, and time both with CUDA events beside the analytic bound: the
   stencil route's two (the sweep with the residual edges in its launch,
   against the plain sweep then the plain residual OR; the apply) at its
   main path's shape (road-4096: n = 16.8M, W = 1) and at the sub-batch
   shape (road-1024, n = 1M, W = 8); the mxu
   route's two (tile_hits, push_or) at its main path's shape (RMAT-14,
   T = 128, W = 2, every one of the 16,384 tiles nonzero) and at
   road-512's (T = 128, W = 1), with the bf16 ``torch.bmm`` of the same
   tile products timed as tile_hits' library yardstick (push_or on a
   frontier of about n / 64 rows, listed by the plain switch epilogue,
   beside its launch floor: the same launch gated off); level_apply also
   at the mxu route's plane shapes (RMAT-14 W = 2, road-512 W = 1).  Each
   sweep, apply and tile_hits row names the variant its plan took (ring or
   l2, the W instance, 16- or 4-byte access; pipe with its word group,
   split and stages, or simple), and its bound counts the bytes that
   input needs (the mask only of rows with a nonzero frontier; visited
   only where a hit word is nonzero);
3. stencil main path: road_edges(4096, 4096) with K = 16 random query
   groups as .bin files, through the port's CLI (``cli.main``) on cuda;
   the kernel path's F vector equals the plain path's on the card, and
   the winner's F equals scipy's multi-source BFS; then the sweep and the
   apply held against their plain versions and timed on the planes of the
   BFS's middle level, and 64 real levels from there split by kernel
   (CUDA events around each launch: the sweep with its residual, the
   apply, and the gaps), beside the same 64 levels as the engine enqueues
   them; the CLI's preprocessing span split into load, layout (with its
   upload) and compile (every path prints its split; the NumPy host
   steps are timed beside the native ones once, on RMAT-20 in phase 5b);
4. mxu main path: ``MSBFS_BACKEND=mxu MSBFS_MXU_KERNEL=1`` through the
   CLI on rmat_edges(14) with K = 64 random groups; every F equals
   scipy's and the plain engine's, and the direction trace is printed;
   tile_hits is then held against its plain version and timed on the
   frontier of the BFS's widest matmul level;
   after each CLI path below, the batch start (K4, batch_start) is held
   against its plain version (pack, bit_level_init, switch_record) on
   that route's batch as its engine pads it (stride 1 for bit planes, 8
   for byte planes): every carry field and the switch state bit for bit,
   the worklist as a set; the kernel's, the memset's and the upload's
   device ms (torch.profiler) beside the kernel's bound, the device
   operations and the blocking reads (sync debug mode) of a batch start,
   and its host ms, each against the plain batch start's;
5. the mxu route on road_edges(512, 512) with K = 16: the auto switch
   sends levels both ways within one BFS; same checks; then the BFS a
   level at a time: the direction the device's apply wrote before each
   level equals ``level_direction_trace``, push_or and the switched apply
   are held against their plain versions on every level and timed on
   every eighth (the apply beside the same launch without the switch),
   the whole BFS split by launch with CUDA events (push_or, tile_hits,
   level_apply, gaps), and one engine chunk traced with torch.profiler
   for the device's busy share and the kernels it ran;
5a. the low-K route on RMAT-16 (rmat_edges(16, 16), BASELINE.json config
   1) with one group of one source through the CLI's auto route: F equals
   scipy's and the plain engine's; then the BFS a level at a time, the
   kernel engine equal to the plain engine before every level, the
   level's one expansion call (flag_pull with the push folded into its
   first launch) timed and its launches counted beside the parent's two
   calls (push_or on the byte plane's word view, then the pull alone),
   and its wrapper's host time beside theirs; K5's push (the merged
   launch on a push level) and pull (flag_pull, with the carry's visited
   plane and counters) held against their byte plain versions and timed
   beside their bounds (the pull's whole function's and its level's,
   over the live rows only) and the ``index_reduce_`` amax library call
   (the pull's then masked by ``~visited``), the pull also beside
   bell_hits_packed (forest_or on the word view) on the same frontier,
   the switched apply held and timed; and its launch split, its chunk
   enqueued under ``torch.cuda.set_sync_debug_mode("error")``;
5b. RMAT-20 (rmat_edges(20, 16), BASELINE.json config 2): its CSR,
   per-row dedup and BELL layout built natively and with NumPy, byte-equal,
   each step timed both ways; forest_or and
   ell_hits against their plain versions at K = 64 (W = 2) and K = 256
   (W = 8), timed beside their bounds (forest_or also beside its L2
   floor; ell_hits also beside the two-call
   torch expression of its gather, and both as a level on a stale carry —
   planes rebuilt from dist — and as a steady level on carried planes,
   the latter against its own plain version), and level_apply at W = 2;
   the ELL level split (CUDA events around the pack, gather and apply
   launches of each real level of the K = 64 BFS, with the virtual rows
   the gather skipped and the new labels); the K = 64 bitbell BFS a level
   at a time, as road-512's above (forest_or on each pull level beside its
   bound and L2 floor, push_or on each push level); the switched apply
   on RMAT-20's synthetic W = 2 plane as a pulled and as a pushed level;
   then with
   K = 64 random groups the default route (bitbell: forest_or, push_or,
   level_apply), the ELL route (``MSBFS_BACKEND=pallas``: ell_hits) and
   the byte-plane BELL route (``MSBFS_BACKEND=bell``, W = 16) through the
   CLI, and the low-K route on the first four groups, each a path;
   the 64 F values are equal across the kernel and plain engines of the
   three routes, the CLIs report the same winner and F, the winner and
   the first eight groups (the low-K route's four among them) equal
   scipy's; then the low-K BFS a level at a time as on RMAT-16, at K = 4
   and at K = 1 (the apply's time on its widest K = 1 level beside its
   bound at 4 and at 1 byte a vertex), the bell BFS (K = 64) the same way,
   both byte routes split by launch, and K5's pull at W = 16 on a
   synthetic plane with nothing visited, beside bell_hits_packed;
6. road-1024 at K = 16 (BASELINE.md config 4): every F and the winner
   equal scipy's;
7. road-1024 at K = 300 through the sub-batch split (W = 8 and W = 2):
   kernel path equals plain path;
8. grid_edges(2048, 2048) with corner sources: the active-row window
   engages (some chunk runs on fewer rows than n) and its results equal
   the plain path's without the window;
9. resilience, on phase 5b's RMAT-20 files (run right after it, K = 64):
   a. ``MSBFS_BACKEND=streamed`` through the CLI (a path: batch_start,
      forest_map, forest_segment with its map instance, forest_gather,
      level_apply, and never forest_or or push_or), then with prefetch 1,
      and with STREAMED_BUDGET-slot segments at prefetch 1 and 2: the
      same winner and F as the bitbell path (scipy's), and every F of
      the host-streamed engine at both cuts and depths equal to the
      bitbell path's; the BFS a level at a
      time, the kernel pass at both cuts equal to the plain pass (every
      segment output and the hits) on every level; on every level, at
      both cuts, the map pre-pass, each segment launch (its plan's
      instance, beside nomap; at whole levels also with the map always
      and never read) and the final gather (beside index_select) held
      against their plain versions and timed beside their bounds, one
      "compare rmat-20 K=64 forest_segment (level i, ...)" line each and
      their sums over the BFS; forest_or on the densest frontier; a
      synthetic level-0 segment at n = 2^23, W = 2 (the gmap instance)
      at 0.1, 10, 50 and 90 % of rows; the pinned host-to-device rate,
      the bytes each level uploads and their transfer bound, and the
      level pass at prefetch 1 and 2;
   b. the ladder by injected faults (one, two and three oom:dispatch
      specs, the third with MSBFS_LEVEL_CHUNK=0): each reaches its rung
      with the winner and F of 9a, its recovery events printed;
   c. a real CUDA out-of-memory error: a child process measures the
      caching allocator's peaks of the default route and of the streamed
      rung, caps itself between them (set_per_process_memory_fraction)
      and runs ``cli.main``: the hybrid route must run out of memory in a
      supervised call, step down and answer right (no window: fail);
   d. checkpoint: ``python -m`` the port with MSBFS_CHECKPOINT in chunks
      of CHECKPOINT_CHUNK and ``crash:dispatch:3`` exits 137 with one
      chunk journaled; the rerun resumes to the uninterrupted answer;
   e. ``MSBFS_STATS=2`` on the bitbell route: per-query levels and
      reached equal scipy's on the winner and the first eight groups
      (scipy's rows from phase 5b, one BFS a group in the whole proof);
10. the single-device engines, each a CLI path whose engine's F vector
   equals the plain engine's on the card and whose winner, F and first
   eight groups' levels and reached equal scipy's: ``MSBFS_BACKEND=vmap``
   and ``packed`` on phase 5b's RMAT-20 files (K = 64; packed again with
   ``MSBFS_EDGE_CHUNKS=4``, to the same answer), each launching the CSR
   pull (K9, csr_pull) in its layout (pack on a stale level, walk and
   apply on every level), every BFS level timed, and on level 0 and on
   the BFS's widest level held against its planes plain version (every
   plane bit) and the JAX-shaped plain version, each phase timed beside
   both bounds and the torch composition of the JAX expansion;
   ``dense`` on phase 4's RMAT-14
   (no kernel of its own; its matmul's ms a level); ``push`` and
   ``ppush`` on phase 6's road-1024 (K = 16; not on phase 3's road-4096,
   where the plain push engine and scipy's eight groups took 105 s, so
   that the proof ends under 600 s), launching queue_expand and
   queue_compact (K10, K11), and push_or with queue_compact's row mode:
   the push engine's auto-capacity growth on road-1024 (K = 16, phase 6's
   groups) equals the plain engine's, an explicit capacity of
   SMALL_CAPACITY raises FrontierOverflow, and the
   kernels are held against their plain versions (every carry field, the
   tile flags too) on the widest level and on the thin one (the first
   whose compaction lists fewer than THIN_ENTRIES) and timed beside their
   bounds (and those of a walk of the padded table and of a pass over
   the whole hit plane) and library yardsticks (index_fill_; cumsum and
   scatter_); every level of one push
   and one ppush BFS has each kernel timed on its own, with the level's
   entries and touched tiles ("push levels", "ppush levels" lines; per
   level in chip_smoke_push_road1024_levels.json and
   chip_smoke_ppush_road1024_levels.json under --detail-dir);
11. the weighted route (``MSBFS_WEIGHTED=1``, K12 weighted_relax), each
   CLI run a path that launches weighted_relax and no other kernel:
   a. phase 5b's RMAT-20 files with uniform costs in [1, 16]
      (``edge_costs(m, "uniform", 16, seed + 3)``), K = 64, the auto
      (bitbell) flavor: the winner's distances and the first eight
      groups' equal scipy's multi-source Dijkstra; the engine's F and
      five counters equal a plain engine's (relax_plain) on the card; K12
      held bit for bit against relax_plain on the widest light pass and
      the widest heavy pass and timed beside its bound, its design's
      floor (the out runs of the slots of active rows) and
      ``scatter_reduce_("amin")`` of the same candidates, built in
      advance, along the vertex axis of the query-minor plane; the
      buckets, passes, host reads and K12's share of a run;
   b. road_edges(512, 512) with the same costs, K = 8 groups of up to 8:
      each flavor (bitbell, stencil, mesh2d) and ``MSBFS_DELTA=1``
      through the CLI, to the same winner and F, all eight F equal to
      scipy's; each flavor's F and counters equal its plain engine's;
      the bitbell flavor's K12 passes timed (per pass in
      chip_smoke_weighted_road512_passes.json), and K12 held and timed on
      its widest pass and its first thin one (under 1 % of the cells
      active);
   c. road_edges(128, 128), K = 8: ``MSBFS_AUDIT=full`` (checkpointed, so
      that every chunk's F is audited) exits 0 with the audit run; one
      ``bitflip:wplane`` on the first real chunk is caught and retried to
      the clean answer; a flip on every call exits 9; ``verify
      --weighted`` and ``verify`` on the weightless file exit 0;
      ``verify --expect-f`` with a wrong F exits 9;
12. the serving daemon (serve/, dynamic/), in this process on a unix
   socket under the temporary directory, on the card:
   a. a daemon with a journal and a 0.25 s coalescing window registers
      phase 5b's RMAT-20 file; its 64 groups come from four concurrent
      clients of 16 groups: one dispatch at k_exec = 64 (each response
      ``batched_with`` 3), F equal to phase 5b's and, on the winner, to
      scipy's; the counted path "serve rmat-20" (load and the four
      queries) must launch the bitbell route's kernels; a repeat is a
      result-cache hit, and a second bucket warms once;
   b. 64 sequential one-source queries in one warm bucket: p50 and p99
      from the ``stats`` verb (and the client's round trips), with the
      card's name and power limit on the same line;
   c. a weighted query on phase 11b's road-512 files equal to that
      phase's F (the counted path "serve weighted road-512":
      weighted_relax);
   e. a reload of RMAT-20: two engines resident during the swap, and
      ``torch.cuda.memory_allocated()`` back to one engine's size once the
      old entry is dropped and collected;
   f. the daemon stopped and restarted from its journal: ``health``
      ready, the same answer; then drained;
   d. on a second daemon with ``MSBFS_SERVE_PLANES=1``, road-512 without
      costs, three ``delta_batches(..., batch_size=16, locality=0.9)``
      mutations: each answer repaired on the host, equal to a freshly
      built engine's and scipy's on the mutated graph (its CSR equal to
      a replay of the deltas in NumPy alone, which both are built from);
      repair against recompute
      printed, with the repair's host ms;
13. the replicated fleet (serve/fleet.py, serve/router.py,
   serve/shards.py), after phase 8, on phase 5b's RMAT-20 files, phase
   6's road-1024 and phase 5a's RMAT-16:
   a. three of the port's daemons in this process on unix sockets behind
      the port's ``FleetRouter`` at replication 2: phase 5b's 64 groups
      (the counted path "fleet rmat-20": the bitbell route's kernels) and
      phase 6's 16 road-1024 groups (the counted path "fleet road-1024":
      stencil_sweep, level_apply, batch_start) to those phases' F; then
      at replication 3 with every answer voted: a vote that agrees, a
      ``bitflip:dist`` on the primary's supervisor outvoted and
      quarantined (the answer still phase 5b's), a ``net_drop`` on the
      primary's route failed over to the next owner;
   b. ``python -m <port> fleet`` as a child process (three replicas,
      replication 2, FLEET_SHARD_MAX_BYTES: RMAT-20's file is above it
      and served as shards with two copies each, road-1024 and RMAT-16
      whole): each replica process holds memory on the card (its own
      ``metrics`` verb's card-memory gauges, read on its own socket beside
      its ``health`` pid; the card's used memory up by at least their
      sum), its time from spawn to ready; through the
      front end with the port's client, road-1024 (K = 16) and RMAT-16
      (one source) equal to scipy's F, and the first FLEET_SHARD_GROUPS
      groups of RMAT-20 by the router's level-synchronous scatter equal
      to phase 5b's F, with its levels and the largest fragment frame (its
      vertex ids, and the bytes they bound) held against the frame bound; the
      ``metrics`` and ``trace`` verbs; then a second fleet under
      ``MSBFS_FAULTS=replica_kill:replica<i>:<n>`` on road-1024's primary
      owner while FLEET_CLIENTS threads query road-1024: no acknowledged
      query lost or failed, the longest request beside the deadline, the
      victim restarted from its journal, every graph and shard back at
      two live owners; each fleet drained and stopped: the fleet exits 0
      and every replica process exits within FLEET_EXIT_S, checked before
      anything left is killed;
14. the port's tooling, after phase 13 (every phase prints the seconds
   since the script started as it begins, "elapsed: ..." lines):
   a. ``python -m <port>.gen_cli`` as a child: RMAT-20 (edge factor 16,
      64 groups of at most 128) with ``MSBFS_NATIVE_RMAT=1`` and with the
      NumPy stream, each child's host time printed; the NumPy graph's
      digest equal to phase 5b's file (rmat_edges(20, 16) through
      save_graph_bin), the native graph a valid RMAT-20 file of another
      stream (its bytes at 1 and 8 threads are held against the JAX
      package's sampler in the CPU tests);
   b. phase 6's road-1024 written by save_dimacs_gr and RMAT-16 written
      as a SNAP edge list, each converted by ``gen_cli --convert`` in this
      process (the native parser) and timed against the Python parser on
      the same file (the same edges); the port's CLI on each converted
      graph (the counted paths "tooling road-1024", stencil, profiled
      below, and "tooling rmat-16", bitbell): the winner and F equal
      scipy's (road-1024's 16 groups are phase 6's);
   c. ``MSBFS_PROFILE_DIR`` on "tooling road-1024" and on gen_cli's
      RMAT-20 K = 64 ("tooling rmat-20", bitbell), each ``python -m
      <port>`` in a child process as a user takes a trace: the report's
      7 lines keep their form (every CLI run of the script checks it),
      the trace file exists, each kernel the span launched (the trace's
      ``msbfs_launches``, the child's counters, which count as the
      path's launches) is named by as many CUDA kernel events as it has
      launches (forest_or: its gather; its level kernels a whole
      multiple), no hand-written kernel's event is uncounted, and the
      device's busy share of the span is printed;
   d. ``python -m <port> analyze`` exits 0 on the committed tree (run
      beside a-c as a child);
15. the -gn > 1 routes (parallel/), after phase 14, on phase 5b's RMAT-20
   K = 64 files and phase 6's road-1024 K = 16 files, each a counted
   path of ``cli.main(argv, mesh_devices=[cuda:0] * 4)`` (a logical mesh
   of four entries on the card) with ``MSBFS_STATS`` set, whose F vector
   (its stats table; the CSR pull's from its engine) equals the
   single-device route's on the card and whose winner and checked groups
   equal scipy's: "mesh rmat-20" (DistributedEngine, -gn 4), "mesh csr
   rmat-20" (``MSBFS_BACKEND=csr``, K9), "vshard2 rmat-20" and "vshard4
   rmat-20" (ShardedBellEngine at ``MSBFS_VSHARD=2`` with the JAX
   package's TPU auto halo and push budgets, and at ``=4`` with the halo
   budget and no push: both halo routes taken, the ``MSBFS_STATS=2``
   halo table's route counts printed), "reshard rmat-20" (a
   ``chip:rank1:1`` loss resharded onto three shards, the flight ring's
   reshard record), "vshard4 road-1024" (ShardedPushEngine) and "mesh
   push road-1024" (DistributedPushEngine); each path's CLI span beside
   the single-device span on the card, its halo bytes a level and its
   peak memory; then H1 ``halo_pair_or`` (the widest rebuild of the
   "vshard4 rmat-20" engine), H2's match ``halo_push_match`` and its push
   ``halo_push_or`` (the widest push of the "vshard2 rmat-20" engine,
   the match of that call and the widest match) and H3
   ``owner_push_expand`` (the
   widest level of the owner-partitioned push on road-1024, and its
   first level with fewer than 4,096 listed rows), each recorded call by
   call in an engine run of its own after the counted paths, held bit for
   bit against their plain versions on their recorded inputs and timed
   beside their bounds (H3's run also timing every launch alone: its sum
   over the run); distinct cards only where the machine has more than one
   (otherwise said so); the phase's seconds. ``--phases 15`` runs it
   alone on data of its own (the same seeds);
16. the 2D adjacency mesh (parallel/partition2d.py), after phase 15, each
   a counted path of ``MSBFS_MESH=2x2`` at ``-gn 4`` over the same logical
   mesh, F equal to the single-device route's on the card and winner and
   checked groups equal to scipy's: "mesh2d rmat-20" (defaults: halving
   tree, sparse wire), "mesh2d streamed rmat-20" (the tiles streamed
   through K1s), "mesh2d reshard rmat-20" (pipelined, a ``chip:rank1:1``
   loss rebuilt on the 1x2 survivor row), "mesh2d ring road-1024" (its
   sparse levels in the wire trace of an engine run of its own),
   "mesh2d async road-1024" (``MSBFS_ASYNC_LEVELS=4``: M4 with the
   final take in its launch, no forest_gather; M1 only on the exchanges'
   commits, one a shard a round, each writing the first wave's send; the
   local waves M4's commit form ``forest_max_commit``, and in the
   profiled first local waves of the engine run no device kernel but
   those and the flags' one read; fewer collective rounds than levels),
   "mesh2d byte rmat-16"
   (phase 5a's K = 1 on byte planes through flag_pull, one-shot tree)
   and "mesh2d mxu rmat-14" (phase 4's K = 64, tile_hits on the matmul
   levels); the road-1024 paths' H1, M1, M4 and forest_gather launches
   (every sparse gather one H1 launch of its segmented form); M1
   ``chunk_merge``, M2 ``wire_encode``, M4 ``forest_max`` (its take form;
   the same level without the take, and followed by forest_gather), M4's
   commit form (beside the parent's wave on the same inputs: the take, M1's
   commit and the send's torch ops) and
   H1's segmented form (beside one ``index_put_``) recorded call by call
   in the ring and async engine runs, held bit for bit against their
   plain versions and timed beside their bounds (M2's every launch of the
   ring run also timed alone: its sum); the phase's seconds.
   ``--phases 16`` runs it alone on data of its own (the same seeds);
then the ``{"kernels": [...]}`` line and the final ``{"ok": true, ...}``.
Phases 5b, 9, 11 and 13 print their steps' seconds ("... steps s:"
lines).

Each CLI run of phases 3-5b, 9a, 10, 11, 15 and 16, and each of phase 12's and
phase 13's two counted serving paths, is one path: the kernel launch counters are
zeroed just before it and read just after; each path must have launched
its route's kernels (batch_start at its route's stride), and every
registered kernel must have launched on some path, and no byte path may
launch forest_or or push_or.  The kernel line has a row for each kernel
(flag_pull's from the densest pull of RMAT-20's low-K BFS, its bound the
level's) and for K5's push (flag_pull:push: the merged launch on the
widest push level of that BFS), its launches the flag_pull launches with
the push folded in, counted over the byte paths.
Each path, and phases 7 and 8, also print the launches per kernel
variant; the mxu paths must have launched tile_hits' pipe variant, the
ELL path more steady than stale levels, and the byte paths flag_pull's
instance of their width (the bits instance at K = 1).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# Card peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W): 3.35 TB/s
# of HBM3, and 16.7e12 int32 operations/s — 64 INT32 lanes per SM x 132 SMs
# x 1.98 GHz, the same issue rate that gives the 67 TFLOP/s fp32 figure
# (128 fp32 lanes, a fused multiply-add counted as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
# Dense int8 tensor-core rate (the same data sheet).
INT8_TENSOR_OPS_PER_S = 1979e12
# Random 32-byte L2 sector reads: the rate ell_hits' gather reached on an
# H100 at 700 W (PERF.md), the yardstick of the forest's frontier reads.
L2_SECTOR_BYTES_PER_S = 4.0e12

PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
JAX_PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu"
# Each path's own kernels (a CLI run per path).
PATH_KERNELS = {
    "stencil road-4096": ("batch_start", "stencil_sweep", "level_apply"),
    "mxu rmat-14": ("batch_start", "tile_hits", "level_apply"),
    "mxu road-512": ("batch_start", "tile_hits", "push_or", "level_apply"),
    "lowk rmat-16": ("batch_start", "flag_pull", "level_apply"),
    "bitbell rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "ell rmat-20": ("ell_hits",),
    "bell rmat-20": ("batch_start", "flag_pull", "level_apply"),
    "lowk rmat-20": ("batch_start", "flag_pull", "level_apply"),
    "streamed rmat-20": ("batch_start", "forest_map", "forest_segment", "forest_gather",
                         "level_apply"),
    "vmap rmat-20": ("csr_pull",),
    "packed rmat-20": ("csr_pull",),
    "dense rmat-14": (),
    "push road-1024": ("queue_expand", "queue_compact"),
    "ppush road-1024": ("batch_start", "push_or", "queue_compact"),
    "weighted rmat-20": ("weighted_relax",),
    "weighted-bitbell road-512": ("weighted_relax",),
    "weighted-stencil road-512": ("weighted_relax",),
    "weighted-mesh2d road-512": ("weighted_relax",),
    "weighted delta=1 road-512": ("weighted_relax",),
    "serve rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "serve weighted road-512": ("weighted_relax",),
    "fleet rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "fleet road-1024": ("batch_start", "stencil_sweep", "level_apply"),
    "tooling road-1024": ("batch_start", "stencil_sweep", "level_apply"),
    "tooling rmat-16": ("batch_start", "forest_or", "level_apply"),
    "tooling rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "mesh rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "mesh csr rmat-20": ("csr_pull",),
    "vshard2 rmat-20": ("batch_start", "forest_or", "queue_compact", "halo_push_match",
                        "halo_push_or"),
    "vshard4 rmat-20": ("batch_start", "forest_or", "queue_compact", "halo_pair_or"),
    "reshard rmat-20": ("batch_start", "forest_or", "push_or", "level_apply"),
    "vshard4 road-1024": ("batch_start", "queue_compact", "owner_push_expand", "halo_pair_or"),
    "mesh push road-1024": ("queue_expand", "queue_compact"),
    "mesh2d rmat-20": ("batch_start", "forest_or", "wire_encode", "chunk_merge", "level_apply"),
    "mesh2d ring road-1024": ("batch_start", "forest_or", "wire_encode", "halo_pair_or",
                              "chunk_merge", "level_apply"),
    "mesh2d async road-1024": ("batch_start", "forest_max", "forest_max_commit", "wire_encode",
                               "halo_pair_or", "chunk_merge"),
    "mesh2d byte rmat-16": ("batch_start", "flag_pull", "wire_encode", "chunk_merge",
                            "level_apply"),
    "mesh2d mxu rmat-14": ("batch_start", "tile_hits", "chunk_merge", "level_apply"),
    "mesh2d streamed rmat-20": ("batch_start", "forest_map", "forest_segment", "forest_gather",
                                "chunk_merge", "level_apply"),
    "mesh2d reshard rmat-20": ("batch_start", "forest_or", "wire_encode", "chunk_merge",
                               "level_apply"),
}
# The paths whose planes are bytes: their batch starts at a stride of 8
# lanes, the others' at 1 (the ELL route packs no planes), and they pull
# with flag_pull, never with forest_or, and push (the low-K paths) inside
# flag_pull's first launch, never with push_or.
BYTE_PATHS = ("lowk rmat-16", "bell rmat-20", "lowk rmat-20", "mesh2d byte rmat-16")
# The paths whose batch start lists the sources for a direction switch.
SWITCHED_PATHS = ("mxu rmat-14", "mxu road-512", "lowk rmat-16", "bitbell rmat-20",
                  "lowk rmat-20", "tooling rmat-16", "tooling rmat-20", "mesh rmat-20",
                  "reshard rmat-20")
# Groups of the RMAT-20 paths checked against scipy (besides the winner).
SCIPY_GROUPS = 8
# Groups of RMAT-20's 64 that its low-K path runs (all checked against scipy).
LOWK_GROUPS = 4
# Each path's launches per kernel variant, as _run_path read them.
VARIANTS = {}
# The mxu paths' files, F vectors (equal to scipy's) and spans, for phase 16.
MXU_RUNS = {}
# The card (nvidia-smi name, power limit) and the host (CPUs, the native
# runtime's threads on a large pass), printed beside every host time.
CARD = None
HOST = None


class _Steps:
    """The seconds of a phase's steps, printed as one line at its end."""

    def __init__(self, phase):
        self.phase, self.t, self.rows = phase, time.perf_counter(), {}

    def __call__(self, name):
        now = time.perf_counter()
        self.rows[name] = round(now - self.t, 3)
        self.t = now

    def print(self):
        print(f"{self.phase} steps s: " + json.dumps(self.rows))


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, restore, reps=10, warm=2):
    """Median device time of one call of ``fn`` (CUDA events around the
    call alone; ``restore`` resets its in-place inputs between calls).
    A ~1 ms device sleep is queued before the first event, so the host
    has enqueued the call's launches before the device reaches them and
    the events measure the device, not the wrapper's host time (a call
    that reads the device back, as the plain versions do, still waits)."""
    times = []
    for i in range(warm + reps):
        restore()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= warm:
            times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def _max_abs_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def _words(torch, n, w, density, gen, dev, rows=None):
    """(n, w) random int32 words in a ``density`` share of the first
    ``rows`` rows (all rows when None), zero elsewhere."""
    x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32, device=dev,
                      generator=gen)
    keep = torch.rand((n, 1), device=dev, generator=gen) < density
    if rows is not None:
        keep[rows:] = False
    return torch.where(keep, x, 0)


def _sweep_bound(torch, frontier, n_offsets, residual_edges):
    """Bytes any sweep must move for this frontier: read it and write the
    hit plane (8W bytes a row), read the mask word of each row whose
    frontier is nonzero and the residual's two index arrays (8 bytes an
    edge); a few operations per offset and word, one per edge and word."""
    n, w = frontier.shape
    active_rows = int((frontier != 0).any(dim=1).sum())
    return _bound_ms(8 * n * w + 4 * active_rows + 8 * residual_edges,
                     n * w * n_offsets * 4 + residual_edges * w)


def _apply_bound(torch, hits, visited):
    """Bytes any level apply must move for these planes: read hits and
    write frontier (8W bytes a row), read visited where a hit word is
    nonzero and write it where something is new, and the per-query
    counters; two operations a word and 64 a new word (the popcount)."""
    n, w = hits.shape
    hit_words = int((hits != 0).sum())
    new_words = int(((hits & ~visited) != 0).sum())
    nbytes = 8 * n * w + 4 * hit_words + 4 * new_words + 32 * w * 40
    return _bound_ms(nbytes, 2 * n * w + 64 * new_words), hit_words, new_words


def _sweep_row(torch, frontier, mask_bits, offs, go, residual):
    """stencil_sweep with the residual edges against its plain version
    (the plain sweep, then the plain residual OR) on one frontier: the
    error, both times and the bound."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_stencil,
    )

    top = 2**31 - 1
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_stencil.stencil_sweep(frontier, mask_bits, offs, h_k, go, top, residual)
    cuda_stencil.stencil_sweep_plain(frontier, mask_bits, offs, h_p, go, top, residual)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep(
        frontier, mask_bits, offs, h_k, go, top, residual), lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep_plain(
        frontier, mask_bits, offs, h_p, go, top, residual), lambda: None, reps=3)
    # The same launch without the residual edges: what they add.
    no_residual_ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep(
        frontier, mask_bits, offs, h_k, go, top), lambda: None)
    edges = residual.count if residual is not None else 0
    bound, by = _sweep_bound(torch, frontier, len(offs), edges)
    n, w = frontier.shape
    vec16 = all(t.data_ptr() % 16 == 0 for t in (frontier, mask_bits, h_k))
    plan = cuda_stencil.sweep_plan(n, w, offs, vec16)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                no_residual_ms=no_residual_ms,
                variant=bitbell.plan_label(plan) + ("/res" if edges else ""),
                tile=plan.tile, smem_bytes=plan.smem_bytes, residual_edges=edges)


def _apply_row(torch, pristine, hits, switch=None, timed=True):
    """level_apply against its plain version on one carry and hit plane
    (each call on a fresh copy of ``pristine``): the error, both times
    and the bound.  ``switch`` = (count, row_limit, edge_limit): the
    switched apply, which lists the new frontier and decides the next
    direction; on a level ``pristine.ctrl[3]`` sent to the push it reads
    ``hits`` from the switch's plane and clears it (restored before each
    call).  Its control, state, worklist (as a set) and push plane are
    held against the plain epilogue's too."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")

    pushed = switch is not None and int(pristine.ctrl[3]) == bitbell.DIR_PUSH

    def fresh():
        c = bitbell.BitCarry(*(getattr(pristine, f).clone() for f in fields))
        if switch is not None:
            c.switch = bitbell.PushSwitch.new(*switch, hits.shape[1])
            if pushed:
                c.switch.hits.copy_(hits)
        return c

    def restore(c, h):
        for f in fields:
            getattr(c, f).copy_(getattr(pristine, f))
        if switch is not None:
            c.switch.state.zero_()
            if pushed:
                c.switch.hits.copy_(hits)

    c_k, c_p = fresh(), fresh()
    # A pushed level's pull plane is never read: an unwritten one.
    h_k, h_p = (torch.empty_like(hits), torch.empty_like(hits)) if pushed else (hits, hits)
    bitbell.bit_level_apply(c_k, h_k)
    bitbell.bit_level_apply_plain(c_p, h_p)
    torch.cuda.synchronize()
    pairs = [(getattr(c_k, f), getattr(c_p, f)) for f in fields]
    extra = {}
    if switch is not None:
        pairs.append((c_k.switch.hits, c_p.switch.hits))
        sk, sp = c_k.switch, c_p.switch
        length = int(sp.state[bitbell.SW_LISTED])
        whole = int(sp.state[bitbell.SW_ACTIVE_ROWS]) <= sp.capacity
        keep = [bitbell.SW_LISTED, bitbell.SW_ACTIVE_ROWS, bitbell.SW_ACTIVE_EDGES]
        pairs.append((sk.state[keep], sp.state[keep]))
        if whole:
            rows = sk.worklist[0, :length].long()
            deg = sk.count[rows].long()
            pairs += [(torch.sort(rows).values, sp.worklist[0, :length]),
                      (sk.worklist[1, :length], torch.cumsum(deg, 0) - deg),
                      (sk.state, sp.state)]
        extra = dict(pushed_level=pushed, direction=int(c_k.ctrl[3]), listed_rows=length,
                     active_rows=int(sp.state[bitbell.SW_ACTIVE_ROWS]),
                     active_edges=int(sp.state[bitbell.SW_ACTIVE_EDGES]),
                     list_whole=whole)
    err = _max_abs_err(torch, pairs)
    ms = plain_ms = None
    if timed:
        ms = _time_ms(torch, lambda: bitbell.bit_level_apply(c_k, h_k),
                      lambda: restore(c_k, h_k))
        plain_ms = _time_ms(torch, lambda: bitbell.bit_level_apply_plain(c_p, h_p),
                            lambda: restore(c_p, h_p), reps=3)
    (bound, by), hit_words, new_words = _apply_bound(torch, hits, pristine.visited)
    planes = (hits, c_k.visited, c_k.frontier)  # as the timed launches
    vec16 = all(t.data_ptr() % 16 == 0 for t in planes)
    plan = bitbell.apply_plan(hits.shape[1], vec16, switch is not None)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                variant=bitbell.plan_label(plan), hit_words=hit_words,
                new_words=new_words, **extra)


def _synthetic_carry(torch, n, w, gen, dev, rows=None):
    """A carry at level 7 with random visited (half the rows) and frontier
    (5%) planes and counters, and a hit plane with 30% nonzero rows."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    k = 32 * w
    frontier = _words(torch, n, w, 0.05, gen, dev, rows)
    visited = _words(torch, n, w, 0.5, gen, dev, rows)
    hits = _words(torch, n, w, 0.3, gen, dev, rows)
    carry = bitbell.BitCarry(
        visited=visited, frontier=frontier,
        f=torch.arange(k, dtype=torch.int64, device=dev) * 1000,
        levels=torch.full((k,), 3, dtype=torch.int32, device=dev),
        reached=torch.full((k,), 5, dtype=torch.int32, device=dev),
        counts=torch.zeros(k, dtype=torch.int32, device=dev),
        ctrl=torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev),
    )
    return carry, hits


def _compare_kernels(torch, sg, w, seed, label):
    """Each kernel of the stencil route against its plain version on one
    graph's shapes."""
    dev = sg.device
    n = sg.n
    gen = torch.Generator(device=dev).manual_seed(seed)
    pristine, hits0 = _synthetic_carry(torch, n, w, gen, dev)
    frontier = pristine.frontier
    go = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    out = {}

    # A: the masked-shift sweep with the residual edges in its launch.
    out["stencil_sweep"] = _sweep_row(torch, frontier, sg.mask_bits, sg.offsets, go,
                                      sg.residual)

    # C: the level apply with per-query counts.
    out["level_apply"] = _apply_row(torch, pristine, hits0)
    for name, row in out.items():
        print(f"compare {label} n={n} W={w} {name}: " + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _compare_apply(torch, n, rows, w, dev, seed, label, switch=None):
    """level_apply against its plain version at one route's plane shape
    (n rows, the first ``rows`` of them real vertices); with ``switch`` =
    (count, row_limit, edge_limit) also the switched apply on the same
    planes, as a pulled level and as a pushed one (what the switch
    epilogue adds, and what clearing the consumed hit words adds)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    pristine, hits = _synthetic_carry(torch, n, w, gen, dev, rows)
    row = _apply_row(torch, pristine, hits)
    print(f"compare {label} n={n} W={w} level_apply: " + json.dumps(row))
    assert row["max_abs_err"] == 0, (label, row)
    if switch is not None:
        for direction in (bitbell.DIR_PULL, bitbell.DIR_PUSH):
            pristine.ctrl[3] = direction
            sw = _apply_row(torch, pristine, hits, switch)
            print(f"compare {label} n={n} W={w} level_apply switched: " + json.dumps(sw))
            assert sw["max_abs_err"] == 0, (label, sw)
        pristine.ctrl[3] = 0
    return row


def _real_level(torch, sg, padded, depth, label):
    """The sweep and the apply on the planes of one real level: the
    kernel-path StencilEngine runs the BFS to its middle level, then each
    kernel is held against its plain version on that carry and timed
    beside the bound of that input.  Returns the carry at that level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, stencil,
    )

    eng = stencil.StencilEngine(sg, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.empty_like(carry.frontier)
    mid = depth // 2
    bitbell.bit_level_chunk(carry, lambda c: eng._step(c, 0, hits), mid)
    assert int(carry.ctrl[1]) == mid, (int(carry.ctrl[1]), mid)
    go = carry.ctrl.clone()
    row = {"stencil_sweep": _sweep_row(torch, carry.frontier, sg.mask_bits,
                                       sg.offsets, go, sg.residual)}
    # The level's whole hit plane (sweep + residual), as the engine builds it.
    stencil._expand_into(hits, carry.frontier, sg.mask_bits, sg, go, 2**31 - 1, False)
    row["level_apply"] = _apply_row(torch, carry, hits)
    n, w = carry.frontier.shape
    active = int((carry.frontier != 0).any(dim=1).sum())
    print(f"real level {label} level={mid} of {depth} n={n} W={w} "
          f"frontier_rows={active}: " + json.dumps(row))
    for name, r in row.items():
        assert r["max_abs_err"] == 0, (label, name, r)
    return carry


def _level_split(torch, sg, carry, levels, label):
    """One chunk of ``levels`` real levels from ``carry`` with CUDA events
    around every launch: device time of the sweep (its residual edges
    included) and the apply, and the gaps between launches; then the same
    chunk as the engine enqueues it, with one event pair around it."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_stencil, stencil,
    )

    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")

    def fresh():
        return bitbell.BitCarry(*(getattr(carry, f).clone() for f in fields))

    top = 2**31 - 1
    c = fresh()
    hits = torch.empty_like(c.frontier)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(levels)]
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    for e in ev:
        e[0].record()
        cuda_stencil.stencil_sweep(c.frontier, sg.mask_bits, sg.offsets, hits, c.ctrl, top,
                                   sg.residual)
        e[1].record()
        bitbell.bit_level_apply(c, hits, top)
        e[2].record()
    torch.cuda.synchronize()
    split = {"sweep": 0.0, "apply": 0.0, "gaps": 0.0}
    for i, e in enumerate(ev):
        split["sweep"] += e[0].elapsed_time(e[1])
        split["apply"] += e[1].elapsed_time(e[2])
        if i + 1 < levels:
            split["gaps"] += e[2].elapsed_time(ev[i + 1][0])
    span = ev[0][0].elapsed_time(ev[-1][2])
    eng = stencil.StencilEngine(sg, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    c2 = fresh()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    e0.record()
    for _ in range(levels):
        eng._step(c2, 0, hits)
    e1.record()
    e1.synchronize()
    assert torch.equal(c.f, c2.f) and torch.equal(c.ctrl, c2.ctrl)
    print(f"level split {label} from level {int(carry.ctrl[1])}: " + json.dumps(dict(
        levels=levels, ms_per_level={k: v / levels for k, v in split.items()},
        evented_span_ms=span, evented_ms_per_level=span / levels,
        engine_chunk_ms=e0.elapsed_time(e1),
        engine_ms_per_level=e0.elapsed_time(e1) / levels,
    )))


def _compare_mxu(torch, mg, w, seed, label):
    """tile_hits and push_or against their plain versions on one graph's
    tiles; the bf16 torch.bmm of the same tile products as tile_hits'
    library yardstick."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu, mxu,
    )

    dev = mg.device
    n, k = mg.n_pad, 32 * w
    gen = torch.Generator(device=dev).manual_seed(seed)

    def words(density):
        return _words(torch, n, w, density, gen, dev, mg.n)

    out = {}
    # K7: a dense frontier (a matmul level).
    frontier = words(0.3)
    mm = torch.tensor([1, 7, 0, bitbell.DIR_MATMUL], dtype=torch.int32, device=dev)
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm)
    cuda_mxu.tile_matmul_hits_plain(*tiles, frontier, h_p, mm)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm),
                  lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits_plain(
        *tiles, frontier, h_p, mm), lambda: None, reps=3)
    lhs = mg.tiles_bf16
    fr = bitbell.unpack_byte_planes(frontier).view(mg.ntr, mg.tile, k)
    rhs = fr[mg.tile_col.long()].to(torch.bfloat16)
    library_ms = _time_ms(torch, lambda: torch.bmm(lhs, rhs), lambda: None, reps=5)
    del rhs, fr
    t2 = mg.tile * mg.tile
    bound, by = _bound_ms(
        mg.nt * t2 + 4 * mg.nt + 4 * (mg.ntr + 1) + 8 * n * w,
        2 * mg.nt * t2 * k, INT8_TENSOR_OPS_PER_S,
    )
    plan = cuda_mxu.tile_plan(mg.ntr, mg.nt, mg.tile, w, frontier.data_ptr() % 16 == 0)
    out["tile_hits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=library_ms, variant=plan.label,
                            units=plan.units, smem_bytes=plan.smem_bytes)

    # K3: a thin frontier (about n / 64 rows, the auto switch), listed by
    # the plain switch epilogue under the mxu engine's push edge budget
    # (which sizes the push's grid as on the route).
    frontier = words(1 / 64)
    switch = bitbell.PushSwitch.new(mg.count, n, mxu.MxuEngine(mg).push_budget, w)
    push = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    bitbell.switch_record(switch, frontier, push)
    out["push_or"] = _push_row(torch, frontier, mg.start, mg.vals, switch, push)
    for name, row in out.items():
        print(f"compare {label} n_pad={n} T={mg.tile} nt={mg.nt} W={w} {name}: "
              + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _push_row(torch, frontier, start, vals, switch, ctrl, timed=True):
    """push_or against its plain version on one listed frontier (both into
    a zeroed hit plane): the error, both times, the bound, and the launch
    floor (the same launch gated off by ctrl[3] = pull); ``timed`` False:
    the error and the counts only."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    assert int(ctrl[3]) == bitbell.DIR_PUSH
    p_k, p_p = torch.zeros_like(frontier), torch.zeros_like(frontier)
    bitbell.sparse_hits_or(frontier, start, vals, p_k, ctrl, switch)
    bitbell.sparse_hits_or_plain(frontier, start, vals, p_p, ctrl, switch)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(p_k, p_p)])
    ms = plain_ms = floor_ms = None
    if timed:
        ms = _time_ms(torch, lambda: bitbell.sparse_hits_or(
            frontier, start, vals, p_k, ctrl, switch), p_k.zero_)
        plain_ms = _time_ms(torch, lambda: bitbell.sparse_hits_or_plain(
            frontier, start, vals, p_p, ctrl, switch), p_p.zero_, reps=3)
        pull = ctrl.clone()
        pull[3] = bitbell.DIR_PULL
        floor_ms = _time_ms(torch, lambda: bitbell.sparse_hits_or(
            frontier, start, vals, p_k, pull, switch), lambda: None)
    w = frontier.shape[1]
    listed = int(switch.state[bitbell.SW_LISTED])
    edges = int(switch.state[bitbell.SW_LISTED_EDGES])
    reached = int((p_p != 0).any(dim=1).sum())
    degrees = switch.count[switch.worklist[0, :listed].long()]
    # The worklist (8 bytes an entry), each listed row's words and CSR
    # start, its neighbours, and the hit words reached; an OR a word an edge.
    bound, by = _bound_ms(8 * listed + (4 * w + 4) * listed + 4 * edges + 4 * w * reached,
                          edges * w)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, floor_ms=floor_ms, listed_rows=listed, edges=edges,
                reached_rows=reached,
                max_degree=int(degrees.max()) if listed else 0)


def _compare_forest_ell(torch, bg, eg, k, seed, label):
    """forest_or and ell_hits against their plain versions at K queries
    (W = ceil(K / 32) words) on one graph's forest and ELL slab; the
    two-call torch expression of the ELL gather as ell_hits' library
    yardstick (torch has no OR reduction: forest_or has none)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_bfs,
    )

    dev = bg.device
    n, w = bg.n, -(-k // 32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # K1: a dense pull level, with a third of the vertices in the frontier.
    x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32, device=dev, generator=gen)
    frontier = torch.where(torch.rand((n, 1), device=dev, generator=gen) < 0.3, x, 0)
    out["forest_or"] = _forest_row(torch, bg, frontier)
    del frontier, x

    # K8: one level of the distance loop, every query at level 2 with
    # distances 0..3 spread over half the vertices.
    dist = torch.randint(0, 4, (k, n), dtype=torch.int32, device=dev, generator=gen)
    dist = torch.where(torch.rand((k, n), device=dev, generator=gen) < 0.5, dist, -1)
    pristine = bfs.DistCarry(
        dist=dist,
        level=torch.full((k,), 2, dtype=torch.int32, device=dev),
        updated=torch.ones(k, dtype=torch.int32, device=dev),
        stop=torch.full((k,), 3, dtype=torch.int32, device=dev),
        found=torch.zeros(k, dtype=torch.int32, device=dev),
        ctrl=torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=dev),
    )
    fields = ("dist", "level", "updated", "stop", "found", "ctrl")
    plane_fields = ("frontier", "visited", "hits", "aux")

    def fresh():
        return bfs.DistCarry(*(getattr(pristine, f).clone() for f in fields))

    def restore(c):
        for f in fields:
            getattr(c, f).copy_(getattr(pristine, f))
        c.touch()  # dist was rewritten: the next level is a stale one

    # Stale: the planes are rebuilt from dist, then the level runs.
    c_k, c_p = fresh(), fresh()
    cuda_bfs.ell_level(eg, c_k)
    cuda_bfs.ell_level_plain(eg, c_p)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(getattr(c_k, f), getattr(c_p, f)) for f in fields])
    ms = _time_ms(torch, lambda: cuda_bfs.ell_level(eg, c_k), lambda: restore(c_k))
    plain_ms = _time_ms(torch, lambda: cuda_bfs.ell_level_plain(eg, c_p),
                        lambda: restore(c_p), reps=3)
    pad_to = max(128, -(-(n + 1) // 128) * 128)
    flags = torch.zeros((k, pad_to), dtype=torch.int8, device=dev)
    flags[:, :n] = (dist == 2).to(torch.int8)
    cols = eg.cols.long()
    library_ms = _time_ms(torch, lambda: torch.amax(flags[:, cols], dim=1), lambda: None, reps=3)
    del flags, cols
    slots = eg.width * eg.num_vrows
    bound, by = _bound_ms(4 * slots + 4 * eg.num_vrows + 8 * k * n, slots * w + k * n)
    out["ell_hits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=library_ms, vrows=eg.num_vrows,
                           library="torch.amax(frontier[:, cols], dim=1), two calls")

    # Steady: the same level on carried planes (packed once, by the plain
    # pack), against the steady function's own plain version; dist is
    # written where a label is new and never read.
    planes0 = cuda_bfs.ell_planes(eg, c_p)
    restore(c_p)
    cuda_bfs.ell_pack_plain(c_p, planes0)
    snap = {f: getattr(planes0, f).clone() for f in plane_fields}

    def restore_steady(c):
        restore(c)
        planes = cuda_bfs.ell_planes(eg, c)
        for f in plane_fields:
            getattr(planes, f).copy_(snap[f])
        planes.valid = True

    restore_steady(c_k)
    restore_steady(c_p)
    cuda_bfs.ell_level(eg, c_k)
    cuda_bfs.ell_steady_plain(eg, c_p, c_p.planes)
    torch.cuda.synchronize()
    pairs = [(getattr(c_k, f), getattr(c_p, f)) for f in fields]
    pairs += [(getattr(c_k.planes, f), getattr(c_p.planes, f)) for f in plane_fields]
    err = _max_abs_err(torch, pairs)
    ms = _time_ms(torch, lambda: cuda_bfs.ell_level(eg, c_k), lambda: restore_steady(c_k))
    plain_ms = _time_ms(torch, lambda: cuda_bfs.ell_steady_plain(eg, c_p, c_p.planes),
                        lambda: restore_steady(c_p), reps=3)
    stats = _ell_gather_stats(torch, eg, snap["visited"], snap["aux"][:w])
    new_labels = int((c_p.dist != pristine.dist).sum())
    bound, by = _bound_ms(
        4 * eg.width * stats["live_rows"] + 4 * eg.num_vrows + 16 * n * w + 4 * new_labels,
        stats["live_slots"] * w + n * w,
    )
    # The steady level gathers the same dist == 2 frontier: its library
    # yardstick is the stale row's call.
    out["ell_hits steady"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms, library="torch.amax(frontier[:, cols], dim=1), two calls",
        new_labels=new_labels,
        gather_l2_floor_bytes=32 * stats["live_slots"], **stats)
    del c_p, c_k, snap, planes0
    for name, row in out.items():
        print(f"compare {label} n={n} K={k} W={w} {name}: " + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _forest_row(torch, bg, frontier):
    """forest_or against its plain version on one pull frontier: the
    error, both times, the byte bound and the L2 floor (one 32-byte sector
    per non-sentinel slot; the live slots, those whose source row is
    nonzero, are all that a design reading only nonzero rows would
    fetch)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_bell,
    )

    dev, (n, w) = frontier.device, frontier.shape
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=dev)
    scratch = cuda_bell.forest_scratch(bg, w, dev)
    h_k, h_p = torch.full_like(frontier, 7), torch.empty_like(frontier)
    cuda_bell.forest_or(frontier, bg, h_k, pull, scratch=scratch)
    cuda_bell.forest_or_plain(frontier, bg, h_p, pull)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_bell.forest_or(
        frontier, bg, h_k, pull, scratch=scratch), lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_bell.forest_or_plain(
        frontier, bg, h_p, pull), lambda: None, reps=3)
    slots = sum(int(f.numel()) for f in bg.level_cols)
    bound, by = _bound_ms(4 * slots + 4 * n + 8 * n * w, slots * w)
    live = torch.cat([(frontier != 0).any(dim=1), frontier.new_zeros(1, dtype=torch.bool)])
    cols0 = bg.level_cols[0].long()
    real0 = int((cols0 < n).sum())
    real = real0 + sum(
        int((f < size).sum()) for f, size in zip(bg.level_cols[1:], bg.level_sizes))
    live_slots = int(live[cols0].sum()) + real - real0
    del cols0
    vec16 = all(t.data_ptr() % 16 == 0 for t in (frontier, scratch, h_k))
    return dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, l2_floor_ms=32 * real / L2_SECTOR_BYTES_PER_S * 1e3,
        variant=cuda_bell.forest_plan(w, vec16).label, slots=slots, real_slots=real,
        live_slots=live_slots, frontier_rows=int(live.sum()),
        forest_levels=len(bg.level_sizes),
    )


def _bitbell_hybrid(torch, bg, padded, label):
    """The bitbell route's BFS a level at a time (:func:`_hybrid_levels`,
    forest_or held against its plain version and timed on each pull
    level, push_or on each push level), then its launch split."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_bell,
    )

    top = 2**31 - 1
    eng = bitbell.BitBellEngine(bg, level_chunk=128)
    queries = eng._pad_queries(padded)[0]
    carry = eng._init_carry(queries)
    w = carry.frontier.shape[1]
    scratch = cuda_bell.forest_scratch(bg, w, carry.frontier.device)
    slot_budget = eng._slot_budget_for(w)
    expand = bitbell.bitbell_expand(bg, slot_budget)
    start, _, vals = bg.sparse
    directions, rows = _hybrid_levels(
        torch, carry, lambda c, h: expand(c, h, top, scratch), start, vals,
        lambda fr: _forest_row(torch, bg, fr), label,
    )
    for row in rows:
        print(f"hybrid level {label}: " + json.dumps(row))
    assert {bitbell.DIR_PUSH, bitbell.DIR_PULL} <= set(directions), directions

    def push(c, h):
        bitbell.sparse_hits_or(c.frontier, start, vals, c.switch.hits, c.ctrl, c.switch, top)

    def pull(c, h):
        cuda_bell.forest_or(c.frontier, bg, h, c.ctrl, top, slot_budget, scratch)

    _hybrid_split(torch, lambda: eng._init_carry(queries), push, pull,
                  lambda c: eng._chunk(c, len(directions)), len(directions), label)
    return rows


def _mxu_hybrid(torch, mg, eng, padded, label):
    """The mxu route's BFS a level at a time (:func:`_hybrid_levels`:
    push_or and the switched apply held on every level, timed on every
    eighth and at each change of direction), the device's direction
    sequence held against ``level_direction_trace``, then its launch
    split."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu,
    )

    top = 2**31 - 1
    queries = eng._pad_queries(padded)[0]
    directions, rows = _hybrid_levels(
        torch, eng._init_carry(queries), lambda c, h: eng._expand(c, h, top),
        mg.start, mg.vals, None, label, every=8,
    )
    device = ["push" if d == bitbell.DIR_PUSH else "matmul" for d in directions]
    trace = [s["direction"] for s in eng.level_direction_trace(padded)]
    assert device == trace, (_runs(device), _runs(trace))
    path = _write_detail(label.replace(" ", "_"), rows)
    timed = [r for r in rows if r["timed"]]
    pushes = [r["push_or"] for r in rows if "push_or" in r]

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    print(f"hybrid levels {label}: " + json.dumps(dict(
        levels=len(rows), device_directions_equal_trace=True,
        push_levels=device.count("push"), apply_timed_levels=len(timed),
        push_or_ms_median=median([p["ms"] for p in pushes]),
        push_or_ms_max=max((p["ms"] for p in pushes), default=None),
        push_or_floor_ms_median=median([p["floor_ms"] for p in pushes]),
        push_or_plain_ms_median=median([p["plain_ms"] for p in pushes]),
        push_or_bound_ms_median=median([p["bound_ms"] for p in pushes]),
        push_listed_rows_max=max((p["listed_rows"] for p in pushes), default=0),
        apply_switched_ms_median=median([r["level_apply"]["ms"] for r in timed]),
        apply_unswitched_ms_median=median([r["unswitched_apply_ms"] for r in timed]),
        detail=path,
    )))
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)

    def push(c, h):
        bitbell.sparse_hits_or(c.frontier, mg.start, mg.vals, c.switch.hits, c.ctrl,
                               c.switch, top)

    def pull(c, h):
        cuda_mxu.tile_matmul_hits(*tiles, c.frontier, h, c.ctrl, top)

    _hybrid_split(torch, lambda: eng._init_carry(queries), push, pull,
                  lambda c: eng._chunk(c, len(rows), torch.empty_like(c.frontier)),
                  len(rows), label)
    return rows


def _switch_snapshot(torch, switch):
    """A copy of a switch state (its worklist and state words)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    return bitbell.PushSwitch(switch.count, switch.row_limit, switch.edge_limit,
                              switch.worklist.clone(), switch.state.clone(),
                              switch.hits)


def _hybrid_levels(torch, carry, expand, start, vals, pull_row, label, every=1):
    """One BFS of a direction-switched route driven a level at a time from
    ``carry`` (``expand(carry, hits)`` then the apply, as a chunk enqueues
    them).  Before each level, ctrl[3] is the direction the level takes;
    on a push level push_or is held against its plain version on that
    level's list and timed, on a pull level ``pull_row(frontier)`` runs
    (None: not held here), and on every level the switched apply is held
    against its plain version and timed beside the same launch without
    the switch (on the same hits; the push's plane is zero after every
    level).  The apply is timed on every ``every``-th level and each level
    whose direction differs from the one before, held only on the others.
    Returns the directions and one row per level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    sw = carry.switch
    limits = (sw.count, sw.row_limit, sw.edge_limit)
    hits = torch.zeros_like(carry.frontier)
    directions, rows = [], []
    while bitbell.level_go(carry.ctrl, 2**31 - 1):
        level = int(carry.ctrl[1]) + 1
        d = int(carry.ctrl[3])
        timed = (level - 1) % every == 0 or (directions and directions[-1] != d)
        directions.append(d)
        row = dict(level=level, direction="push" if d == bitbell.DIR_PUSH else "pull",
                   timed=bool(timed))
        if d == bitbell.DIR_PUSH:
            row["push_or"] = _push_row(torch, carry.frontier, start, vals,
                                       _switch_snapshot(torch, sw), carry.ctrl.clone())
            assert row["push_or"]["max_abs_err"] == 0, (label, level, row)
        elif pull_row is not None:
            row["pull"] = pull_row(carry.frontier)
            assert row["pull"]["max_abs_err"] == 0, (label, level, row)
        expand(carry, hits)
        level_hits = sw.hits.clone() if d == bitbell.DIR_PUSH else hits
        pristine = bitbell.BitCarry(carry.visited, carry.frontier, carry.f, carry.levels,
                                    carry.reached, carry.counts, carry.ctrl)
        row["level_apply"] = _apply_row(torch, pristine, level_hits, limits, timed)
        if timed:
            row["unswitched_apply_ms"] = _apply_row(torch, pristine, level_hits)["ms"]
        assert row["level_apply"]["max_abs_err"] == 0, (label, level, row)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(sw.hits.any()), (label, level, "push plane not cleared")
        rows.append(row)
        assert level <= carry.frontier.shape[0], "the level loop did not stop"
    return directions, rows


def _hybrid_split(torch, make_carry, push, pull, chunk, levels, label):
    """A whole BFS of a direction-switched route (``levels`` levels) with
    CUDA events around each launch of each level — ``push(carry, hits)``
    (into the switch's plane), ``pull(carry, hits)``, the apply; with
    ``push`` None, ``pull`` is the level's one expansion call ("expand")
    — and the gaps between them, all
    enqueued before one synchronise, as a chunk enqueues them; then the
    engine's own ``chunk(carry)`` timed with one event pair, and traced
    with torch.profiler for the device's busy share: the kernels' summed
    device time over that chunk's time (the device is idle when the
    chunk starts, so the pair spans the host's enqueue of it)."""
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    top = 2**31 - 1
    c = make_carry()
    hits = torch.zeros_like(c.frontier)
    steps = [("push_or", push), ("pull", pull)] if push is not None else [("expand", pull)]
    steps.append(("level_apply", lambda c_, h: bitbell.bit_level_apply(c_, h, top)))
    names = tuple(name for name, _ in steps)
    last = len(steps)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(last + 1)]
          for _ in range(levels)]
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    for e in ev:
        e[0].record()
        for j, (_, fn) in enumerate(steps):
            fn(c, hits)
            e[j + 1].record()
    torch.cuda.synchronize()
    assert not bitbell.level_go(c.ctrl, top), "the split did not reach convergence"
    per_level = []
    for i, e in enumerate(ev):
        t = {name: e[j].elapsed_time(e[j + 1]) for j, name in enumerate(names)}
        t["gap_after"] = e[last].elapsed_time(ev[i + 1][0]) if i + 1 < levels else 0.0
        per_level.append(t)
    totals = {k: sum(t[k] for t in per_level) for k in (*names, "gap_after")}
    span = ev[0][0].elapsed_time(ev[-1][last])
    # The engine's own chunk: one event pair, then under the profiler.
    c2 = make_carry()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    chunk(c2)
    e1.record()
    e1.synchronize()
    assert torch.equal(c.f, c2.f) and torch.equal(c.ctrl[:2], c2.ctrl[:2])
    chunk_ms = e0.elapsed_time(e1)
    # Two traced chunks, the one with more device events kept: a trace can
    # miss a chunk's first launches.
    best = None
    for _ in range(2):
        c3 = make_carry()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chunk(c3)
            torch.cuda.synchronize()
        seen, kernel_us, busy_us, first, last = {}, {}, 0.0, None, None
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            rng_ = evt.time_range
            busy_us += rng_.elapsed_us()
            first = rng_.start if first is None else min(first, rng_.start)
            last = rng_.end if last is None else max(last, rng_.end)
            name = evt.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1] or evt.name[:40]
            seen[name] = seen.get(name, 0) + 1
            kernel_us[name] = kernel_us.get(name, 0.0) + rng_.elapsed_us()
        if best is None or sum(seen.values()) > sum(best[0].values()):
            best = (seen, kernel_us, busy_us, first, last)
    seen, kernel_us, busy_us, first, last = best
    if seen:
        busy = dict(source="torch.profiler", busy_ms=busy_us / 1e3, chunk_ms=chunk_ms,
                    busy_share=busy_us / 1e3 / chunk_ms,
                    device_span_ms=(last - first) / 1e3, kernels=seen,
                    kernel_ms={k: v / 1e3 for k, v in kernel_us.items()})
    else:  # no device activity in either trace: the events of the split
        busy = dict(source="cuda events", busy_ms=sum(totals[k] for k in names),
                    chunk_ms=span, busy_share=sum(totals[k] for k in names) / span)
    per_level = [{k: round(v, 5) for k, v in t.items()} for t in per_level]
    print(f"hybrid split {label}: " + json.dumps(dict(
        levels=levels, ms_total=totals,
        ms_per_level={k: v / levels for k, v in totals.items()},
        evented_span_ms=span, engine_chunk_ms=chunk_ms,
        engine_ms_per_level=chunk_ms / levels, busy=busy,
        per_level=per_level if levels <= 16 else _write_detail(
            "split_" + label.replace(" ", "_"), per_level),
    )))
    return busy


def _wrapper_host_us(torch, fn, reps=500):
    """Host time of one call of a kernel wrapper ``fn`` whose launches are
    gated off on the device (so the device never holds the host back):
    its checks, plan, ctypes call and the launches themselves."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _host_dispatch_us(torch, dev):
    """Host time to enqueue one small torch op on the card (a compare on a
    1,024-element tensor), the unit the old switch chain paid nine of a
    level."""
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    for _ in range(200):
        x.ne(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.ne(0)
    us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return us


# Where per-level rows too long for the output go (--detail-dir).
DETAIL_DIR = "build/chip_smoke"


def _write_detail(name, rows):
    """Per-level rows too long for the output, as JSON under DETAIL_DIR."""
    os.makedirs(DETAIL_DIR, exist_ok=True)
    path = os.path.join(DETAIL_DIR, f"chip_smoke_{name}.json")
    with open(path, "w") as fh:
        json.dump(rows, fh)
    return path


def _ell_gather_stats(torch, eg, visited, mask):
    """What the ELL gather must touch for these planes: the virtual rows
    whose owner some running query has not reached (the others it skips)
    and their non-sentinel slots."""
    n = eg.n
    live = ((~visited & mask) != 0).any(dim=1)
    live = torch.cat([live, live.new_zeros(1)])  # the sentinel owner n
    rows = live[eg.vrow_vertex.long()]
    owned = int((eg.vrow_vertex < n).sum())
    live_rows = int(rows.sum())
    live_slots = int((eg.cols[:, rows] < n).sum())
    return dict(owned_rows=owned, live_rows=live_rows, skipped_rows=owned - live_rows,
                live_slots=live_slots)


def _ell_level_split(torch, eg, padded, label):
    """The ELL route's real levels for one batch, with CUDA events around
    each launch of each level (pack on the first, stale, level; gather;
    apply), the rows the gather skipped and the labels the apply wrote."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, bitbell, cuda_bfs, engine,
    )

    dev = eg.device
    carry = bfs.distance_carry_init(eg.n, padded, eg.n_pad, dev)
    bfs.arm_chunk(carry, None, None)
    w = -(-carry.dist.shape[0] // 32)
    phases = (("pack", cuda_bfs.PHASE_PACK), ("gather", cuda_bfs.PHASE_GATHER),
              ("apply", cuda_bfs.PHASE_APPLY))
    levels = []
    while int(carry.ctrl[0]):
        row = {}
        for name, bit in phases:
            if name == "pack" and levels:
                continue  # the planes are carried from here on
            if name == "gather":
                planes = carry.planes
                row.update(_ell_gather_stats(torch, eg, planes.visited, planes.aux[:w]))
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            e0.record()
            cuda_bfs.ell_level(eg, carry, phases=bit)
            e1.record()
            e1.synchronize()
            row[f"{name}_ms"] = e0.elapsed_time(e1)
        row["new_labels"] = int(bitbell.unpack_counts(carry.planes.frontier).sum())
        levels.append(row)
        assert len(levels) <= eg.n, "the level loop did not stop"
    want = engine.Engine(eg, level_chunk=128).f_values(padded)
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.objective import (
        f_of_u,
    )
    assert torch.equal(f_of_u(carry.dist), want)
    print(f"ell level split {label}: " + json.dumps(dict(
        levels=len(levels), per_level=levels,
        total_ms={k: sum(r.get(k, 0.0) for r in levels)
                  for k in ("pack_ms", "gather_ms", "apply_ms")},
    )))


def _host_ms(torch, fn, reps=5):
    """Median host-clock time of ``fn`` up to a synchronise after it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _op_name(name: str) -> str:
    """A profiler event's name without its template and argument lists."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]


def _device_ops(torch, fn, reps=10):
    """``fn``'s device operations as torch.profiler traces ``reps`` calls
    after a warm one: ({name: median ms}, operations a call), or ({},
    None) when three traces saw no device activity.  A trace can miss its
    first device events, so a device sleep opens it and only the events
    after the sleep are counted (all of them when the trace missed the
    sleep too)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that sees no device activity is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
    opened = [e.time_range.end for e in events if _op_name(e.name) == "spin_kernel"]
    times = {}
    for evt in events:
        name = _op_name(evt.name)
        if name != "spin_kernel" and (not opened or evt.time_range.start >= opened[0]):
            times.setdefault(name, []).append(evt.time_range.elapsed_us() / 1e3)
    if not times:
        return {}, None
    ops = sum(len(v) for v in times.values()) / reps
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}, ops


def _blocking_reads(torch, fn) -> int:
    """The synchronizing CUDA operations one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(1 for w in caught if "called a synchronizing" in str(w.message))


@contextlib.contextmanager
def _no_sync(torch):
    """A block in which any synchronizing CUDA operation raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _batch_start_err(torch, got, want) -> int:
    """Every carry field and the switch state and hit plane of two batch
    starts; the worklist as a set, with each entry's offset the exclusive
    prefix of the out-degrees before it, when the list is whole (a
    mismatch counts 1)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")
    pairs = [(getattr(got, f), getattr(want, f)) for f in fields]
    if want.switch is None:
        return _max_abs_err(torch, pairs) + int(got.switch is not None)
    gs, ws = got.switch, want.switch
    err = _max_abs_err(torch, pairs + [(gs.state, ws.state), (gs.hits, ws.hits)])
    if int(ws.state[bitbell.SW_ACTIVE_ROWS]) <= gs.capacity:
        length = int(ws.state[bitbell.SW_LISTED])
        rows = gs.worklist[0, :length].long()
        deg = gs.count[rows].long()
        same = torch.equal(torch.sort(rows).values, ws.worklist[0, :length].long()) and \
            torch.equal(gs.worklist[1, :length].long(), torch.cumsum(deg, 0) - deg)
        err = max(err, int(not same))
    return err


# Each route's batch_start row (_batch_start_check), by path.
BATCH_ROWS = {}
# The low-K expansion wrappers' host times (_wrapper_row), by BFS.
WRAPPER_ROWS = {}


def _batch_start_check(torch, eng, n, padded, label):
    """The batch-start kernel (K4, csrc/batch_start.cu) on one route's
    batch as its engine pads it (stride 1 for bit planes, 8 for byte
    planes), against the plain batch start on the card (the engine with
    ``plain`` set: pack_sources_plain, bit_level_init, switch_record):
    every carry field and the switch state bit for bit, the worklist as a
    set when whole; the kernel's device ms (torch.profiler; CUDA events
    around the whole batch start when the trace sees nothing) beside its
    bound, the memset's and the upload's, the device operations and the
    blocking reads of a whole batch start and its host ms, each beside
    the plain batch start's.  A batch start must make no blocking read
    and at most three device operations."""
    import copy

    queries = eng._pad_queries(padded)[0]
    twin = copy.copy(eng)
    twin.plain = True
    got, want = eng._init_carry(queries), twin._init_carry(queries)
    torch.cuda.synchronize()
    err = _batch_start_err(torch, got, want)
    k, s = queries.shape
    rows, w = want.frontier.shape
    ops, n_ops = _device_ops(torch, lambda: eng._init_carry(queries))
    _, plain_ops = _device_ops(torch, lambda: twin._init_carry(queries), reps=3)
    events_ms = _time_ms(torch, lambda: eng._init_carry(queries), lambda: None)
    kernel_ms = ops.get("batch_start_kernel")
    valid = int(((queries >= 0) & (queries < n)).sum())
    touched = int((want.frontier != 0).sum())
    listed = 0 if want.switch is None else int(want.switch.state[0])
    # The queries read once; the words the sources set in both planes, the
    # levels and reached lanes, ctrl and, with a switch, its state and the
    # list entries written once; an atomic a valid source.
    nbytes = 4 * k * s + 2 * 4 * touched + 2 * 4 * 32 * w + 16
    if want.switch is not None:
        nbytes += 64 + 8 * listed
    bound, by = _bound_ms(nbytes, valid)
    row = dict(
        max_abs_err=err, ms=kernel_ms if kernel_ms is not None else events_ms,
        ms_source="torch.profiler" if kernel_ms is not None else "cuda events (whole start)",
        plain_ms=_time_ms(torch, lambda: twin._init_carry(queries), lambda: None, reps=3),
        bound_ms=bound, bound_by=by, library_ms=None,
        memset_ms=sum(v for k_, v in ops.items() if k_.startswith("Memset")),
        upload_ms=sum(v for k_, v in ops.items() if k_.startswith("Memcpy")),
        events_ms=events_ms, device_ops=n_ops, plain_device_ops=plain_ops,
        host_ms=_host_ms(torch, lambda: eng._init_carry(queries)),
        plain_host_ms=_host_ms(torch, lambda: twin._init_carry(queries)),
        blocking_reads=_blocking_reads(torch, lambda: eng._init_carry(queries)),
        plain_blocking_reads=_blocking_reads(torch, lambda: twin._init_carry(queries)),
        K=k, S=s, lane_stride=getattr(eng, "lane_stride", 1), rows=rows, W=w,
        switch=want.switch is not None, valid_sources=valid,
        distinct_sources=int(want.reached.sum()), words_set=touched, listed=listed,
        card=CARD,
    )
    print(f"compare {label} n={n} batch_start: " + json.dumps(row))
    assert err == 0, (label, row)
    assert row["blocking_reads"] == 0, (label, row)
    assert n_ops is None or n_ops <= 3, (label, ops)
    BATCH_ROWS[label] = row
    return row


def _byte_forest_row(torch, bg, frontier, scratch, library):
    """forest_or over a byte plane's word view (bell_hits_packed) against
    the byte pull's plain version (amax over bytes) on one pull frontier:
    the error, both times, the bound, and the library call
    ``hits.index_reduce_(0, owner, frontier[neighbour], "amax")`` over the
    dedup CSR (``library`` = (owner, neighbour) int64 tensors, or None)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell,
    )

    dev, (n, kp) = frontier.device, frontier.shape
    w = kp // 4
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=dev)
    h_k, h_p = torch.full_like(frontier, 7), torch.empty_like(frontier)
    bell.bell_hits_packed(frontier, bg, h_k, pull, scratch=scratch)
    bell.bell_hits_packed_plain(frontier, bg, h_p, pull)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: bell.bell_hits_packed(frontier, bg, h_k, pull, scratch=scratch),
                  lambda: None)
    plain_ms = _time_ms(torch, lambda: bell.bell_hits_packed_plain(frontier, bg, h_p, pull),
                        lambda: None, reps=3)
    library_ms = None
    if library is not None:
        owner, nbr = library
        lib = torch.zeros_like(frontier)
        library_ms = _time_ms(torch, lambda: lib.index_reduce_(0, owner, frontier[nbr], "amax"),
                              lib.zero_, reps=3)
        assert torch.equal(lib, h_p), "the library yardstick computes another function"
        del lib
    slots = sum(int(f.numel()) for f in bg.level_cols)
    # cols (4 bytes a slot), final_slot, the frontier read and the hits
    # written once (Kp bytes a row each); an OR a word a slot.
    bound, by = _bound_ms(4 * slots + 4 * n + 2 * n * kp, slots * w)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, Kp=kp, W=w,
                frontier_rows=int((frontier != 0).any(dim=1).sum()))


def _csr_pairs(torch, bg):
    """(owner, neighbour) int64 of every dedup CSR edge: the library
    yardstick's indices."""
    _, count, vals = bg.sparse
    owner = torch.repeat_interleave(
        torch.arange(bg.n, device=count.device), count.long())
    return owner, vals.long()


def _gated_carry(torch, carry, switch=None, go=True):
    """A carry on ``carry``'s planes and counters with a copy of its
    control (gated off unless ``go``) and ``switch`` (default its own)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    ctrl = carry.ctrl.clone()
    if not go:
        ctrl[0] = 0
    return bitbell.BitCarry(carry.visited, carry.frontier, carry.f, carry.levels, carry.reached,
                            carry.counts, ctrl, carry.switch if switch is None else switch,
                            carry.k)


def _byte_push_row(torch, bg, carry, scratch):
    """K5's push as the low-K level runs it — the byte expansion's call
    (flag_pull) with the push folded into its first launch — on one push
    level, into a zeroed plane, against the byte push's plain version:
    the error; the first launch's device ms (torch.profiler; the push's
    walk) and the whole call's (CUDA events), its device operations; the
    parent's push launch (push_or over the word view, sparse_hits_flags);
    the call gated off (its floor); the library call
    ``hits.index_reduce_(0, neighbour, frontier[owner], "amax")`` over the
    listed rows' edges; the bound."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_flag_pull, lowk,
    )

    top = 2**31 - 1
    u8 = torch.uint8
    assert int(carry.ctrl[3]) == bitbell.DIR_PUSH
    sw = _switch_snapshot(torch, carry.switch)
    frontier = carry.frontier.view(u8)
    n, kp = frontier.shape
    p_k, p_p, p_o = (torch.zeros_like(frontier) for _ in range(3))
    sw_k = bitbell.PushSwitch(sw.count, sw.row_limit, sw.edge_limit, sw.worklist, sw.state,
                              p_k.view(torch.int32))
    pull_hits = torch.empty_like(frontier)

    def call(go=True):
        c = _gated_carry(torch, carry, sw_k, go)
        return cuda_flag_pull.FlagPullCall(c.frontier.view(u8), c.visited.view(u8), bg, pull_hits,
                                           c.ctrl, c.k, top, scratch, c.levels, sw_k)

    merged = call()
    merged()
    lowk.sparse_hits_flags_plain(frontier, bg, p_p, carry.ctrl, sw)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(p_k, p_p)])
    listed = int(sw.state[bitbell.SW_LISTED])
    edges = int(sw.state[bitbell.SW_LISTED_EDGES])
    ops, n_ops = _device_ops(torch, merged)
    call_ms = _time_ms(torch, merged, p_k.zero_)
    parent_ms = _time_ms(torch, lambda: lowk.sparse_hits_flags(
        frontier, bg, p_o, carry.ctrl, sw), p_o.zero_)
    plain_ms = _time_ms(torch, lambda: lowk.sparse_hits_flags_plain(
        frontier, bg, p_p, carry.ctrl, sw), p_p.zero_, reps=3)
    floor_ms = _time_ms(torch, call(go=False), lambda: None)
    owner, nbr = bitbell.listed_edges(sw, bg.sparse[0], bg.sparse[2])
    lib = torch.zeros_like(frontier)
    library_ms = _time_ms(torch, lambda: lib.index_reduce_(0, nbr, frontier[owner], "amax"),
                          lib.zero_, reps=5)
    assert torch.equal(lib, p_p), "the library yardstick computes another function"
    assert torch.equal(p_o, p_p), "the parent's push computes another function"
    reached = int((p_p != 0).any(dim=1).sum())
    # The worklist (8 bytes an entry), each listed row's Kp bytes and CSR
    # start, its neighbours (4 bytes an edge), the rows reached (Kp bytes);
    # an OR a word an edge.
    bound, by = _bound_ms(8 * listed + (kp + 4) * listed + 4 * edges + kp * reached,
                          edges * (kp // 4))
    first_ms = ops.get("flag_first_kernel")
    return dict(max_abs_err=err, ms=first_ms if first_ms is not None else call_ms,
                ms_source="torch.profiler" if first_ms is not None else "cuda events (call)",
                call_ms=call_ms, call_device_ops=n_ops, call_kernel_ms=ops,
                parent_push_or_ms=parent_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, floor_ms=floor_ms, listed_rows=listed, edges=edges,
                reached_rows=reached, Kp=kp, variant=merged.variant)


def _expand_row(torch, bg, carry, hits, scratch):
    """One low-K level's expansion as the level runs it (one flag_pull
    call, the push in its first launch) beside the parent's two calls
    (push_or over the word view, then the pull alone), on the same carry:
    each one's launches (the wrapper counts), device operations and
    device ms per kernel (torch.profiler) and device ms (CUDA events)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull, lowk,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        timing,
    )

    top = 2**31 - 1
    u8 = torch.uint8
    sw = carry.switch

    def new():
        lowk.flag_expand(carry, bg, hits, top, scratch)

    def parent():
        lowk.sparse_hits_flags(carry.frontier.view(u8), bg, sw.hits.view(u8), carry.ctrl, sw,
                               top)
        cuda_flag_pull.flag_pull(carry.frontier.view(u8), carry.visited.view(u8), bg,
                                 hits.view(u8), carry.ctrl, carry.k, top, scratch, carry.levels)

    row = {}
    for name, fn in (("expand", new), ("parent", parent)):
        timing.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = timing.launch_counts()
        ops, n_ops = _device_ops(torch, fn, reps=5)
        row[name] = dict(launches=launches, device_ops=n_ops, kernel_ms=ops,
                         ms=_time_ms(torch, fn, lambda: None))
    return row


def _wrapper_row(torch, bg, carry, scratch):
    """The host time of one low-K level's expansion wrappers, their
    launches gated off on the device: the stepper's call (checked once,
    then launched), the same call checked on every call (flag_expand),
    and the parent's two wrappers (sparse_hits_flags, then flag_pull)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull, lowk,
    )

    top = 2**31 - 1
    u8 = torch.uint8
    off = _gated_carry(torch, carry, go=False)
    sw = off.switch
    hits = torch.empty_like(off.frontier)
    bound = cuda_flag_pull.FlagPullCall(off.frontier.view(u8), off.visited.view(u8), bg,
                                        hits.view(u8), off.ctrl, off.k, top, scratch,
                                        off.levels, sw)

    def parent():
        lowk.sparse_hits_flags(off.frontier.view(u8), bg, sw.hits.view(u8), off.ctrl, sw, top)
        cuda_flag_pull.flag_pull(off.frontier.view(u8), off.visited.view(u8), bg, hits.view(u8),
                                 off.ctrl, off.k, top, scratch, off.levels)

    return dict(
        stepper_call_us=_wrapper_host_us(torch, bound),
        checked_call_us=_wrapper_host_us(
            torch, lambda: lowk.flag_expand(off, bg, hits, top, scratch)),
        parent_push_and_pull_us=_wrapper_host_us(torch, parent),
        note="host time of one call, its kernels gated off on the device", card=CARD)


def _active_lanes(torch, kp, k, levels, ctrl):
    """flag_pull's active lanes as a (Kp,) bool: real lanes (q < k) whose
    counter says the query's frontier is not empty (every real lane when
    ``levels`` is None)."""
    lanes = torch.arange(kp, device=ctrl.device) < k
    if levels is not None:
        lanes &= levels[::8][:kp] == ctrl[1] + 1
    return lanes


def _flag_pull_row(torch, bg, frontier, visited, k, levels, ctrl, scratch, library):
    """flag_pull (K5's pull, csrc/flag_pull.cu) against its plain version
    on one pull level: the error, both times, the library call
    ``hits.index_reduce_(0, owner, frontier[neighbour], "amax") &=
    ~visited`` over the dedup CSR (``library`` = (owner, neighbour)
    int64 tensors, or None), and two bounds: the whole function's (every
    slot's cols, final_slot, the frontier and visited read and the hits
    written once) and the level's (only the cols of the live rows, whose
    owner has an active lane it has not visited, and the three planes),
    with the L2 sector floor of the frontier rows the kernel must gather
    (level-0 slots of live rows whose source is in the frontier)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull as cfp,
    )

    n, kp = frontier.shape
    w = kp // 4

    def kernel():
        cfp.flag_pull(frontier, visited, bg, h_k, ctrl, k, scratch=scratch, levels=levels)

    h_k, h_p = torch.full_like(frontier, 7), torch.full_like(frontier, 7)
    kernel()
    cfp.flag_pull_plain(frontier, visited, bg, h_p, ctrl, k)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, kernel, lambda: None)
    plain_ms = _time_ms(torch, lambda: cfp.flag_pull_plain(frontier, visited, bg, h_p, ctrl, k),
                        lambda: None, reps=3)
    library_ms = None
    if library is not None:
        owner, nbr = library
        lib, unvisited = torch.zeros_like(frontier), ~visited
        library_ms = _time_ms(
            torch, lambda: lib.index_reduce_(0, owner, frontier[nbr], "amax").bitwise_and_(unvisited),
            lib.zero_, reps=3)
        assert torch.equal(lib, h_p), "the library yardstick computes another function"
        del lib, unvisited
    # Live rows: their owner has an active lane it has not visited.
    lanes = _active_lanes(torch, kp, k, levels, ctrl)
    vlive = ((visited == 0) & lanes[None, :]).any(dim=1)
    live = vlive[bg.row_owner(frontier.device).long()]
    widths = torch.cat([torch.full((r_b,), w_b, dtype=torch.int64, device=frontier.device)
                        for shapes in bg.level_shapes for r_b, w_b in shapes if r_b])
    slots = int(widths.sum())
    live_slots = int(widths[live].sum())
    size0 = bg.level_sizes[0]
    in_frontier = torch.cat([(frontier != 0).any(dim=1), live.new_zeros(1)])
    gathered = torch.repeat_interleave(live[:size0], widths[:size0]) & in_frontier[
        bg.level_cols[0].long()]
    sectors = int(gathered.sum()) * -(-kp // 32)
    del vlive, in_frontier, gathered
    function_bound, function_by = _bound_ms(4 * slots + 4 * n + 3 * n * kp, slots * w)
    level_bound, level_by = _bound_ms(4 * live_slots + 3 * n * kp, live_slots * w)
    plan = cfp.flag_pull_plan(w, n, k, all(t.data_ptr() % 16 == 0 for t in (
        frontier, visited, h_k, scratch.v_cat)))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=level_bound,
                bound_by=level_by, function_bound_ms=function_bound,
                function_bound_by=function_by, l2_floor_ms=sectors * 32 / L2_SECTOR_BYTES_PER_S * 1e3,
                library_ms=library_ms, variant=plan.label, Kp=kp, W=w, k=k,
                active_lanes=int(lanes.sum()), frontier_rows=int((frontier != 0).any(dim=1).sum()),
                live_rows=int(live.sum()), rows=int(live.numel()), live_slots=live_slots,
                slots=slots, gathered_sectors=sectors)


def _byte_levels(torch, bg, padded, label, library, bell_route=False):
    """A byte route's BFS a level at a time (LowKEngine, or BellEngine
    with ``bell_route``): the kernel engine's carry and the plain engine's
    advanced in lockstep and equal before every level and at the end; on
    the low-K route each level's one expansion call beside the parent's
    push and pull calls (:func:`_expand_row`; the wrappers' host time
    once, :func:`_wrapper_row`), and the level's push, as the level runs
    it, held against the plain push; on each pull level flag_pull held
    against its plain version with the carry's visited plane and counters
    and timed (:func:`_flag_pull_row`) beside bell_hits_packed (forest_or
    on the word view) on the same frontier (:func:`_byte_forest_row`); on
    each push level K5's push timed (:func:`_byte_push_row`); the apply
    held and timed (the switched one beside the same launch without the
    switch on the low-K route).  Returns one row a level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell, cuda_bell, cuda_flag_pull, lowk,
    )

    top = 2**31 - 1
    cls = bell.BellEngine if bell_route else lowk.LowKEngine
    fast = cls(bg, level_chunk=128)
    slow = cls(bg, level_chunk=128, plain=True)
    queries = fast._pad_queries(padded)[0]
    a, b = fast._init_carry(queries), slow._init_carry(queries)
    w = a.frontier.shape[1]
    scratch = cuda_flag_pull.flag_pull_scratch(bg, w, a.frontier.device)
    forest = cuda_bell.forest_scratch(bg, w, a.frontier.device)
    expand = fast._expand(w)
    hits = torch.zeros_like(a.frontier)
    sw = a.switch
    limits = None if sw is None else (sw.count, sw.row_limit, sw.edge_limit)
    fields = ("visited", "frontier", "f", "levels", "reached", "ctrl")
    u8 = torch.uint8

    def same():
        pairs = [(getattr(a, f), getattr(b, f)) for f in fields]
        if sw is not None:
            pairs += [(a.switch.state[:4], b.switch.state[:4]), (a.switch.hits, b.switch.hits)]
        return _max_abs_err(torch, pairs)

    rows = []
    while bitbell.level_go(b.ctrl, top):
        assert same() == 0, (label, len(rows), "kernel and plain engines differ")
        level, d = int(a.ctrl[1]) + 1, int(a.ctrl[3])
        row = dict(level=level, direction="push" if d == bitbell.DIR_PUSH else "pull")
        fr = a.frontier.view(u8)
        if sw is not None:
            if not rows:
                WRAPPER_ROWS[label] = _wrapper_row(torch, bg, a, scratch)
            row["expand"] = _expand_row(torch, bg, a, hits, scratch)
            # One launch and one wrapper call fewer than the parent's level.
            assert row["expand"]["expand"]["launches"] == {"flag_pull": 1}, (label, row)
            assert row["expand"]["parent"]["launches"] == {"push_or": 1, "flag_pull": 1}
        if d == bitbell.DIR_PUSH:
            row["flag_pull:push"] = _byte_push_row(torch, bg, a, scratch)
            assert row["flag_pull:push"]["max_abs_err"] == 0, (label, row)
        else:
            row["flag_pull"] = _flag_pull_row(torch, bg, fr, a.visited.view(u8), a.k, a.levels,
                                              a.ctrl.clone(), scratch, library)
            assert row["flag_pull"]["max_abs_err"] == 0, (label, row)
            row["forest_or:bytes"] = _byte_forest_row(torch, bg, fr, forest, None)
            assert row["forest_or:bytes"]["max_abs_err"] == 0, (label, row)
        expand(a, hits, top, scratch)
        if d == bitbell.DIR_PUSH:  # the level's own push, against the plain push
            want = torch.zeros_like(fr)
            lowk.sparse_hits_flags_plain(fr, bg, want, a.ctrl, sw)
            assert torch.equal(sw.hits.view(u8), want), (label, level, "the push differs")
        level_hits = sw.hits.clone() if d == bitbell.DIR_PUSH else hits
        pristine = bitbell.BitCarry(a.visited, a.frontier, a.f, a.levels, a.reached,
                                    a.counts, a.ctrl)
        row["level_apply"] = _apply_row(torch, pristine, level_hits, limits)
        if limits is not None:
            row["unswitched_apply_ms"] = _apply_row(torch, pristine, level_hits)["ms"]
        assert row["level_apply"]["max_abs_err"] == 0, (label, row)
        bitbell.bit_level_apply(a, hits)
        slow._chunk(b, 1)
        rows.append(row)
        assert level <= bg.n, "the level loop did not stop"
    assert same() == 0, (label, "kernel and plain engines differ at the end")
    return rows


def _lowk_split(torch, eng, bg, padded, levels, label):
    """A byte-plane route's whole BFS split by launch (:func:`_hybrid_split`):
    the level's one expansion call (flag_pull, the push in its first
    launch on the low-K route) and the apply; then the engine's chunk
    timed and traced, each chunk enqueued under
    ``torch.cuda.set_sync_debug_mode("error")`` (a blocking read raises)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull,
    )

    top = 2**31 - 1
    queries = eng._pad_queries(padded)[0]
    c0 = eng._init_carry(queries)
    w = c0.frontier.shape[1]
    scratch = cuda_flag_pull.flag_pull_scratch(bg, w, c0.frontier.device)
    expand = eng._expand(w)

    def chunk(c):
        with _no_sync(torch):
            eng._chunk(c, levels)

    return _hybrid_split(torch, lambda: eng._init_carry(queries), None,
                         lambda c, h: expand(c, h, top, scratch), chunk, levels, label)


def _summarise_levels(rows, label):
    """One line of a level-by-level drive: directions, and the byte
    kernels' numbers level by level; the rows themselves go to a detail
    file."""
    path = _write_detail(label.replace(" ", "_"), rows)

    def pick(key, field):
        return [r[key][field] for r in rows if key in r]

    print(f"byte levels {label}: " + json.dumps(dict(
        levels=len(rows), directions=_runs([r["direction"] for r in rows]),
        every_level_equal_to_plain_engine=True,
        flag_pull_ms=pick("flag_pull", "ms"),
        flag_pull_level_bound_ms=pick("flag_pull", "bound_ms"),
        flag_pull_function_bound_ms=pick("flag_pull", "function_bound_ms"),
        flag_pull_l2_floor_ms=pick("flag_pull", "l2_floor_ms"),
        flag_pull_library_ms=pick("flag_pull", "library_ms"),
        flag_pull_plain_ms=pick("flag_pull", "plain_ms"),
        flag_pull_live_rows=pick("flag_pull", "live_rows"),
        flag_pull_frontier_rows=pick("flag_pull", "frontier_rows"),
        flag_pull_variant=pick("flag_pull", "variant"),
        word_view_pull_ms=pick("forest_or:bytes", "ms"),
        push_first_launch_ms=pick("flag_pull:push", "ms"),
        push_call_ms=pick("flag_pull:push", "call_ms"),
        push_parent_push_or_ms=pick("flag_pull:push", "parent_push_or_ms"),
        push_floor_ms=pick("flag_pull:push", "floor_ms"),
        push_library_ms=pick("flag_pull:push", "library_ms"),
        push_bound_ms=pick("flag_pull:push", "bound_ms"),
        expand_ms=[r["expand"]["expand"]["ms"] for r in rows if "expand" in r],
        parent_push_and_pull_ms=[r["expand"]["parent"]["ms"] for r in rows if "expand" in r],
        expand_launches=[r["expand"]["expand"]["launches"] for r in rows if "expand" in r],
        parent_launches=[r["expand"]["parent"]["launches"] for r in rows if "expand" in r],
        expand_device_ops=[r["expand"]["expand"]["device_ops"] for r in rows if "expand" in r],
        parent_device_ops=[r["expand"]["parent"]["device_ops"] for r in rows if "expand" in r],
        first_launch_ms=[r["expand"]["expand"]["kernel_ms"].get("flag_first_kernel")
                         for r in rows if "expand" in r],
        parent_push_or_and_prepass_ms=[
            [r["expand"]["parent"]["kernel_ms"].get(n_) for n_ in
             ("push_or_kernel", "flag_first_kernel")] for r in rows if "expand" in r],
        wrapper_host_us=WRAPPER_ROWS.get(label),
        apply_ms=[r["level_apply"]["ms"] for r in rows],
        apply_bound_ms=[r["level_apply"]["bound_ms"] for r in rows],
        apply_variant=[r["level_apply"]["variant"] for r in rows],
        apply_unswitched_ms=[r.get("unswitched_apply_ms") for r in rows],
        detail=path, card=CARD,
    )))


def _apply_at_k1(torch, rows, n, label):
    """The apply of a K = 1 low-K BFS on its level with the most new
    vertices, against its bound at the port's 4-byte stride (one word a
    vertex) and at JAX's 1-byte stride (one byte a vertex): the four plane
    streams, the visited reads under nonzero hits and the writes of what
    is new, at 4 or 1 bytes each."""
    row = max(rows, key=lambda r: r["level_apply"]["new_words"])
    ap = row["level_apply"]
    hit, new = ap["hit_words"], ap["new_words"]
    out = dict(
        level=row["level"], direction=row["direction"], ms=ap["ms"],
        unswitched_ms=row["unswitched_apply_ms"], hit_rows=hit, new_rows=new,
        bound_ms_4_byte_stride=_bound_ms(8 * n + 4 * hit + 4 * new + 32 * 40, 2 * n)[0],
        bound_ms_1_byte_stride=_bound_ms(2 * n + hit + new + 32 * 40, 2 * n)[0],
    )
    print(f"apply at K=1 {label}: " + json.dumps(out))
    return out


def _lowk16_path(ctx, seed):
    """BASELINE.json config 1, single-source BFS on RMAT-16: rmat_edges(16,
    16) with one group of one source (drawn from the non-isolated
    vertices) through the CLI's auto low-K route; F equals scipy's and the
    plain engine's; then the pack held, the BFS a level at a time and
    split by launch."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        lowk,
    )

    t0 = time.perf_counter()
    n, edges = generators.rmat_edges(16, edge_factor=16, seed=seed)
    g = CSRGraph.from_edges(n, edges)
    source = int(np.random.default_rng(seed).choice(np.nonzero(g.degrees > 0)[0]))
    queries = [np.array([source], dtype=np.int32)]
    gpath, qpath = os.path.join(tmp, "rmat16.bin"), os.path.join(tmp, "rmat16-q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    host_s = time.perf_counter() - t0
    min_k, min_f, pre_s, comp_s = _run_path(
        cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"], "lowk rmat-16",
        launches,
    )
    want = _scipy_f(cg, np, _scipy_matrix(sp, np, g), queries[0])
    assert (min_k, min_f) == (0, want) and want > 0, (min_k, min_f, want)
    assert "flag_pull:W1/map/bits/push" in VARIANTS["lowk rmat-16"], VARIANTS["lowk rmat-16"]
    bg = BellGraph.from_host(g, dev)
    padded = tio.pad_queries(queries)
    fast = lowk.LowKEngine(bg, level_chunk=128)
    levels, reached, f = fast.query_stats(padded)
    f_plain = lowk.LowKEngine(bg, level_chunk=128, plain=True).f_values(padded).cpu().numpy()
    assert int(f[0]) == int(f_plain[0]) == want, (f, f_plain, want)
    print("lowk rmat-16: " + json.dumps(dict(
        n=n, directed_edges=g.num_directed_edges, source=source, min_f=min_f, scipy_f=want,
        levels=int(levels[0]), reached=int(reached[0]), preprocessing_s=pre_s,
        computation_s=comp_s, host_generate_s=host_s,
    )))
    _batch_start_check(torch, fast, n, padded, "lowk rmat-16")
    rows = _byte_levels(torch, bg, padded, "lowk rmat-16 K=1", _csr_pairs(torch, bg))
    _summarise_levels(rows, "lowk rmat-16 K=1")
    _lowk_split(torch, fast, bg, padded, len(rows), "lowk rmat-16 K=1")
    return dict(gpath=gpath, qpath=qpath, source=source, want=want, single_s=comp_s)


def _rmat20_paths(ctx, n, edges, g, bg, eg, k, seed):
    """The default (bitbell), ELL (MSBFS_BACKEND=pallas) and byte-plane
    BELL (MSBFS_BACKEND=bell) routes through the CLI on RMAT-20 with K
    groups, and the low-K route on its first LOWK_GROUPS groups: the same
    winner and F on the three K-group routes, every F equal across the
    kernel engines and the plain engines on the card, the winner and the
    first SCIPY_GROUPS groups equal to scipy's (the low-K groups among
    them); then the low-K BFS a level at a time (also at K = 1, for the
    apply's two strides) and both byte routes split by launch."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell, engine, lowk,
    )

    steps = _Steps("phase 5b paths")
    gpath, qpath = os.path.join(tmp, "rmat20.bin"), os.path.join(tmp, "rmat20-q.bin")
    qpath4 = os.path.join(tmp, "rmat20-q4.bin")
    queries = generators.random_queries(n, k, seed=seed)
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    tio.save_query_bin(qpath4, queries[:LOWK_GROUPS])
    argv = ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"]
    runs = {"bitbell rmat-20": _run_path(cli, timing, argv, "bitbell rmat-20", launches)}
    with _env(MSBFS_BACKEND="pallas"):
        runs["ell rmat-20"] = _run_path(cli, timing, argv, "ell rmat-20", launches)
    with _env(MSBFS_BACKEND="bell"):
        runs["bell rmat-20"] = _run_path(cli, timing, argv, "bell rmat-20", launches)
    lowk_run = _run_path(cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath4, "-gn", "1"],
                         "lowk rmat-20", launches)
    steps("four CLI paths")
    ell = {k_: v for k_, v in VARIANTS["ell rmat-20"].items() if k_.startswith("ell_hits:")}
    steady = sum(v for k_, v in ell.items() if ":steady" in k_)
    stale = sum(v for k_, v in ell.items() if ":stale" in k_)
    assert steady > stale > 0, ell
    assert "flag_pull:W16/vec16/map" in VARIANTS["bell rmat-20"], VARIANTS["bell rmat-20"]
    assert "flag_pull:W1/map/push" in VARIANTS["lowk rmat-20"], VARIANTS["lowk rmat-20"]
    padded = tio.pad_queries(queries)
    padded4 = tio.pad_queries(queries[:LOWK_GROUPS])
    _ell_level_split(torch, eg, padded, "rmat-20 K=64")
    steps("ell level split")
    _bitbell_hybrid(torch, bg, padded, "bitbell rmat-20 K=64")
    steps("bitbell hybrid levels")
    f = {}
    seconds = {}
    for name, eng in (
        ("bitbell kernels", bitbell.BitBellEngine(bg, level_chunk=128)),
        ("bitbell plain", bitbell.BitBellEngine(bg, level_chunk=128, plain=True)),
        ("ell kernels", engine.Engine(eg, level_chunk=128)),
        ("ell plain", engine.Engine(eg, level_chunk=128, plain=True)),
        ("bell kernels", bell.BellEngine(bg, level_chunk=128)),
        ("bell plain", bell.BellEngine(bg, level_chunk=128, plain=True)),
    ):
        t0 = time.perf_counter()
        stats = eng.query_stats(padded)
        seconds[name] = time.perf_counter() - t0
        f[name] = stats[2]
        if name == "bitbell kernels":
            levels, reached = stats[0], stats[1]
    for name, vals in f.items():
        assert np.array_equal(vals, f["bitbell kernels"]), (name, vals)
    fv = f["bitbell kernels"]
    for name, eng in (("lowk kernels", lowk.LowKEngine(bg, level_chunk=128)),
                      ("lowk plain", lowk.LowKEngine(bg, level_chunk=128, plain=True))):
        t0 = time.perf_counter()
        f[name] = eng.query_stats(padded4)[2]
        seconds[name] = time.perf_counter() - t0
        assert np.array_equal(f[name], fv[:LOWK_GROUPS]), (name, f[name])
    steps("eight engines' stats")
    winner = int(np.argmin(fv))
    winner4 = int(np.argmin(fv[:LOWK_GROUPS]))
    for name, (min_k, min_f, _, _) in runs.items():
        assert (min_k, min_f) == (winner, int(fv[winner])), (name, min_k, min_f)
    assert lowk_run[:2] == (winner4, int(fv[winner4])), lowk_run
    a = _scipy_matrix(sp, np, g)
    groups = sorted({winner, *range(SCIPY_GROUPS)})
    # (levels, reached, F) of each checked group, one BFS each: phases 9e
    # and 10 hold their stats against the same rows.
    scipy_stats = dict(zip(groups, _scipy_map(_scipy_stats, a, [queries[q] for q in groups])))
    want = {q: st[2] for q, st in scipy_stats.items()}
    for q, wf in want.items():
        assert int(fv[q]) == wf, (q, int(fv[q]), wf)
    # About 38% of RMAT-20's vertices are isolated, so a small group may
    # win with F = 0: the check must also hold groups that reach far.
    assert any(wf > 0 for wf in want.values()), want
    steps("scipy")
    depth = int(levels.max())
    for name, (min_k, min_f, pre_s, comp_s) in runs.items():
        print(f"{name}: " + json.dumps(dict(
            n=n, directed_edges=g.num_directed_edges, K=k, winner=min_k + 1, min_f=min_f,
            scipy_f=want[winner], scipy_groups_equal=len(want),
            scipy_f_checked=[want[q] for q in groups], all_f_equal_across_engines=True,
            preprocessing_s=pre_s, computation_s=comp_s, levels=depth,
            reached=int(reached.sum()), ms_per_level=comp_s * 1e3 / max(depth, 1),
        )))
    min_k, min_f, pre_s, comp_s = lowk_run
    print("lowk rmat-20: " + json.dumps(dict(
        n=n, K=LOWK_GROUPS, winner=min_k + 1, min_f=min_f,
        all_f_equal_scipy=[int(x) for x in fv[:LOWK_GROUPS]] == [
            want[q] for q in range(LOWK_GROUPS)],
        f=[int(x) for x in fv[:LOWK_GROUPS]], preprocessing_s=pre_s, computation_s=comp_s,
    )))
    print("rmat-20 engine query_stats s: " + json.dumps(seconds))
    # The batch start at the four RMAT-20 batch shapes (bitbell: stride 1,
    # W = 2; bell: stride 8, W = 16; low-K: stride 8, W = 1, at K = 4 and 1).
    _batch_start_check(torch, bitbell.BitBellEngine(bg), n, padded, "bitbell rmat-20")
    _batch_start_check(torch, bell.BellEngine(bg), n, padded, "bell rmat-20")
    _batch_start_check(torch, lowk.LowKEngine(bg), n, padded4, "lowk rmat-20")
    _batch_start_check(torch, lowk.LowKEngine(bg), n, padded4[:1], "lowk rmat-20 K=1")
    steps("batch starts")
    # The byte routes a level at a time and split by launch.
    library = _csr_pairs(torch, bg)
    rows4 = _byte_levels(torch, bg, padded4, "lowk rmat-20 K=4", library)
    _summarise_levels(rows4, "lowk rmat-20 K=4")
    steps("lowk K=4 levels")
    rows1 = _byte_levels(torch, bg, padded4[:1], "lowk rmat-20 K=1", library)
    _summarise_levels(rows1, "lowk rmat-20 K=1")
    _apply_at_k1(torch, rows1, n, "lowk rmat-20")
    steps("lowk K=1 levels")
    rows64 = _byte_levels(torch, bg, padded, "bell rmat-20 K=64", library, bell_route=True)
    _summarise_levels(rows64, "bell rmat-20 K=64")
    steps("bell K=64 levels")
    _lowk_split(torch, lowk.LowKEngine(bg, level_chunk=128), bg, padded4, len(rows4),
                "lowk rmat-20 K=4")
    bell_eng = bell.BellEngine(bg, level_chunk=128)
    _lowk_split(torch, bell_eng, bg, padded, depth, "bell rmat-20 K=64")
    steps("two byte splits")
    # K5's pull at the bell route's width (W = 16) on a synthetic plane: a
    # third of the flags set, nothing visited (no row to skip), beside
    # bell_hits_packed (forest_or on the word view) on the same frontier.
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell, cuda_flag_pull,
    )

    gen = torch.Generator(device=bg.device).manual_seed(seed)
    wide = (torch.rand((n, k), device=bg.device, generator=gen) < 0.3).to(torch.uint8)
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=bg.device)
    row = _flag_pull_row(torch, bg, wide, torch.zeros_like(wide), k, None, pull,
                         cuda_flag_pull.flag_pull_scratch(bg, k // 4, bg.device), library)
    row["word_view_pull"] = _byte_forest_row(
        torch, bg, wide, cuda_bell.forest_scratch(bg, k // 4, bg.device), library)
    # Each pull wrapper's host time a level, its launches gated off.
    off = torch.tensor([0, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=bg.device)
    scratch = cuda_flag_pull.flag_pull_scratch(bg, k // 4, bg.device)
    forest = cuda_bell.forest_scratch(bg, k // 4, bg.device)
    hits, seen = torch.empty_like(wide), torch.zeros_like(wide)
    levels = torch.zeros(8 * k, dtype=torch.int32, device=bg.device)
    row["wrapper_host_us"] = dict(
        flag_pull=_wrapper_host_us(torch, lambda: cuda_flag_pull.flag_pull(
            wide, seen, bg, hits, off, k, scratch=scratch, levels=levels)),
        word_view_pull=_wrapper_host_us(torch, lambda: bell.bell_hits_packed(
            wide, bg, hits, off, scratch=forest)),
        note="host time of one call, its kernels gated off on the device")
    del scratch, forest, hits, seen
    print(f"compare rmat-20 n={n} K={k} flag_pull synthetic: " + json.dumps(row))
    assert row["max_abs_err"] == 0 and row["word_view_pull"]["max_abs_err"] == 0, row
    del library, wide
    steps("synthetic W=16 pull")
    steps.print()
    pulls = [r["flag_pull"] for r in rows4 if "flag_pull" in r]
    pushes = [r["flag_pull:push"] for r in rows4 if "flag_pull:push" in r]
    assert pulls and pushes, "the low-K BFS ran one direction only"
    # The kernel line's rows: the densest pull and the widest push of the
    # low-K BFS (K = 4, W = 1); and what phase 9 reuses.
    rows = {
        "flag_pull": max(pulls, key=lambda r: r["frontier_rows"]),
        "flag_pull:push": max(pushes, key=lambda r: r["edges"]),
    }
    info = dict(gpath=gpath, qpath=qpath, queries=queries, padded=padded, fv=fv,
                winner=winner, want=want, scipy=a, groups=groups, scipy_stats=scipy_stats)
    return rows, info


# ---- phase 9: resilience on RMAT-20 (the host-streamed route, the
# capacity ladder, a real out-of-memory error, checkpoint, MSBFS_STATS)

# MSBFS_SLOT_BUDGET of the many-segment streamed runs (slots).
STREAMED_BUDGET = 4194304
# Queries per checkpointed chunk of the crash run (64 groups: 4 chunks).
CHECKPOINT_CHUNK = 16


@contextlib.contextmanager
def _supervisors():
    """Keep every ChunkSupervisor the CLI builds, for its recovery events
    (the CLI reports them only on a failure)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        supervisor,
    )

    made, init = [], supervisor.ChunkSupervisor.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    supervisor.ChunkSupervisor.__init__ = keep
    try:
        yield made
    finally:
        supervisor.ChunkSupervisor.__init__ = init


# The matrix forked scipy workers read (:func:`_scipy_map`), set only while
# a pool is open.
_POOL_MATRIX = None


def _pool_call(job):
    import numpy as np
    import scipy.sparse.csgraph as cg

    fn, sources = job
    return fn(cg, np, _POOL_MATRIX, sources)


def _scipy_map(fn, a, groups):
    """``fn(cg, np, a, sources)`` for each group's sources, one group a
    forked worker process at a time on the host's CPUs (scipy's BFS and
    Dijkstra hold one core each).  The workers run scipy only, never the
    card, and the pool is closed before this returns."""
    global _POOL_MATRIX
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    _POOL_MATRIX = a
    try:
        with ProcessPoolExecutor(max(1, min(len(groups), os.cpu_count() or 1)),
                                 mp_context=mp.get_context("fork")) as pool:
            return list(pool.map(_pool_call, [(fn, g) for g in groups]))
    finally:
        _POOL_MATRIX = None


def _scipy_stats(cg, np, a, sources):
    """(levels, reached, F) of one query group from scipy's BFS: levels is
    the largest distance + 1, 0 for a group with no source in range."""
    n = a.shape[0]
    src = np.unique(sources[(sources >= 0) & (sources < n)])
    if src.size == 0:
        return 0, 0, 0
    d = cg.dijkstra(a, directed=True, indices=src, unweighted=True, min_only=True)
    d = d[np.isfinite(d)]
    return int(d.max()) + 1, int(d.size), int(d.sum())


def _h2d_bytes_per_s(torch, host, dev):
    """Pinned host-to-device copy rate of ``host`` (CUDA events, median)."""
    dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
    ms = _time_ms(torch, lambda: dst.copy_(host, non_blocking=True), lambda: None, reps=5)
    return host.numel() * host.element_size() / (ms / 1e3)


def _pass_ms(torch, eng, frontier, reps=5):
    """One BFS level's forest pass of a host-streamed engine, uploads
    included: host clock around the pass and a device sync, median."""
    hits = torch.empty_like(frontier)
    ctrl = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=frontier.device)
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eng._streams():
            eng.forest_pass(frontier, hits, ctrl)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def _dense_share(cuda_bell, share):
    """Run the map instances with MAP_DENSE_SHARE = ``share`` (1: the map
    is always read; below 0: never, the dense walk)."""
    saved = cuda_bell.MAP_DENSE_SHARE
    cuda_bell.MAP_DENSE_SHARE = share
    try:
        yield
    finally:
        cuda_bell.MAP_DENSE_SHARE = saved


def _needed(torch, prev, prev_rows, cols):
    """What a segment's function must read of ``prev``: the rows its slots
    name that are nonzero (each once), and the slots naming one (each a
    32-byte L2 sector at the least)."""
    nonzero = torch.cat([(prev[:prev_rows] != 0).any(dim=1),
                         torch.zeros(1, dtype=torch.bool, device=prev.device)])
    c = cols.long()
    hit = nonzero[c]
    need = torch.zeros(prev_rows + 1, dtype=torch.bool, device=prev.device)
    need[c[hit]] = True
    return int(need.sum()), int(hit.sum())


def _map_row(torch, frontier, fmap, ctrl):
    """The map pre-pass against its plain version on one frontier, timed
    beside its bound (the frontier read, the weights of its nonzero rows
    read, the map and its sums written)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell,
    )

    n, w = frontier.shape
    ref = cuda_bell.frontier_map_scratch(n, frontier.device, fmap.weights, fmap.shift)
    cuda_bell.frontier_map(frontier, fmap, ctrl)
    cuda_bell.frontier_map_plain(frontier, ref, ctrl)
    torch.cuda.synchronize()
    row = dict(max_abs_err=_max_abs_err(torch, [(fmap.bits, ref.bits),
                                                (fmap.counts, ref.counts)]),
               ms=_time_ms(torch, lambda: cuda_bell.frontier_map(frontier, fmap, ctrl),
                           lambda: None),
               plain_ms=_time_ms(torch, lambda: cuda_bell.frontier_map_plain(
                   frontier, ref, ctrl), lambda: None, reps=3),
               library_ms=None, frontier_rows=int(ref.counts[cuda_bell.ROWS]),
               weight=int(ref.counts[cuda_bell.SLOTS]), weight_total=ref.total,
               vertices_a_bit=1 << fmap.shift)
    row["bound_ms"], row["bound_by"] = _bound_ms(
        4 * n * w + 4 * row["frontier_rows"] + 4 * fmap.bits.numel() + 40, n * w)
    return row


def _segment_row(torch, seg_call, plain_call, out, out_ref, prev, prev_rows, cols, slots,
                 rows, w, mapped, forced):
    """One segment launch (the plan's instance) against its plain version,
    timed beside ``nomap`` (every slot reads its row, no map) and,
    with ``forced``, its instance with the map always read and never read;
    the bound counts the cols, the nonzero rows the slots name, the map
    (level 0) and the rows written."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell,
    )

    seg_call(None)
    plain_call()
    torch.cuda.synchronize()
    row = dict(max_abs_err=_max_abs_err(torch, [(out, out_ref)]))
    seg_call("nomap")
    torch.cuda.synchronize()
    row["max_abs_err"] = max(row["max_abs_err"], _max_abs_err(torch, [(out, out_ref)]))
    row["ms"] = _time_ms(torch, lambda: seg_call(None), lambda: None)
    row["nomap_ms"] = _time_ms(torch, lambda: seg_call("nomap"), lambda: None)
    if forced:
        for name, share in (("map_read_ms", 1.0), ("map_skipped_ms", -1.0)):
            with _dense_share(cuda_bell, share):
                seg_call(None)
                torch.cuda.synchronize()
                row["max_abs_err"] = max(row["max_abs_err"], _max_abs_err(torch, [(out, out_ref)]))
                row[name] = _time_ms(torch, lambda: seg_call(None), lambda: None)
    row["plain_ms"] = _time_ms(torch, plain_call, lambda: None, reps=3)
    need, hit_slots = _needed(torch, prev, prev_rows, cols)
    map_bytes = 4 * cuda_bell.map_words(prev_rows) if mapped else 0
    row["bound_ms"], row["bound_by"] = _bound_ms(
        4 * slots + 4 * w * need + map_bytes + 4 * w * rows, 0)
    row["library_ms"] = None
    row["l2_floor_ms"] = 32 * hit_slots / L2_SECTOR_BYTES_PER_S * 1e3
    row.update(slots=slots, rows=rows, nonzero_source_slots=hit_slots)
    return row


def _segment_level(torch, eng, frontier, forced):
    """One BFS level's forest pass of a host-streamed engine, launch by
    launch, on its real frontier, each segment's cols on the device: the
    map pre-pass, every segment (the plan's instance, :func:`_segment_row`)
    and the final gather (beside ``torch.index_select``), each held
    against its plain version."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell,
    )

    dev, (n, w) = frontier.device, frontier.shape
    ctrl = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    scratch = cuda_bell.forest_scratch(eng, w, dev)
    ref = cuda_bell.forest_scratch(eng, w, dev)
    fmap = eng._map
    map_row = _map_row(torch, frontier, fmap, ctrl)
    segs = []
    for i, seg in enumerate(eng._segments):
        cols = eng._slices[i].to(dev)
        if seg.level == 0:
            prev, prev_ref, prev_rows, mapped = frontier, frontier, n, fmap
        else:
            lo = eng._row_offset[seg.level - 1]
            prev_rows = eng.level_rows[seg.level - 1]
            prev, prev_ref = scratch[lo : lo + prev_rows], ref[lo : lo + prev_rows]
            mapped = None
        lo = eng._row_offset[seg.level] + seg.row0
        out, out_ref = scratch[lo : lo + seg.rows], ref[lo : lo + seg.rows]
        pieces = eng._tables.pieces[i]

        def seg_call(instance, prev=prev, prev_rows=prev_rows, cols=cols, i=i, out=out,
                     mapped=mapped):
            cuda_bell.forest_segment(prev, prev_rows, cols, eng._tables, i, out, ctrl,
                                     fmap=mapped, instance=instance)

        def plain_call(prev_ref=prev_ref, prev_rows=prev_rows, cols=cols, pieces=pieces,
                       out_ref=out_ref):
            cuda_bell.forest_segment_plain(prev_ref, prev_rows, cols, pieces, out_ref, ctrl)

        row = _segment_row(torch, seg_call, plain_call, out, out_ref, prev, prev_rows, cols,
                           seg.slots, seg.rows, w, mapped is not None,
                           forced and mapped is not None)
        vec16 = cuda_bell._rows_vec16(w, prev, out)
        plan = cuda_bell.segment_plan(w, vec16, seg.level, prev_rows)
        row.update(level=seg.level, instance=plan.instance, variant=plan.label)
        segs.append(row)
        del cols
    h_k, h_p = torch.full_like(frontier, 7), torch.empty_like(frontier)
    cuda_bell.forest_final_gather(scratch, eng.final_slot, h_k, ctrl)
    cuda_bell.forest_final_gather_plain(ref, eng.final_slot, h_p, ctrl)
    torch.cuda.synchronize()
    zero = int((eng.final_slot == eng.total_rows).sum())
    gather = dict(
        max_abs_err=_max_abs_err(torch, [(h_k, h_p)]),
        ms=_time_ms(torch, lambda: cuda_bell.forest_final_gather(
            scratch, eng.final_slot, h_k, ctrl), lambda: None),
        plain_ms=_time_ms(torch, lambda: cuda_bell.forest_final_gather_plain(
            ref, eng.final_slot, h_p, ctrl), lambda: None, reps=3),
        library_ms=_time_ms(torch, lambda: torch.index_select(
            ref, 0, eng.final_slot, out=h_p), lambda: None),
        library="torch.index_select(v_cat, 0, final_slot, out=hits)",
        zero_row_vertices=zero,
        variant=cuda_bell.forest_plan(w, cuda_bell._rows_vec16(w, scratch, h_k)).label,
    )
    gather["bound_ms"], gather["bound_by"] = _bound_ms(4 * n + 8 * n * w, 0)
    assert torch.equal(h_k, h_p), "forest_gather differs from its plain version"
    return map_row, segs, gather, h_p


def _level_summary(map_row, segs, gather, frontier_rows):
    """A BFS level's segment launches summed: the map pre-pass and the
    plan's instances against nomap (no map) on every segment."""
    level0 = [r for r in segs if r["level"] == 0]
    return dict(
        frontier_rows=frontier_rows, instance=level0[0]["instance"],
        ms=map_row["ms"] + sum(r["ms"] for r in segs),
        nomap_ms=sum(r["nomap_ms"] for r in segs),
        bound_ms=map_row["bound_ms"] + sum(r["bound_ms"] for r in segs),
        plain_ms=map_row["plain_ms"] + sum(r["plain_ms"] for r in segs),
        max_abs_err=max([map_row["max_abs_err"], gather["max_abs_err"]]
                        + [r["max_abs_err"] for r in segs]),
        map_ms=map_row["ms"],
        level0_ms=sum(r["ms"] for r in level0),
        level0_nomap_ms=sum(r["nomap_ms"] for r in level0),
        level0_map_read_ms=sum(r.get("map_read_ms", 0.0) for r in level0) or None,
        level0_map_skipped_ms=sum(r.get("map_skipped_ms", 0.0) for r in level0) or None,
        level0_l2_floor_ms=sum(r["l2_floor_ms"] for r in level0),
        weight_share=map_row["weight"] / max(map_row["weight_total"], 1),
        segments=len(segs), slowest_vs_nomap=max(r["ms"] / r["nomap_ms"] for r in segs),
        gather_ms=gather["ms"], gather_library_ms=gather["library_ms"],
        gather_bound_ms=gather["bound_ms"], card=CARD,
    )


def _synthetic_gmap(torch, dev, seed):
    """A level-0 segment beyond the shared-memory map: n = 2^23, W = 2
    (a 64 MB frontier plane, more than the 50 MB L2), 2n = 16,777,216
    random slots in rows of width 4, at frontier densities of 0.1 %, 10 %,
    50 % and 90 % of rows: the map pre-pass (weighted by each vertex's
    slots, as the engine weighs them) and the segment (the plan's gmap)
    held against their plain versions and timed beside nomap."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell,
    )

    n, w, width = 1 << 23, 2, 4
    slots = 2 * n
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cols = torch.randint(0, n, (slots,), dtype=torch.int32, device=dev, generator=gen)
    pieces = ((slots // width, width),)
    tables = cuda_bell.SegmentTables([pieces], dev)
    ctrl = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    out = torch.empty((slots // width, w), dtype=torch.int32, device=dev)
    out_ref = torch.empty_like(out)
    weights = torch.bincount(cols.long(), minlength=n).to(torch.int32)
    fmap = cuda_bell.frontier_map_scratch(n, dev, weights)
    rows = []
    for density in (0.001, 0.1, 0.5, 0.9):
        frontier = _words(torch, n, w, density, gen, dev)
        map_row = _map_row(torch, frontier, fmap, ctrl)
        plan = cuda_bell.segment_plan(w, cuda_bell._rows_vec16(w, frontier, out), 0, n)
        assert plan.instance == "gmap", plan

        def seg_call(instance, frontier=frontier):
            cuda_bell.forest_segment(frontier, n, cols, tables, 0, out, ctrl, fmap=fmap,
                                     instance=instance)

        def plain_call(frontier=frontier):
            cuda_bell.forest_segment_plain(frontier, n, cols, pieces, out_ref, ctrl)

        row = _segment_row(torch, seg_call, plain_call, out, out_ref, frontier, n, cols,
                           slots, slots // width, w, True, True)
        row.update(density=density, instance=plan.instance, variant=plan.label,
                   frontier_rows=map_row["frontier_rows"], map=map_row, card=CARD)
        print("compare synthetic n=2^23 W=2 forest_segment (level 0, density "
              f"{density}): " + json.dumps(row))
        assert row["max_abs_err"] == 0 and map_row["max_abs_err"] == 0, row
        rows.append(row)
    return rows


def _streamed_phase(ctx, n, g, bg, info, seed):
    """Phase 9 on phase 5b's RMAT-20 files (K = 64): the host-streamed
    route through the CLI (whole levels and STREAMED_BUDGET segments, at
    prefetch 1 and 2), its kernels against their plain versions on every
    real level, the pipeline's numbers; the ladder walked by injected
    faults; a real CUDA out-of-memory error in a process whose memory is
    capped between what the streamed rung and the hybrid route need;
    a checkpointed run that crashes and resumes; MSBFS_STATS=2."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, streamed,
    )

    dev = bg.device
    argv = ["chip_smoke", "-g", info["gpath"], "-q", info["qpath"], "-gn", "1"]
    fv, winner, padded = info["fv"], info["winner"], info["padded"]
    want = (winner, int(fv[winner]))

    steps = _Steps("phase 9")
    # -- 9a. the host-streamed route: the CLI path (counted), then the
    # other cuts and depths; every F against the bitbell path's.
    with _env(MSBFS_BACKEND="streamed"):
        run = _run_path(cli, timing, argv, "streamed rmat-20", launches)
    assert run[:2] == want, (run, want)
    counts = launches["streamed rmat-20"]
    assert "forest_or" not in counts and "push_or" not in counts, counts
    assert any(k.startswith("forest_segment:") and k.endswith("/map")
               for k in VARIANTS["streamed rmat-20"]), VARIANTS["streamed rmat-20"]
    steps("9a streamed path")
    spans = {"whole levels, prefetch 2": run[3]}
    for budget, prefetch in ((None, 1), (STREAMED_BUDGET, 1), (STREAMED_BUDGET, 2)):
        knobs = dict(MSBFS_BACKEND="streamed", MSBFS_STREAM_PREFETCH=str(prefetch))
        if budget:
            knobs["MSBFS_SLOT_BUDGET"] = str(budget)
        with _env(**knobs):
            r = _run_cli(cli, argv)
        assert r[:2] == want, (budget, prefetch, r)
        cut = "whole levels" if budget is None else f"{budget}-slot segments"
        spans[f"{cut}, prefetch {prefetch}"] = r[3]
    steps("9a other cuts through the CLI")
    t0 = time.perf_counter()
    host = BellGraph.from_host(g, False, keep_sparse=False)
    host_s = time.perf_counter() - t0
    engines = {}
    for budget in (None, STREAMED_BUDGET):
        for prefetch in (1, 2):
            eng = streamed.StreamedBitBellEngine(host, dev, slot_budget=budget, prefetch=prefetch)
            f = eng.f_values(padded).cpu().numpy()
            assert np.array_equal(f, fv), (budget, prefetch)
            engines[(budget, prefetch)] = eng
    steps("9a host layout and four engines")
    whole, cut = engines[(None, 2)], engines[(STREAMED_BUDGET, 2)]
    plain = streamed.StreamedBitBellEngine(host, dev, plain=True)
    _batch_start_check(torch, whole, n, padded, "streamed rmat-20")
    # The BFS a level at a time: the kernel pass against the plain pass
    # (the segment outputs and the hits) on every real level, at both cuts;
    # then each launch of the level's pass held and timed (the map
    # pre-pass, every segment beside nomap, the gather beside
    # index_select), one "compare ... forest_segment (level i, ...)" row
    # a level and cut, the segments themselves in a detail file.
    carry = whole._init_carry(whole._pad_queries(padded)[0])
    w = carry.frontier.shape[1]
    cuts = (("whole levels", whole), (f"{STREAMED_BUDGET}-slot segments", cut))
    levels, densest, per_level, detail = [], None, {name: [] for name, _ in cuts}, []
    while carry.ctrl[:2].tolist()[0]:
        frontier = carry.frontier.clone()
        rows = int((frontier != 0).any(dim=1).sum())
        ctrl = carry.ctrl.clone()
        hits = {}
        for name, eng in (("whole", whole), ("cut", cut), ("plain", plain)):
            hits[name] = torch.empty_like(frontier)
            with eng._streams():
                eng.forest_pass(frontier, hits[name], ctrl)
        torch.cuda.synchronize()
        scratch = whole._scratch[w][: whole.total_rows]
        err = _max_abs_err(torch, [(hits["whole"], hits["plain"]), (hits["cut"], hits["plain"]),
                                   (scratch, plain._scratch[w][: plain.total_rows]),
                                   (cut._scratch[w][: cut.total_rows], scratch)])
        levels.append(dict(level=len(levels), frontier_rows=rows, max_abs_err=err))
        assert err == 0, levels[-1]
        for name, eng in cuts:
            map_row, segs, gather, h = _segment_level(torch, eng, frontier, eng is whole)
            assert torch.equal(h, hits["plain"]), (len(levels), name)
            summary = _level_summary(map_row, segs, gather, rows)
            print(f"compare rmat-20 K=64 forest_segment (level {len(levels) - 1}, {name}): "
                  + json.dumps(summary))
            assert summary["max_abs_err"] == 0, summary
            per_level[name].append(summary)
            detail.append(dict(level=len(levels) - 1, cut=name, map=map_row, segments=segs,
                               gather=gather))
            if eng is whole and (densest is None or rows > densest[1]):
                densest = (frontier, rows, map_row, segs, gather)
        bitbell.bit_level_apply(carry, hits["whole"])
    steps("9a every level at both cuts")
    assert len(levels) >= 3, levels
    frontier = densest[0]
    k1 = _forest_row(torch, bg, frontier)
    level0 = max(whole._slices[0].numel(), 1)
    rate = _h2d_bytes_per_s(torch, whole._slices[0], dev)
    upload = 4 * whole.slots_total
    passes = {f"{'whole levels' if b is None else f'{b}-slot segments'}, prefetch {p}":
              _pass_ms(torch, eng, frontier) for (b, p), eng in engines.items()}
    over_bfs = {name: dict(
        ms=sum(r["ms"] for r in rows_), nomap_ms=sum(r["nomap_ms"] for r in rows_),
        gather_ms=sum(r["gather_ms"] for r in rows_),
        gather_library_ms=sum(r["gather_library_ms"] for r in rows_),
        slowest_level_vs_nomap=max(r["ms"] / r["nomap_ms"] for r in rows_),
    ) for name, rows_ in per_level.items()}
    print("streamed rmat-20 K=64: " + json.dumps(dict(
        winner=run[0] + 1, min_f=run[1], all_f_equal_bitbell=True,
        scipy_f=info["want"][winner], preprocessing_s=run[2], computation_s=spans,
        host_layout_s=host_s, levels=levels, densest_frontier_rows=densest[1],
        pinned_h2d_gb_per_s=rate / 1e9, h2d_bytes_timed=4 * level0,
        upload_bytes_per_level=upload, transfer_bound_ms=upload / rate * 1e3,
        segments=dict(whole=len(whole._segments), cut=len(cut._segments)),
        level_pass_ms=passes, segment_kernels_over_the_bfs=over_bfs,
        forest_or_ms_same_level=k1["ms"], forest_or_bound_ms=k1["bound_ms"],
        detail=_write_detail("streamed_rmat20_segments", detail), card=CARD,
    )))
    steps("9a passes and prints")
    synthetic = _synthetic_gmap(torch, dev, seed + 21)
    del engines, whole, cut, plain, carry, frontier, hits, host
    torch.cuda.empty_cache()

    steps("9a synthetic gmap")
    # -- 9b. the ladder by injected faults: one, two and three rungs.
    for plan, extra, rung in (
        ("oom:dispatch:1", {}, "streamed"),
        ("oom:dispatch:1,oom:dispatch:2", {}, "host-streamed"),
        ("oom:dispatch:1,oom:dispatch:2,oom:dispatch:3", {"MSBFS_LEVEL_CHUNK": "0"},
         "host-streamed"),
    ):
        with _env(MSBFS_FAULTS=plan, **extra), _supervisors() as made:
            r = _run_cli(cli, argv)
        events = made[-1].events
        assert r[:2] == want, (plan, r)
        assert [e["action"] for e in events] == ["degrade"] * plan.count("oom"), events
        assert events[-1]["to"] == rung, events
        print("ladder rmat-20: " + json.dumps(dict(
            plan=plan, **extra, winner=r[0] + 1, min_f=r[1], computation_s=r[3],
            engine=type(made[-1].engine).__name__,
            events=[{k: e[k] for k in ("action", "method", "to", "error")} for e in events])))
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        faults,
    )

    faults.activate(None)

    steps("9b ladder")
    # -- 9c. a real CUDA out-of-memory error (a capped child process), its
    # child beside 9d's crashing one (the cap is the child's own fraction
    # of the card, its peaks its own: the other process changes neither).
    child = subprocess.Popen(
        [sys.executable, "-c", _OOM_CHILD, json.dumps(argv)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_ROOT,
        env={**os.environ, "PYTHONPATH": _ROOT},
    )
    try:
        # -- 9d. checkpoint: a crash on the third dispatch, then the rerun.
        journal = os.path.join(tmp, "rmat20.ckpt")
        env = {**os.environ, "PYTHONPATH": _ROOT, "MSBFS_CHECKPOINT": journal,
               "MSBFS_CHECKPOINT_CHUNK": str(CHECKPOINT_CHUNK)}
        cmd = [sys.executable, "-m", PKG, *argv[1:]]
        crash = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=_ROOT,
                               env={**env, "MSBFS_FAULTS": "crash:dispatch:3"})
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    print(err[-4000:], end="", file=sys.stderr)
    result = json.loads(out.strip().splitlines()[-1])
    print("real oom rmat-20: " + json.dumps(dict(result, card=CARD)))
    assert child.returncode == 0 and result.get("window"), result
    assert (result["winner"] - 1, result["min_f"]) == want, (result, want)
    assert [e["action"] for e in result["events"]] == ["degrade"], result
    assert "CUDA out of memory" in result["events"][0]["error"], result

    steps("9c real oom child beside 9d's crash")
    kept = open(journal).read().splitlines()
    assert crash.returncode == 137 and crash.stdout == "", (crash.returncode, crash.stderr[-2000:])
    assert len(kept) == 1 + CHECKPOINT_CHUNK, len(kept)
    rerun = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=_ROOT, env=env)
    assert rerun.returncode == 0, rerun.stderr[-2000:]
    lines = rerun.stdout.splitlines()
    resumed = (int(lines[2].rsplit(":", 1)[1]) - 1, int(lines[3].rsplit(":", 1)[1]))
    assert resumed == want, (resumed, want)
    print("checkpoint rmat-20: " + json.dumps(dict(
        crash_rc=crash.returncode, journal_rows_at_crash=len(kept) - 1,
        rerun_rc=rerun.returncode, winner=resumed[0] + 1, min_f=resumed[1],
        rerun_report=lines)))

    steps("9d checkpoint rerun")
    # -- 9e. MSBFS_STATS=2 on the bitbell route against scipy.
    err = io.StringIO()
    with _env(MSBFS_STATS="2"), contextlib.redirect_stderr(err):
        r = _run_cli(cli, argv)
    assert r[:2] == want, r
    text = err.getvalue()
    table = text[text.index("query  levels"):].splitlines()[1:]
    stats = {int(ln.split()[0]) - 1: tuple(int(x) for x in ln.split()[1:]) for ln in table}
    for q in info["groups"]:
        assert stats[q] == info["scipy_stats"][q], (q, stats[q])
    trace = text[text.index("level  discovered"):text.index("query  levels")]
    print("stats=2 rmat-20:\n" + text[text.index("dispatch_count"):text.index("query  levels")]
          + json.dumps(dict(groups_equal_scipy=len(info["groups"]),
                            levels=trace.count("\n") - 1, computation_s=r[3])))
    steps("9e stats=2")
    steps.print()
    _, _, map_row, segs, gather = densest
    del synthetic
    return {"forest_map": map_row, "forest_segment": segs[0], "forest_gather": gather}


# The child of phase 9c: run the default route and the streamed rung once
# each to measure their device memory (the caching allocator's peaks),
# cap this process between the streamed rung's need and the hybrid
# route's, and run the CLI under the cap: the hybrid route must run out
# of memory inside a supervised call and step down.
_OOM_CHILD = r"""
import contextlib, gc, io, json, os, sys
import torch
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import BellGraph
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import supervisor
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import load_graph_bin

argv = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
made, init = [], supervisor.ChunkSupervisor.__init__

def keep(self, *args, **kwargs):
    init(self, *args, **kwargs)
    made.append(self)

supervisor.ChunkSupervisor.__init__ = keep

def clean():
    made.clear()  # a kept supervisor would keep its engine's memory
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

def run(env):
    os.environ.update(env)
    report = io.StringIO()
    try:
        with contextlib.redirect_stdout(report):
            rc = cli.main(argv)
    finally:
        for key in env:
            os.environ.pop(key)
    return rc, report.getvalue().splitlines()

def peaks(env):
    clean()
    rc, _ = run(env)
    assert rc == 0, rc
    return torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)

clean()
layout = BellGraph.from_host(load_graph_bin(argv[2]), dev)
layout_reserved = torch.cuda.memory_reserved(dev)
del layout
hybrid_alloc, hybrid_reserved = peaks({})
rung_alloc, rung_reserved = peaks({"MSBFS_HBM_BYTES": "1"})  # the streamed rung's engine
lo, hi = max(layout_reserved, rung_reserved), hybrid_alloc
out = dict(layout_reserved=layout_reserved, hybrid_peak_allocated=hybrid_alloc,
           hybrid_peak_reserved=hybrid_reserved, streamed_rung_peak_allocated=rung_alloc,
           streamed_rung_peak_reserved=rung_reserved, window=lo < hi)
if lo >= hi:
    print(json.dumps(out))
    sys.exit(2)
cap = (lo + hi) // 2
total = torch.cuda.get_device_properties(dev).total_memory
clean()
torch.cuda.set_per_process_memory_fraction(cap / total, dev)
rc, lines = run({})
sup = made[-1]
out.update(cap_bytes=cap, fraction=cap / total, rc=rc,
           winner=int(lines[2].rsplit(":", 1)[1]) if rc == 0 else None,
           min_f=int(lines[3].rsplit(":", 1)[1]) if rc == 0 else None,
           engine=type(sup.engine).__name__,
           events=[{k: str(e.get(k)) for k in ("action", "method", "to", "error")}
                   for e in sup.events],
           peak_allocated_under_cap=torch.cuda.max_memory_allocated(dev))
print(json.dumps(out))
sys.exit(rc)
"""
# ---- phase 10: the single-device engines over the flat CSR and the
# padded table (vmap, packed, dense, push, ppush)

# Groups of each phase-10 path checked against scipy (besides the winner).
SINGLE_GROUPS = 8
# An explicit capacity that road-1024's batch overflows.
SMALL_CAPACITY = 64


def _clone(torch, carry):
    """A copy of a dataclass carry: every tensor, and its switch's or
    planes', cloned (a query-minor distance view stays query-minor)."""
    import dataclasses

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_csr,
    )

    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, torch.Tensor):
            v = v.T.clone().T if v.dim() == 2 and cuda_csr.query_minor(v) else v.clone()
        elif dataclasses.is_dataclass(v):
            v = _clone(torch, v)
        out[f.name] = v
    return type(carry)(**out)


def _restore(torch, dst, src):
    """Copy ``src``'s tensors (and its switch's or planes', with their
    valid flag) into ``dst``'s, in place."""
    import dataclasses

    for f in dataclasses.fields(src):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if isinstance(b, torch.Tensor):
            a.copy_(b)
        elif dataclasses.is_dataclass(b):
            _restore(torch, a, b)
        elif isinstance(b, bool):
            setattr(dst, f.name, b)


def _carry_err(torch, got, want, names):
    return _max_abs_err(torch, [(getattr(got, n), getattr(want, n)) for n in names])


def _engine_check(np, name, eng, plain, padded, scipy, run):
    """A phase-10 path's engine on the card: its F vector equals the plain
    engine's, its winner and F the CLI's and scipy's, and the first
    SINGLE_GROUPS groups' (levels, reached, F) scipy's (``scipy(q)``:
    group q's, cached by the caller).  A push engine's plain twin starts
    at the capacity the kernel engine's run ended at, so it runs once."""
    t0 = time.perf_counter()
    levels, reached, f = eng.query_stats(padded)
    fast_s = time.perf_counter() - t0
    if hasattr(eng, "auto_capacity"):
        plain.capacity = eng.capacity
    t0 = time.perf_counter()
    f_plain = plain.f_values(padded).cpu().numpy()
    plain_s = time.perf_counter() - t0
    assert np.array_equal(f, f_plain), (name, f, f_plain)
    winner = int(np.argmin(f))
    assert run[:2] == (winner, int(f[winner])), (name, run, winner)
    t0 = time.perf_counter()
    assert scipy(winner)[2] == run[1], name
    groups = min(SINGLE_GROUPS, len(f))
    for q in range(groups):
        want = scipy(q)
        assert (int(levels[q]), int(reached[q]), int(f[q])) == want, (name, q, want)
    return dict(winner=winner + 1, min_f=int(f[winner]), levels=int(levels.max()),
                groups_equal_scipy=groups,
                preprocessing_s=run[2], computation_s=run[3],
                engine_query_stats_s=fast_s, plain_engine_f_values_s=plain_s,
                scipy_s=time.perf_counter() - t0)


def _csr_level_bytes(torch, dg, carry, new_labels):
    """Bytes a level of K9 must move, counted two ways on this level's
    state: (a) from dist: the offsets, every distance word once, the cols
    of each vertex some query has not reached, the new labels; (b) on
    carried bits: the frontier and visited planes read
    once, the virtual rows and cols of the rows that some running query
    has not reached, the two planes and the union map written, the new
    labels."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import bfs

    n, k = dg.n, carry.dist.shape[0]
    w = -(-k // 32)
    deg = (dg.row_offsets[1:] - dg.row_offsets[:-1]).long()
    unreached = carry.dist == -1
    from_dist = (4 * (n + 1) + 4 * carry.dist.numel()
                 + 4 * int(deg[unreached.any(dim=0)].sum()) + 4 * new_labels)
    live = (unreached & bfs.level_active(carry)[:, None]).any(dim=0)
    owner = dg.vrows[:, 2].long()
    live_pieces = int(live[owner].sum())
    live_slots = int((dg.vrows[:, 1] - dg.vrows[:, 0])[live[owner]].sum())
    on_bits = (8 * n * w + 12 * live_pieces + 4 * live_slots + 8 * n * w + n // 8
               + 4 * new_labels)
    return from_dist, on_bits, live_pieces, live_slots


def _csr_pull_row(torch, np, dg, padded, layout, label):
    """K9 over one BFS: every level's launches timed together (CUDA
    events behind a queued device sleep), then on level 0 (stale: pack,
    walk, apply) and on the level that labels most (query, vertex) pairs
    (steady: walk, apply) the kernel held against its planes plain version
    (every carry field and plane, bit for bit) and against the JAX-shaped
    plain version (the carry), the level timed whole and split by launch
    (events between the phases, the median of five), beside both bounds
    and the torch composition of the JAX expansion (the frontier flag
    gathered over ``cols``, then ``index_reduce_`` amax over
    ``edge_src``, before the unreached mask)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_csr, packed,
    )

    n = dg.n

    def fresh():
        carry = (bfs.distance_carry_init(n, padded, device=dg.device) if layout == "rows"
                 else packed.packed_carry_init(dg, padded))
        bfs.arm_chunk(carry, None, None)
        cuda_csr.csr_planes(dg, carry)  # allocated, stale
        return carry

    def level_ms(carry):
        """The level's ms and each phase's: an event before and after each
        launch, all enqueued behind a device sleep."""
        phases = [p for p in cuda_csr.PHASE_NAMES
                  if carry.planes.valid is False or p != cuda_csr.PHASE_PACK]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
        torch.cuda._sleep(2_000_000)  # the level's wrapper calls fall in the sleep
        ev[0].record()
        for i, p in enumerate(phases):
            cuda_csr.csr_pull(dg, carry, phases=p)
            ev[i + 1].record()
        ev[-1].synchronize()
        split = {cuda_csr.PHASE_NAMES[p]: ev[i].elapsed_time(ev[i + 1])
                 for i, p in enumerate(phases)}
        return ev[0].elapsed_time(ev[-1]), split

    carry, new, levels_ms, levels_split = fresh(), [], [], []
    while int(carry.ctrl[0]):
        before = int((carry.dist == -1).sum())
        ms, split = level_ms(carry)
        levels_ms.append(ms)
        levels_split.append(split)
        new.append(before - int((carry.dist == -1).sum()))
    widest = int(np.argmax(new))
    names = ("dist", "level", "updated", "stop", "found", "ctrl")
    planes = ("frontier", "visited", "hits", "aux", "union")
    cols, src = dg.col_indices.long(), dg.edge_src.long()
    rows = layout == "rows"
    out = torch.zeros((padded.shape[0], n) if rows else (n, padded.shape[0]),
                      dtype=torch.uint8, device=dg.device)

    def at(level):
        """The kernel against both plain versions on ``level`` of the BFS,
        each timed: the level, its phases, the plain versions, the
        library composition; with both bounds."""
        carry = fresh()
        for _ in range(level):
            cuda_csr.csr_pull(dg, carry)
        snap = _clone(torch, carry)
        stale = not snap.planes.valid
        got, want, jax_like = (_clone(torch, snap) for _ in range(3))
        cuda_csr.csr_pull(dg, got)
        cuda_csr.csr_level_planes_plain(dg, want)
        cuda_csr.csr_pull_plain(dg, jax_like)
        torch.cuda.synchronize()
        err = _carry_err(torch, got, want, names)
        err = max(err, _carry_err(torch, got.planes, want.planes, planes))
        err = max(err, _carry_err(torch, got, jax_like, names[:4]))
        work = _clone(torch, snap)
        restore = functools.partial(_restore, torch, work, snap)
        ms = _time_ms(torch, lambda: cuda_csr.csr_pull(dg, work), restore)
        splits = []
        for _ in range(5):
            restore()
            splits.append(level_ms(work)[1])
        phase_ms = {k: sorted(x[k] for x in splits)[2] for k in splits[0]}
        planes_plain_ms = _time_ms(
            torch, lambda: cuda_csr.csr_level_planes_plain(dg, work), restore, reps=3)
        plain_ms = _time_ms(torch, lambda: cuda_csr.csr_pull_plain(dg, work), restore, reps=3)
        dist, lv = snap.dist, snap.level

        def library():
            if rows:
                out.index_reduce_(1, src, (dist == lv[:, None]).to(torch.uint8)[:, cols],
                                  "amax")
            else:
                out.index_reduce_(0, src, (dist.T == lv[None, :]).to(torch.uint8)[cols],
                                  "amax")
        library_ms = _time_ms(torch, library, lambda: out.zero_(), reps=5)
        from_dist, on_bits, pieces, slots = _csr_level_bytes(torch, dg, snap, new[level])
        bound_dist = _bound_ms(from_dist, 0)[0]
        bound, by = _bound_ms(on_bits, 0)
        return dict(level=level, stale=stale, new_labels=new[level], max_abs_err=err, ms=ms,
                    phase_ms=phase_ms, plain_ms=plain_ms, planes_plain_ms=planes_plain_ms,
                    bound_ms=bound, bound_by=by, bound_bytes=on_bits,
                    bound_from_dist_ms=bound_dist, bound_from_dist_bytes=from_dist,
                    live_pieces=pieces, live_slots=slots, library_ms=library_ms)

    first = at(0)
    top = at(widest)
    row = dict(top, bfs_levels_ms=levels_ms, bfs_ms=sum(levels_ms), bfs_new_labels=new,
               bfs_phase_ms=levels_split,
               level0=first,
               library="frontier flags gathered over cols + index_reduce_ amax",
               layout=layout, card=CARD)
    print(f"compare {label} csr_pull ({layout}): " + json.dumps(row))
    assert first["max_abs_err"] == 0 and top["max_abs_err"] == 0, row
    return row


# The thin level of a push BFS: the first whose compaction lists fewer new
# entries (push) or union rows (ppush).
THIN_ENTRIES = 4096


def _events(torch, n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


# Device cycles slept before a launch timed on its own (about 1 ms), so that
# its wrapper's host time falls inside the sleep and not in the events' span.
HOST_SLACK = 2_000_000


def _push_levels(torch, adj, make, capacity):
    """Every level of one push BFS at ``capacity``: its queued entries,
    the tiles K10 marks, the new entries K11 lists, and each kernel's
    device ms (CUDA events around each launch, behind a queued device
    sleep; the flags are read between the two)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_push, push,
    )

    csr = push.table_csr(adj)
    carry, rows = make(), []
    while bool(carry.running(None)):
        entries = int(torch.clamp(carry.count, max=capacity).sum())
        ev = _events(torch, 4)
        torch.cuda._sleep(HOST_SLACK)
        ev[0].record()
        cuda_push.queue_expand(adj.rows, carry, csr)
        ev[1].record()
        ev[1].synchronize()
        touched = int(carry.touched.sum())
        torch.cuda._sleep(HOST_SLACK)
        ev[2].record()
        cuda_push.queue_compact(carry)
        ev[3].record()
        ev[3].synchronize()
        rows.append(dict(level=len(rows), entries=entries, touched_tiles=touched,
                         new=int(carry.count.sum()), expand_ms=ev[0].elapsed_time(ev[1]),
                         compact_ms=ev[2].elapsed_time(ev[3])))
    return rows


def _ppush_levels(torch, adj, make, capacity):
    """Every level of one ppush BFS: its union rows and listed rows, the
    next frontier's rows, and K3's and K11's (row mode) device ms (CUDA
    events around each launch, behind a queued device sleep)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, bitbell, cuda_push, push,
    )

    start, vals, _ = push.table_csr(adj)
    carry, rows = make(), []
    while bool(carry.running(None)):
        union, listed = int(carry.count[0]), int(carry.switch.state[0])
        ev = _events(torch, 4)
        torch.cuda._sleep(HOST_SLACK)
        ev[0].record()
        bitbell.sparse_hits_or(carry.frontier, start, vals, carry.hits, carry.ctrl,
                               carry.switch, bfs.INT32_MAX)
        ev[1].record()
        torch.cuda._sleep(HOST_SLACK)
        ev[2].record()
        cuda_push.row_compact(carry, bfs.INT32_MAX)
        ev[3].record()
        ev[3].synchronize()
        rows.append(dict(level=len(rows), union_rows=union, listed=listed,
                         new_rows=int(carry.count[0]), push_or_ms=ev[0].elapsed_time(ev[1]),
                         compact_ms=ev[2].elapsed_time(ev[3])))
    return rows


def _level_sums(rows, keys):
    return {f"{k}_sum": sum(r[k] for r in rows) for k in keys} | {
        f"{k}_max": max(r[k] for r in rows) for k in keys}


def _thin_level(rows, key):
    """The first level whose compaction lists fewer than THIN_ENTRIES."""
    return next(r["level"] for r in rows if r[key] < THIN_ENTRIES)


def _queue_pair(torch, adj, snap, capacity, label, level, kind):
    """K10 and K11 (queue mode) on one level's carry ``snap``: each against
    its plain version (every carry field, the tile flags too, and the
    queues' meaningful entries), timed beside its bound (and the bound of
    a design that reads the padded table and the whole hit plane) and its
    library yardstick (``index_fill_`` of the gathered neighbours' flat ids; the
    compaction's exclusive ``cumsum`` and ``scatter_`` into a (capacity +
    1) buffer)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_push, push,
    )

    n, rows = adj.n, adj.rows
    csr = push.table_csr(adj)
    k, pitch = snap.hit.shape
    tiles = snap.touched.shape[1]
    fields = ("visited", "hit", "touched", "count", "f", "levels", "reached", "level",
              "updated", "stop", "max_count")

    def queue_err(got, want):
        err = _carry_err(torch, got, want, fields)
        err = max(err, _max_abs_err(torch, [(got.ctrl[[0, 2]], want.ctrl[[0, 2]])]))
        for q in range(k):
            m = min(int(want.count[q]), capacity)
            err = max(err, _max_abs_err(torch, [(got.queue[q, :m], want.queue[q, :m])]))
        return err

    # K10.
    got, want = _clone(torch, snap), _clone(torch, snap)
    cuda_push.queue_expand(rows, got, csr)
    cuda_push.queue_expand_plain(rows, want)
    torch.cuda.synchronize()
    expand_err = queue_err(got, want)
    post = _clone(torch, got)
    work = _clone(torch, snap)

    def clear():
        work.hit.zero_()
        work.touched.zero_()

    entries = torch.clamp(snap.count, max=capacity)
    listed = int(entries.sum())
    nbrs = rows[snap.queue.long()]  # (K, capacity, w)
    live = (torch.arange(capacity, device=rows.device) < entries[:, None])[:, :, None]
    live = live & (nbrs != n)
    qoff = (torch.arange(k, device=rows.device) * pitch)[:, None, None]
    flat = (qoff + nbrs)[live]
    walked = int(live.sum())
    hits_set = int((post.hit != 0).sum())
    touched = int(post.touched.sum())
    expand = dict(
        level=level, entries=listed, edges_walked=walked, hit_bytes=hits_set,
        touched_tiles=touched, max_abs_err=expand_err,
        ms=_time_ms(torch, lambda: cuda_push.queue_expand(rows, work, csr), clear),
        plain_ms=_time_ms(torch, lambda: cuda_push.queue_expand_plain(rows, work), clear,
                          reps=3),
        library_ms=_time_ms(torch, lambda: work.hit.view(-1).index_fill_(0, flat, 1),
                            work.hit.zero_),
        library="index_fill_ of the gathered neighbours' flat ids (the gather outside)",
    )
    # The listed ids, their CSR rows' starts and ends, the edges walked, a
    # hit byte an edge and a flag a touched tile, the counts.
    expand["bound_ms"], expand["bound_by"] = _bound_ms(
        12 * listed + 4 * walked + hits_set + touched + 4 * k, 0)
    expand["table_walk_bound_ms"] = _bound_ms(
        4 * listed * (1 + adj.width) + 4 * k + hits_set, 0)[0]
    print(f"compare {label} queue_expand ({kind} level {level}): "
          + json.dumps(dict(**expand, card=CARD)))
    # K11 on the expanded level.
    got, want = _clone(torch, post), _clone(torch, post)
    cuda_push.queue_compact(got)
    cuda_push.queue_compact_plain(want)
    torch.cuda.synchronize()
    compact_err = queue_err(got, want)
    new_total = int(want.count.sum())
    queued = int(torch.clamp(want.count, max=capacity).sum())
    work = _clone(torch, post)
    restore = functools.partial(_restore, torch, work, post)
    on = (post.hit & ~post.visited).to(torch.int32)
    buf = torch.empty((k, capacity + 1), dtype=torch.int32, device=rows.device)
    ids = torch.arange(pitch, dtype=torch.int32, device=rows.device).expand(k, pitch)

    def library():
        pos = torch.cumsum(on, dim=1, dtype=torch.int32) - on
        buf.scatter_(1, torch.where(on > 0, torch.clamp(pos, max=capacity), capacity).long(),
                     ids)

    compact = dict(
        level=level, new=new_total, queued=queued, touched_tiles=touched,
        max_abs_err=compact_err,
        ms=_time_ms(torch, lambda: cuda_push.queue_compact(work), restore),
        plain_ms=_time_ms(torch, lambda: cuda_push.queue_compact_plain(work), restore,
                          reps=3),
        library_ms=_time_ms(torch, library, lambda: None, reps=5),
        library="exclusive cumsum + scatter_ into a (capacity + 1) buffer",
    )
    # Read the flags and the touched tiles' hit bytes, visited where a hit
    # is set; write the new visited bytes, clear the set hit bytes and the
    # flags, write the queued ids and the per-query counters.
    compact["bound_ms"], compact["bound_by"] = _bound_ms(
        k * tiles + touched + min(touched * cuda_push.TILE_BYTES, k * pitch)
        + 2 * hits_set + new_total + 4 * queued + 40 * k, 0)
    compact["whole_plane_bound_ms"] = _bound_ms(
        k * pitch + 2 * hits_set + new_total + 4 * queued + 40 * k, 0)[0]
    print(f"compare {label} queue_compact ({kind} level {level}, queue mode): "
          + json.dumps(dict(**compact, card=CARD)))
    assert expand_err == 0 and compact_err == 0, (expand, compact)
    return expand, compact


def _queue_rows(torch, np, adj, padded, capacity, label):
    """K10 and K11 (queue mode) on the BFS's widest level (the most queued
    entries) and its thin level at the engine's capacity (``_queue_pair``);
    and every level's kernels timed on their own (detail JSON)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_push, push,
    )

    n, rows = adj.n, adj.rows

    def make():
        carry = cuda_push.queue_carry_init(n, rows, padded, capacity)
        bfs.arm_chunk(carry, None, None)
        return carry

    levels = _push_levels(torch, adj, make, capacity)
    keys = ("expand_ms", "compact_ms")
    print(f"{label} push levels: " + json.dumps(dict(
        levels=len(levels), device_ms_sum=sum(r["expand_ms"] + r["compact_ms"] for r in levels),
        device_ms_max=max(r["expand_ms"] + r["compact_ms"] for r in levels),
        **_level_sums(levels, keys), capacity=capacity,
        detail=_write_detail("push_road1024_levels", levels),
        note="queue_expand and queue_compact of every level, CUDA events behind a "
             "queued device sleep (device time only)", card=CARD)))
    widest = max(levels, key=lambda r: r["entries"])["level"]
    thin = _thin_level(levels, "new")
    out = {}
    for kind, level in (("thin", thin), ("widest", widest)):
        carry = make()
        for _ in range(level):
            push.push_level(adj, carry)
        out[kind] = _queue_pair(torch, adj, _clone(torch, carry), capacity, label, level, kind)
    return out["widest"]


def _row_pair(torch, adj, carry, label, level, kind):
    """K3 and K11's row mode on one level's carry: the level against its
    plain version (every field, the worklist's meaningful entries), and
    each kernel timed alone, K11 beside its bound."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, bitbell, cuda_push, push, push_packed,
    )

    start, vals, _ = push.table_csr(adj)
    got, want = _clone(torch, carry), _clone(torch, carry)
    push_packed.packed_push_level(adj, got, bfs.INT32_MAX)
    push_packed.packed_push_level(adj, want, bfs.INT32_MAX, plain=True)
    torch.cuda.synchronize()
    names = ("visited", "frontier", "hits", "f", "levels", "reached", "counts", "count",
             "peak", "ctrl")
    err = _carry_err(torch, got, want, names)
    m = int(want.switch.state[0])
    err = max(err, _max_abs_err(torch, [(got.switch.state[:2], want.switch.state[:2]),
                                         (got.switch.worklist[:, :m],
                                          want.switch.worklist[:, :m])]))
    post = _clone(torch, carry)
    bitbell.sparse_hits_or(post.frontier, start, vals, post.hits, post.ctrl, post.switch)
    work = _clone(torch, carry)
    push_or_ms = _time_ms(
        torch, lambda: bitbell.sparse_hits_or(work.frontier, start, vals, work.hits,
                                              work.ctrl, work.switch),
        work.hits.zero_)
    work = _clone(torch, post)
    restore = functools.partial(_restore, torch, work, post)
    rows_n, w = post.hits.shape
    hit_words = int((post.hits != 0).sum())
    listed_edges = int(carry.switch.state[1])
    row = dict(
        level=level, union_rows=int(carry.count[0]), listed=int(carry.switch.state[0]),
        listed_edges=listed_edges, new_rows=int(want.count[0]), max_abs_err=err,
        push_or_ms=push_or_ms,
        ms=_time_ms(torch, lambda: cuda_push.row_compact(work), restore),
        plain_ms=_time_ms(torch, lambda: cuda_push.row_compact_plain(work), restore, reps=3),
        library_ms=None,
    )
    # Read the hit plane once, visited where a hit word is set; write the
    # frontier plane, the changed visited words, the cleared hit words and
    # the listed rows' ids and first edges (reading their out-degrees).
    row["bound_ms"], row["bound_by"] = _bound_ms(8 * rows_n * w + 8 * hit_words + 12 * m, 0)
    # K3 on the union queue: the listed rows' ids, first edges and words,
    # the edges walked and a hit word each.
    row["push_or_bound_ms"] = _bound_ms(8 * row["listed"] + 4 * w * row["listed"]
                                        + (4 + 4 * w) * listed_edges, 0)[0]
    print(f"compare {label} queue_compact ({kind} level {level}, row mode, with push_or): "
          + json.dumps(dict(**row, card=CARD)))
    assert err == 0, row
    return row


def _row_queue_row(torch, np, adj, padded, capacity, label):
    """K3 and K11's row mode (the ppush level) on the BFS's widest level
    (the most union rows) and its thin level at the engine's capacity
    (``_row_pair``); and every level's kernels timed on their own (detail
    JSON)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, push_packed,
    )

    qp = push_packed._pad_rows(padded, push_packed._k_pad(padded.shape[0]))

    def make():
        return push_packed._packed_init_batch(adj, qp, capacity)

    levels = _ppush_levels(torch, adj, make, capacity)
    keys = ("push_or_ms", "compact_ms")
    print(f"{label} ppush levels: " + json.dumps(dict(
        levels=len(levels),
        device_ms_sum=sum(r["push_or_ms"] + r["compact_ms"] for r in levels),
        device_ms_max=max(r["push_or_ms"] + r["compact_ms"] for r in levels),
        **_level_sums(levels, keys), capacity=capacity,
        detail=_write_detail("ppush_road1024_levels", levels),
        note="push_or and queue_compact (row mode) of every level, CUDA events behind "
             "a queued device sleep (device time only)", card=CARD)))
    widest = max(levels, key=lambda r: r["union_rows"])["level"]
    thin = _thin_level(levels, "new_rows")
    out = {}
    for kind, level in (("thin", thin), ("widest", widest)):
        carry = make()
        for _ in range(level):
            push_packed.packed_push_level(adj, carry, bfs.INT32_MAX)
        out[kind] = _row_pair(torch, adj, carry, label, level, kind)
    return out["widest"]


def _capacity_trail(eng, padded):
    """The capacities one auto-capacity call ran at, then the one it
    left."""
    trail = []
    dispatch = eng._dispatch

    def recorded(queries):
        trail.append(eng.capacity)
        return dispatch(queries)

    eng._dispatch = recorded
    eng.f_values(padded)
    eng._dispatch = dispatch
    return trail + [eng.capacity]


def _assert_csr_variants(path, layout):
    """A K9 path ran its layout only: a pack on each stale level (one a
    chunk), walk and apply on every level, more steady levels than
    stale ones."""
    got = VARIANTS[path]
    kinds = {f"csr_pull:{layout}/{state}/{phase}" for state, phase in (
        ("stale", "pack"), ("stale", "walk"), ("stale", "apply"),
        ("steady", "walk"), ("steady", "apply"))}
    assert set(got) == kinds, (path, got)
    stale = got[f"csr_pull:{layout}/stale/pack"]
    assert got[f"csr_pull:{layout}/stale/walk"] == got[f"csr_pull:{layout}/stale/apply"] == stale
    assert got[f"csr_pull:{layout}/steady/walk"] == got[f"csr_pull:{layout}/steady/apply"] > stale


def _single_device_phase(ctx, files, seed):
    """Phase 10: the five single-device routes through the CLI, each a
    counted path, with their engines against the plain engines and scipy,
    and their kernels held against their plain versions on real levels."""
    (torch, np, sp, cg, cli, tio, timing, launches, dev, g20, g14, g1) = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        dense, engine, packed, push, push_packed,
    )

    rows, cache = {}, {}

    def scipy_of(label, queries, a):
        def stats(q):
            if (label, q) not in cache:
                cache[label, q] = _scipy_stats(cg, np, a, queries[q])
            return cache[label, q]

        return stats

    # -- RMAT-20, K = 64: vmap (K9, rows), packed (K9, query-minor).
    argv = ["chip_smoke", "-g", files["rmat20"][0], "-q", files["rmat20"][1], "-gn", "1"]
    queries = files["rmat20"][2]
    scipy = scipy_of("rmat-20", queries, files["rmat20"][3])
    cache.update({("rmat-20", q): v for q, v in files["rmat20"][4].items()})
    padded = tio.pad_queries(queries)
    dg = g20.to_device(dev)
    with _env(MSBFS_BACKEND="vmap"):
        run = _run_path(cli, timing, argv, "vmap rmat-20", launches)
    _assert_csr_variants("vmap rmat-20", "rows")
    summary = _engine_check(np, "vmap rmat-20", engine.Engine(dg, level_chunk=128),
                            engine.Engine(dg, level_chunk=128, plain=True), padded, scipy, run)
    print("vmap rmat-20: " + json.dumps(dict(**summary, card=CARD)))
    rows["csr_pull"] = _csr_pull_row(torch, np, dg, padded, "rows", "rmat-20 K=64")
    with _env(MSBFS_BACKEND="packed"):
        run = _run_path(cli, timing, argv, "packed rmat-20", launches)
    _assert_csr_variants("packed rmat-20", "minor")
    with _env(MSBFS_BACKEND="packed", MSBFS_EDGE_CHUNKS="4"):
        chunked = _run_cli(cli, argv)
    assert chunked[:2] == run[:2], (chunked, run)
    summary = _engine_check(np, "packed rmat-20", packed.PackedEngine(dg, level_chunk=128),
                            packed.PackedEngine(dg, level_chunk=128, edge_chunks=4, plain=True),
                            padded, scipy, run)
    print("packed rmat-20: " + json.dumps(dict(**summary, edge_chunks_4_same=True, card=CARD)))
    _csr_pull_row(torch, np, dg, padded, "minor", "rmat-20 K=64")
    del dg
    torch.cuda.empty_cache()

    # -- RMAT-14, K = 64: dense (a bf16 matmul a level, no kernel of its own).
    argv = ["chip_smoke", "-g", files["rmat14"][0], "-q", files["rmat14"][1], "-gn", "1"]
    queries = files["rmat14"][2]
    padded = tio.pad_queries(queries)
    with _env(MSBFS_BACKEND="dense"):
        run = _run_path(cli, timing, argv, "dense rmat-14", launches)
    dgr = dense.DenseGraph.from_host(g14, dev)
    summary = _engine_check(np, "dense rmat-14", engine.Engine(dgr, level_chunk=128),
                            engine.Engine(dgr, level_chunk=128, plain=True), padded,
                            scipy_of("rmat-14", queries, _scipy_matrix(sp, np, g14)), run)
    frontier = (torch.rand((padded.shape[0], dgr.n_pad), device=dev) < 0.01).to(torch.bfloat16)
    matmul_ms = _time_ms(torch, lambda: torch.matmul(frontier, dgr.adjacency), lambda: None)
    print("dense rmat-14: " + json.dumps(dict(
        **summary, n_pad=dgr.n_pad, matmul_ms_a_level=matmul_ms,
        matmul_bound_ms=_bound_ms(2 * dgr.n_pad ** 2 + 6 * padded.shape[0] * dgr.n_pad,
                                  2 * padded.shape[0] * dgr.n_pad ** 2, 989e12)[0],
        card=CARD)))
    del dgr, frontier
    torch.cuda.empty_cache()

    # -- road-1024, K = 16: push (K10, K11), ppush (K3, K11's row mode),
    # and the push engine's growth trajectory against the plain engine's.
    argv = ["chip_smoke", "-g", files["road1024"][0], "-q", files["road1024"][1], "-gn", "1"]
    queries = files["road1024"][2]
    scipy = scipy_of("road-1024", queries, _scipy_matrix(sp, np, g1))
    padded = tio.pad_queries(queries)
    adj = push.PaddedAdjacency.from_host(g1, dev)
    for name, cls in (("push road-1024", push.PushEngine),
                      ("ppush road-1024", push_packed.PackedPushEngine)):
        t0 = time.perf_counter()
        with _env(MSBFS_BACKEND=name.split()[0]):
            run = _run_path(cli, timing, argv, name, launches)
        t1 = time.perf_counter()
        trail = plain_trail = None
        if cls is push.PushEngine:  # one growing batch; ppush grows in its run above
            trail = _capacity_trail(cls(adj), padded)
            plain_trail = _capacity_trail(cls(adj, plain=True), padded)
            assert trail == plain_trail and trail[-1] > trail[0], (name, trail, plain_trail)
        t2 = time.perf_counter()
        fast, plain = cls(adj), cls(adj, plain=True)
        summary = _engine_check(np, name, fast, plain, padded, scipy, run)
        try:
            cls(adj, capacity=SMALL_CAPACITY).f_values(padded)
        except push.FrontierOverflow as exc:
            overflow = str(exc)
        else:
            raise AssertionError(f"{name}: capacity {SMALL_CAPACITY} did not overflow")
        t3 = time.perf_counter()
        print(f"{name}: " + json.dumps(dict(
            **summary, engine_capacity=fast.capacity,
            road_1024_capacity_trajectory=trail,
            road_1024_plain_capacity_trajectory=plain_trail,
            explicit_capacity=SMALL_CAPACITY, frontier_overflow=overflow,
            wall_s=dict(cli=t1 - t0, trajectories=t2 - t1, engines_and_scipy=t3 - t2),
            card=CARD)))
        if cls is push.PushEngine:
            assert "queue_compact:queue" in VARIANTS[name], VARIANTS[name]
            rows["queue_expand"], rows["queue_compact"] = _queue_rows(
                torch, np, adj, padded, fast.capacity, "road-1024 K=16")
        else:
            assert "queue_compact:rows" in VARIANTS[name], VARIANTS[name]
            _row_queue_row(torch, np, adj, padded, fast.capacity, "road-1024 K=16")
    del adj
    torch.cuda.empty_cache()
    return rows


_ROOT = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def _env(**values):
    """Set environment knobs for one CLI run, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_path(cli, timing, argv, name, launches, mesh_devices=None):
    """One CLI run as one path: counters zeroed before, read after, and the
    preprocessing span printed split into its phases."""
    timing.reset_launch_counts()
    result = _run_cli(cli, argv, mesh_devices=mesh_devices)
    counts = timing.launch_counts()
    launches[name] = counts
    phases = timing.phase_seconds()
    print(f"{name} launches: {json.dumps(counts)}")
    VARIANTS[name] = timing.variant_counts()
    print(f"{name} variants: {json.dumps(VARIANTS[name])}")
    for kernel in PATH_KERNELS[name]:
        assert counts.get(kernel, 0) > 0, f"{kernel} never launched on {name}"
    if name in BYTE_PATHS:
        assert "forest_or" not in counts and "push_or" not in counts, (name, counts)
    if "batch_start" in PATH_KERNELS[name]:
        stride = 8 if name in BYTE_PATHS else 1
        want = f"batch_start:stride{stride}" + ("/switch" if name in SWITCHED_PATHS else "")
        starts = {k: v for k, v in VARIANTS[name].items() if k.startswith("batch_start:")}
        assert list(starts) == [want], (name, starts)
    print(f"preprocessing {name}: " + json.dumps(dict(
        native=dict(span=result[2], **phases), computation_s=result[3], card=CARD, host=HOST)))
    return result


def _runs(seq):
    """Run-length form of a direction sequence: "push x3, matmul x5"."""
    out = []
    for d in seq:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return ", ".join(f"{d} x{c}" for d, c in out)


def _mxu_path(ctx, name, n, edges, g, k, seed):
    """The mxu route through the CLI on one graph, then every F against
    scipy and the plain engine, and the direction trace."""
    torch, np, sp, cg, cli, tio, timing, generators, mxu, dev, tmp, launches = ctx
    gpath = os.path.join(tmp, f"{name.split()[1]}.bin")
    qpath = os.path.join(tmp, f"{name.split()[1]}-q.bin")
    queries = generators.random_queries(n, k, seed=seed)
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    with _env(MSBFS_BACKEND="mxu", MSBFS_MXU_KERNEL="1"):
        min_k, min_f, pre_s, comp_s = _run_path(
            cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"],
            name, launches,
        )
    assert any(v.startswith("tile_hits:pipe") for v in VARIANTS[name]), VARIANTS[name]
    mg = mxu.MxuGraph.from_host(g, dev)
    padded = tio.pad_queries(queries)
    fast = mxu.MxuEngine(mg, level_chunk=128, kernel=True)
    _batch_start_check(torch, fast, mg.n, padded, name)
    plain = mxu.MxuEngine(mg, level_chunk=128, plain=True)
    t0 = time.perf_counter()
    levels, reached, f_fast = fast.query_stats(padded)
    fast_s = time.perf_counter() - t0
    f_plain = plain.f_values(padded).cpu().numpy()
    assert np.array_equal(f_fast, f_plain), (f_fast, f_plain)
    a = _scipy_matrix(sp, np, g)
    want = np.array([_scipy_f(cg, np, a, q) for q in queries])
    assert np.array_equal(f_fast, want), (f_fast, want)
    assert (min_k, min_f) == (int(np.argmin(want)), int(want.min()))
    trace = [s["direction"] for s in fast.level_direction_trace(padded)]
    assert len(trace) == int(levels.max()), (len(trace), int(levels.max()))
    depth = int(levels.max())
    print(f"{name}: " + json.dumps(dict(
        n=n, K=k, tiles=mg.nt, winner=min_k + 1, min_f=min_f, scipy_f=int(want.min()),
        all_f_equal_scipy=True, preprocessing_s=pre_s, computation_s=comp_s,
        levels=depth, engine_query_stats_s=fast_s,
        ms_per_level=comp_s * 1e3 / max(depth, 1), switch=fast.switch,
        push_budget=fast.push_budget, push_levels=trace.count("push"),
        matmul_levels=trace.count("matmul"),
    )))
    print(f"{name} directions: {_runs(trace)}")
    MXU_RUNS[name] = dict(gpath=gpath, qpath=qpath, queries=queries, fv=f_fast,
                          single_s=comp_s)
    _real_mxu_level(torch, mg, fast, padded, name)
    if set(trace) == {"push", "matmul"}:
        _mxu_hybrid(torch, mg, fast, padded, name)
    return trace


def _real_mxu_level(torch, mg, eng, padded, label):
    """tile_hits against its plain version, timed, on the frontier of the
    BFS's widest matmul level (``eng.last_direction_trace`` is the trace of
    this batch)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu,
    )

    matmul = [s for s in eng.last_direction_trace if s["direction"] == "matmul"]
    if not matmul:
        return
    widest = max(matmul, key=lambda s: s["active_rows"])
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.zeros_like(carry.frontier)
    for _ in range(widest["level"] - 1):
        eng._chunk(carry, 1, hits)
    frontier = carry.frontier
    assert int((frontier != 0).any(dim=1).sum()) == widest["active_rows"]
    mm = torch.tensor([1, 0, 0, bitbell.DIR_MATMUL], dtype=torch.int32, device=frontier.device)
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm)
    cuda_mxu.tile_matmul_hits_plain(*tiles, frontier, h_p, mm)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm),
                  lambda: None)
    print(f"real level {label} level={widest['level']} "
          f"frontier_rows={widest['active_rows']} tile_hits: "
          + json.dumps(dict(max_abs_err=err, ms=ms)))
    assert err == 0, (label, err)


def _scipy_matrix(sp, np, graph):
    """The graph's CSR as a scipy matrix, built once per graph."""
    return sp.csr_matrix(
        (np.ones(graph.col_indices.size, np.float32), graph.col_indices,
         graph.row_offsets), shape=(graph.n, graph.n),
    )


def _scipy_f(cg, np, a, sources):
    """F of one query group from scipy's multi-source BFS (unweighted) over
    the matrix ``a`` of :func:`_scipy_matrix`."""
    n = a.shape[0]
    src = np.unique(sources[(sources >= 0) & (sources < n)])
    if src.size == 0:
        return 0
    d = cg.dijkstra(a, directed=True, indices=src, unweighted=True, min_only=True)
    return int(d[np.isfinite(d)].sum())


def _host_layouts(torch, n, edges, g, bg, dev, t_csr, t_bell):
    """RMAT-20's host layouts, native against NumPy on this host: the CSR,
    the per-row dedup and the BELL forest must be byte-equal; each step's
    seconds both ways."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    t0 = time.perf_counter()
    g_np = CSRGraph.from_edges(n, edges, native=False)
    t_csr_np = time.perf_counter() - t0
    assert same(g.row_offsets, g_np.row_offsets) and same(g.col_indices, g_np.col_indices)
    del g_np
    seconds = {}
    dedup = {}
    for native in (True, False):
        t0 = time.perf_counter()
        dedup[native] = g.dedup_rows(native)
        seconds[native] = time.perf_counter() - t0
    assert all(same(a, b) for a, b in zip(dedup[True], dedup[False]))
    del dedup
    t0 = time.perf_counter()
    bg_np = BellGraph.from_host(g, dev, native=False)
    t_bell_np = time.perf_counter() - t0
    assert bg.level_shapes == bg_np.level_shapes and bg.fill == bg_np.fill
    for a, b in zip([*bg.level_cols, bg.final_slot, *bg.sparse],
                    [*bg_np.level_cols, bg_np.final_slot, *bg_np.sparse]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for (r1, f1), (r2, f2) in zip(bg._walk, bg_np._walk, strict=True):
        assert same(r1, r2) and same(f1, f2)
    del bg_np
    torch.cuda.empty_cache()
    print("rmat-20 host layouts: " + json.dumps(dict(
        byte_equal=dict(csr=True, dedup=True, bell=True),
        csr_s=dict(native=t_csr, numpy=t_csr_np),
        dedup_s=dict(native=seconds[True], numpy=seconds[False]),
        bell_with_dedup_and_upload_s=dict(native=t_bell, numpy=t_bell_np),
        card=CARD, host=HOST,
    )))


# ---- phase 11: the weighted route (K12, weighted_relax)

# Groups of each weighted path checked against scipy's Dijkstra (besides the
# winner).
WEIGHTED_GROUPS = 8


def _weighted_matrix(sp, np, n, edges, costs):
    """The weighted graph as a scipy matrix, built from the edge records
    and their costs alone (none of the port's loader or CSR): both
    directions of each record, self-loops dropped, parallel edges at their
    least cost (scipy would sum them)."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    c = np.asarray(costs, np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    w = np.concatenate([c, c])
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    first = np.ones(src.size, bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    starts = np.flatnonzero(first)
    least = np.minimum.reduceat(w, starts)
    return sp.csr_matrix((least.astype(np.float64), (src[starts], dst[starts])),
                         shape=(n, n))


def _dijkstra(cg, np, a, sources):
    """(n,) int64 weighted distance-to-set from scipy, -1 unreached."""
    n = a.shape[0]
    src = np.unique(sources[(sources >= 0) & (sources < n)])
    if src.size == 0:
        return np.full(n, -1, np.int64)
    d = cg.dijkstra(a, directed=True, indices=src, min_only=True)
    return np.where(np.isfinite(d), d, -1).astype(np.int64)


def _weighted_counted(cli, timing, argv, name, launches, rc_want=0):
    """A weighted CLI run as one path (counters zeroed before, read after):
    its exit code, and weighted_relax the only kernel it launched."""
    timing.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    counts = timing.launch_counts()
    launches[name] = counts
    print(buf.getvalue(), end="")
    print(f"{name} launches: {json.dumps(counts)} (exit {rc})")
    assert rc == rc_want, (name, rc)
    assert set(counts) == {"weighted_relax"}, (name, counts)
    return buf.getvalue()


def _weighted_engine_check(np, name, fast, plain, padded):
    """The kernel engine's F, counters and host reads against the plain
    engine's (relax_plain) on the card."""
    t0 = time.perf_counter()
    f_fast = fast.f_values(padded).numpy()
    fast_s = time.perf_counter() - t0
    stats, reads = fast.weighted_stats(), fast.last_host_reads
    t0 = time.perf_counter()
    f_plain = plain.f_values(padded).numpy()
    plain_s = time.perf_counter() - t0
    assert np.array_equal(f_fast, f_plain), (name, f_fast, f_plain)
    assert stats == plain.weighted_stats(), (name, stats, plain.weighted_stats())
    assert reads == plain.last_host_reads, (name, reads, plain.last_host_reads)
    return f_fast, stats, reads, fast_s, plain_s


def _k12_passes(torch, np, deltastep, eng, padded):
    """Two runs of ``eng``.  The first puts every K12 launch between CUDA
    events and adds nothing else (no host read, no copy), so its wall time
    is the engine's own.  The second counts each pass's active cells (a
    host read a pass) and keeps the inputs of the widest light and the
    widest heavy pass, and of the first pass with under 1 % of the cells
    active ("thin").  Returns (the first run's F, the kernel's total ms,
    the run's wall s, per-pass rows with the first run's ms, and the kept
    passes' inputs)."""
    real = deltastep.relax
    events, rows, kept = [], [], {}

    def timed(tent, active, side, p0, p1, delta, light, out=None):
        if out is None:
            out = tent.clone()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        real(tent, active, side, p0, p1, delta, light, out)
        e1.record()
        events.append((e0, e1))
        return out

    def snapped(tent, active, side, p0, p1, delta, light, out=None):
        cells = int(active.sum())
        rows.append(dict(light=bool(light), p0=p0, p1=p1, active_cells=cells))
        key = "light" if light else "heavy"
        wide = cells > kept.get(key, (-1,))[0]
        thin = "thin" not in kept and cells < 0.01 * active.numel()
        if wide or thin:
            snap = (cells, tent.clone(), active.clone(), p0, p1, bool(light))
            if wide:
                kept[key] = snap
            if thin:
                kept["thin"] = snap
        return real(tent, active, side, p0, p1, delta, light, out)

    try:
        deltastep.relax = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = eng.f_values(padded).numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        deltastep.relax = snapped
        f_snapped = eng.f_values(padded).numpy()
    finally:
        deltastep.relax = real
    assert np.array_equal(f, f_snapped) and len(rows) == len(events), (len(rows), len(events))
    for r, (e0, e1) in zip(rows, events):
        r["ms"] = e0.elapsed_time(e1)
    return f, sum(r["ms"] for r in rows), wall, rows, kept


def _profile_split(torch, fn, top=8):
    """One call of ``fn`` under torch.profiler: its wall ms (profiled),
    the device's busy ms and share (the summed device events of the one
    stream), the device ms by kernel name and the host ops' self ms, each
    the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _op_name(e.name)
            dev[name] = dev.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    host = sorted(((a.key, a.self_cpu_time_total / 1e3) for a in prof.key_averages()),
                  key=lambda kv: -kv[1])[:top]
    busy = sum(dev.values())
    return dict(source="torch.profiler", wall_ms=wall_ms, device_busy_ms=busy,
                busy_share=busy / wall_ms, device_ms=dict(sorted(
                    dev.items(), key=lambda kv: -kv[1])[:top]), host_self_ms=dict(host))


def _k12_compare(torch, np, cuda_weighted, eng, snap, label, library):
    """K12 on one real pass (a bitbell engine's: every slot is in its
    range) against relax_plain, bit for bit, both timed, beside the bound,
    the design's floor and (with ``library``) scatter_reduce_ "amin" of
    the same candidates, built in advance, along the vertex axis of the
    query-minor plane."""
    cells, tent, active, p0, p1, light = snap
    side, delta = eng._sides[0 if light else 1], eng.delta
    ns, k = tent.shape
    out = torch.empty_like(tent)
    out_p = torch.empty_like(tent)
    s0, s1 = side.slot_range(p0, p1)
    cuda_weighted.relax(tent, active, side, p0, p1, delta, light, out=out.copy_(tent))
    cuda_weighted.relax_plain(tent, active, side.u, side.v, side.w, delta, light, s0, s1,
                              out=out_p.copy_(tent))
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(out, out_p)])
    assert err == 0, (label, err)
    ms = _time_ms(torch, lambda: cuda_weighted.relax(tent, active, side, p0, p1, delta, light,
                                                     out=out),
                  lambda: out.copy_(tent))
    plain_ms = _time_ms(torch, lambda: cuda_weighted.relax_plain(
        tent, active, side.u, side.v, side.w, delta, light, s0, s1, out=out_p),
        lambda: out_p.copy_(tent), reps=3, warm=1)
    width = int(eng._u_host.size)
    selected = s1 - s0
    pieces = side.pieces[p0:p1].long()
    owners = pieces[:, 2]
    # What this pass's inputs need, each read once: v and w of the selected
    # slots, the (start, end, owner) entry of each piece of the run, the
    # active run of each row those pieces own, tent where those rows are
    # active, and the cells of out that improve (out's copy of tent is
    # restored outside the timed call).  Operations: one offer a slot and
    # query active at its row.
    rows = torch.zeros(ns, dtype=torch.bool, device=tent.device)
    rows[owners] = True
    need_rows = int(rows.sum())
    per_row = active.sum(dim=1)
    need_cells = int(per_row[rows].sum())
    offers = int(per_row[side.u[s0:s1].long()].sum())
    improved = int((out_p != tent).sum())
    nbytes = 8 * selected + 12 * (p1 - p0) + k * need_rows + 4 * need_cells + 4 * improved
    bound_ms, bound_by = _bound_ms(nbytes, offers)
    # The earlier count, which charged w over the flavor's whole range and
    # u for every selected slot (the slot-a-thread design's inputs), for
    # reading before and after on one yardstick.
    prior_bytes = 4 * width + 8 * selected + k * need_rows + 4 * need_cells + 4 * improved
    prior_bound_ms, _ = _bound_ms(prior_bytes, k * selected)
    # The design's floor: each piece's entry and its owner's active run,
    # tent's run where the owner is active, and for each slot of an active
    # owner its v and w and its whole 4K-byte out run.
    hot = active.any(dim=1)[owners]
    hot_pieces = int(hot.sum())
    hot_slots = int(((pieces[:, 1] - pieces[:, 0]) * hot).sum())
    design_bytes = (12 + k) * (p1 - p0) + 4 * k * hot_pieces + (8 + 4 * k) * hot_slots
    design_ms, _ = _bound_ms(design_bytes, 0)
    library_ms = None
    if library:
        # The JAX-shaped candidates of the pass, built a slice at a time,
        # and their int64 index: the library call's inputs.
        cand = torch.empty((selected, k), dtype=torch.int32, device=tent.device)
        step = cuda_weighted.PLAIN_CHUNK_CELLS // k
        for c0 in range(0, selected, step):
            uu = side.u[s0 + c0:s0 + min(selected, c0 + step)].long()
            ws = side.w[s0 + c0:s0 + c0 + uu.shape[0], None]
            cand[c0:c0 + uu.shape[0]] = torch.where(active[uu], tent[uu] + ws,
                                                    cuda_weighted.INF)
        idx = side.v[s0:s1].long()[:, None].expand(-1, k).contiguous()
        lib = torch.empty_like(tent)
        library_ms = _time_ms(torch, lambda: lib.scatter_reduce_(0, idx, cand, "amin"),
                              lambda: lib.copy_(tent), reps=5, warm=1)
        assert torch.equal(lib, out_p), label
        del cand, idx, lib
        torch.cuda.empty_cache()
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    print(f"compare {label} weighted_relax ({'light' if light else 'heavy'} pass, "
          f"{cells} active cells): " + json.dumps(dict(
              **row, K=k, n_state=ns, slots=width, selected_slots=selected,
              pieces=p1 - p0, pieces_of_active_rows=hot_pieces,
              slots_of_active_rows=hot_slots, rows_read=need_rows,
              tent_cells_read=need_cells, offers=offers, cells_improved=improved,
              bound_bytes=nbytes, prior_bound_bytes=prior_bytes,
              prior_bound_ms=prior_bound_ms, design_bytes=design_bytes,
              design_floor_ms=design_ms,
              plan=cuda_weighted.relax_plan(k, True), card=CARD)))
    return row


def _weighted_phase(ctx, n20, e20, queries20, n5, e5, seed):
    """Phase 11: the weighted route through the CLI on RMAT-20 (K = 64),
    road-512 (every flavor, and delta = 1) and road-128 (the audit, the
    plane seam and ``verify``); K12 held and timed on RMAT-20's real
    passes."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import weighted
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        certify, cuda_weighted,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import faults
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.weighted import (
        deltastep,
    )

    t_phase = time.perf_counter()
    steps = _Steps("phase 11")
    # -- 11a. RMAT-20, K = 64, the auto (bitbell) flavor.
    t0 = time.perf_counter()
    costs20 = generators.edge_costs(len(e20), "uniform", max_cost=16, seed=seed + 3)
    gpath = os.path.join(tmp, "rmat20-w.bin")
    qpath = os.path.join(tmp, "rmat20-wq.bin")
    tio.save_graph_bin(gpath, n20, e20, costs20)
    tio.save_query_bin(qpath, queries20)
    g = tio.load_graph_bin(gpath)
    padded = tio.pad_queries(queries20)
    host_s = time.perf_counter() - t0
    argv = ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"]
    with _env(MSBFS_WEIGHTED="1"):
        min_k, min_f, pre_s, comp_s = _run_path(cli, timing, argv, "weighted rmat-20", launches)
    assert set(launches["weighted rmat-20"]) == {"weighted_relax"}, launches["weighted rmat-20"]
    fast = weighted.WeightedBitBellEngine(g, device=dev)
    plain = weighted.WeightedBitBellEngine(g, device=dev, plain=True)
    f_fast, stats, reads, fast_s, plain_s = _weighted_engine_check(
        np, "weighted rmat-20", fast, plain, padded)
    assert (min_k, min_f) == (int(np.argmin(f_fast)), int(f_fast.min())), (min_k, min_f)
    dist = fast.distances(padded)
    a = _weighted_matrix(sp, np, n20, e20, costs20)
    t0 = time.perf_counter()
    groups = sorted({min_k, *range(WEIGHTED_GROUPS)})
    for q, want in zip(groups, _scipy_map(_dijkstra, a, [padded[q] for q in groups])):
        assert np.array_equal(dist[q].astype(np.int64), want), q
    scipy_s = time.perf_counter() - t0
    del dist
    f, k12_ms, wall_s, passes, widest = _k12_passes(torch, np, deltastep, fast, padded)
    assert np.array_equal(f, f_fast)
    light = [r for r in passes if r["light"]]
    size = int(fast._u_host.size)
    assert len(light) * padded.shape[0] * size == stats["light_relaxations"], (len(light), stats)
    print("weighted rmat-20: " + json.dumps(dict(
        n=n20, K=padded.shape[0], dedup_slots=size, max_cost=fast.max_cost,
        winner=min_k + 1, min_f=min_f, groups_equal_scipy=len(groups),
        preprocessing_s=pre_s, computation_s=comp_s, **stats,
        light_passes=len(light), heavy_passes=len(passes) - len(light),
        host_reads=reads, engine_f_values_s=fast_s, plain_engine_f_values_s=plain_s,
        k12_ms_in_timed_run=k12_ms, timed_run_s=wall_s,
        k12_share_of_timed_run=k12_ms / 1e3 / wall_s,
        k12_share_of_cli_computation=k12_ms / 1e3 / comp_s,
        host_files_s=host_s, scipy_s=scipy_s, card=CARD)))
    print("weighted rmat-20 profile of one f_values: " + json.dumps(dict(
        **_profile_split(torch, lambda: fast.f_values(padded)), card=CARD)))
    _write_detail("weighted_rmat20_passes", passes)
    del plain
    torch.cuda.empty_cache()
    row = _k12_compare(torch, np, cuda_weighted, fast, widest["light"], "rmat-20 K=64",
                       library=True)
    _k12_compare(torch, np, cuda_weighted, fast, widest["heavy"], "rmat-20 K=64",
                 library=False)
    del fast, widest, g, a
    os.remove(gpath)
    torch.cuda.empty_cache()

    steps("11a rmat-20")
    # -- 11b. road-512, K = 8 groups of up to 8: every flavor, and delta 1.
    costs5 = generators.edge_costs(len(e5), "uniform", max_cost=16, seed=seed + 3)
    g5 = CSRGraph.from_edges(n5, e5, weights=costs5)
    gpath5 = os.path.join(tmp, "road512-w.bin")
    qpath5 = os.path.join(tmp, "road512-wq.bin")
    q5 = generators.random_queries(n5, 8, max_group=8, seed=seed + 16)
    tio.save_graph_bin(gpath5, n5, e5, costs5)
    tio.save_query_bin(qpath5, q5)
    padded5 = tio.pad_queries(q5)
    a5 = _weighted_matrix(sp, np, n5, e5, costs5)
    want5 = np.array([int(np.where(d >= 0, d, 0).sum())
                      for d in _scipy_map(_dijkstra, a5, list(padded5))])
    argv5 = ["chip_smoke", "-g", gpath5, "-q", qpath5, "-gn", "1"]
    results = {}
    for flavor in ("bitbell", "stencil", "mesh2d"):
        name = f"weighted-{flavor} road-512"
        with _env(MSBFS_WEIGHTED="1", MSBFS_WEIGHTED_ENGINE=flavor):
            results[name] = _run_path(cli, timing, argv5, name, launches)
        assert set(launches[name]) == {"weighted_relax"}, launches[name]
        _, fast5 = weighted.negotiate_weighted_engine(g5, flavor, device=dev)
        _, plain5 = weighted.negotiate_weighted_engine(g5, flavor, device=dev, plain=True)
        f5, stats5, reads5, fast_s, plain_s = _weighted_engine_check(
            np, name, fast5, plain5, padded5)
        assert np.array_equal(f5, want5), (name, f5, want5)
        if flavor == "bitbell":
            print(f"{name} profile of one f_values: " + json.dumps(dict(
                **_profile_split(torch, lambda: fast5.f_values(padded5)), card=CARD)))
            # K12 on thin passes: the run's passes, the widest, and the
            # first with under 1 % of the cells active.
            _, ms5, wall5, passes5, kept5 = _k12_passes(torch, np, deltastep, fast5, padded5)
            _write_detail("weighted_road512_passes", passes5)
            pass_ms = sorted(r["ms"] for r in passes5)
            print(f"{name} K12 passes: " + json.dumps(dict(
                passes=len(passes5), k12_ms_in_timed_run=ms5, timed_run_s=wall5,
                median_pass_ms=pass_ms[len(pass_ms) // 2], max_pass_ms=pass_ms[-1],
                passes_under_1pct_active=sum(
                    1 for r in passes5
                    if r["active_cells"] < 0.01 * fast5.n_state * padded5.shape[0]),
                card=CARD)))
            wide5 = max((kept5["light"], kept5["heavy"]), key=lambda snap: snap[0])
            _k12_compare(torch, np, cuda_weighted, fast5, wide5, "road-512 K=8 widest",
                         library=False)
            _k12_compare(torch, np, cuda_weighted, fast5, kept5["thin"], "road-512 K=8 thin",
                         library=False)
        print(f"{name}: " + json.dumps(dict(
            K=8, winner=results[name][0] + 1, min_f=results[name][1],
            preprocessing_s=results[name][2], computation_s=results[name][3], **stats5,
            host_reads=reads5, engine_f_values_s=fast_s, plain_engine_f_values_s=plain_s,
            launches=launches[name]["weighted_relax"], card=CARD)))
    name = "weighted delta=1 road-512"
    with _env(MSBFS_WEIGHTED="1", MSBFS_DELTA="1"):
        results[name] = _run_path(cli, timing, argv5, name, launches)
    assert set(launches[name]) == {"weighted_relax"}, launches[name]
    assert len({r[:2] for r in results.values()}) == 1, results
    assert results[name][:2] == (int(np.argmin(want5)), int(want5.min()))
    print("weighted road-512: " + json.dumps(dict(
        runs={k: dict(winner=v[0] + 1, min_f=v[1], computation_s=v[3])
              for k, v in results.items()},
        all_f_equal_scipy=True, card=CARD)))

    steps("11b road-512")
    # -- 11c. road-128, K = 8: the audit, the plane seam, verify.
    n1, e1 = generators.road_edges(128, 128, seed=seed + 17)
    costs1 = generators.edge_costs(len(e1), "uniform", max_cost=16, seed=seed + 3)
    gw, gu, q1 = (os.path.join(tmp, f"road128-{x}.bin") for x in ("w", "u", "q"))
    tio.save_graph_bin(gw, n1, e1, costs1)
    tio.save_graph_bin(gu, n1, e1)
    queries1 = generators.random_queries(n1, 8, max_group=8, seed=seed + 18)
    # The plane seam flips bit zlib.crc32("wplane") % bits of the (8, n)
    # plane: group 6's vertex 8754 at this size; a source there makes the
    # flip change that group's F.
    queries1[6] = np.concatenate([queries1[6], [8754]]).astype(np.int32)
    tio.save_query_bin(q1, queries1)
    argv1 = ["chip_smoke", "-g", gw, "-q", q1, "-gn", "1"]
    audits = []
    real_audit = certify.audit_weighted_f_values

    def counted_audit(*args, **kwargs):
        failing = real_audit(*args, **kwargs)
        audits.append(failing)
        return failing

    certify.audit_weighted_f_values = counted_audit
    ckpt = os.path.join(tmp, "road128.ckpt")
    report = {}
    try:
        for name, faults_spec, rc_want in (
            ("weighted audit road-128", "", 0),
            ("weighted wplane:2 road-128", "bitflip:wplane:2", 0),
            ("weighted wplane:all road-128",
             ",".join(f"bitflip:wplane:{i}" for i in range(1, 13)), 9),
        ):
            audits.clear()
            if os.path.exists(ckpt):
                os.remove(ckpt)
            with _env(MSBFS_WEIGHTED="1", MSBFS_AUDIT="full", MSBFS_CHECKPOINT=ckpt,
                      MSBFS_RETRIES="0", MSBFS_FAULTS=faults_spec):
                out = _weighted_counted(cli, timing, argv1, name, launches, rc_want)
            report[name] = dict(exit=rc_want, audits=len(audits),
                                failed_audits=sum(1 for x in audits if x),
                                answer=out.splitlines()[2:4])
            assert audits, name
        clean = report["weighted audit road-128"]
        assert clean["failed_audits"] == 0 and clean["answer"], clean
        assert report["weighted wplane:2 road-128"]["answer"] == clean["answer"]
        assert report["weighted wplane:2 road-128"]["failed_audits"] == 1
        assert report["weighted wplane:all road-128"]["failed_audits"] >= 2
    finally:
        certify.audit_weighted_f_values = real_audit
        faults.activate(None)  # the CLI leaves its plan installed
        if os.path.exists(ckpt):
            os.remove(ckpt)
    verify = {}
    for name, args, rc_want, kernel in (
        ("verify --weighted", ["-g", gw, "-q", q1, "--weighted"], 0, True),
        ("verify", ["-g", gu, "-q", q1], 0, False),
        ("verify --expect-f wrong", ["-g", gw, "-q", q1, "--weighted", "--expect-f",
                                     json.dumps([1] * 8)], 9, False),
    ):
        timing.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["chip_smoke", "verify", *args])
        counts = timing.launch_counts()
        print(buf.getvalue(), end="")
        assert rc == rc_want, (name, rc)
        assert ("weighted_relax" in counts) == kernel, (name, counts)
        if name == "verify --weighted":
            launches["weighted verify road-128"] = counts
            assert set(counts) == {"weighted_relax"}, counts
        verify[name] = dict(exit=rc, launches=counts)
    print("weighted road-128 certificate: " + json.dumps(dict(
        runs=report, verify=verify, card=CARD)))
    steps("11c road-128")
    steps.print()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    # Phase 12 serves the road-512 files (the F vector: all eight equal
    # scipy's, and the CLI's winner and F on every flavor).
    return {"weighted_relax": row}, dict(gpath=gpath5, queries=q5, f=want5)


# ---- phase 12: the serving daemon on the card (serve/, dynamic/)

# The coalescing window of phase 12a's daemon: wide enough that four
# clients started together land in one batch.
SERVE_WINDOW_S = "0.25"
# Phase 12b's sequential one-group queries.
SERVE_SEQUENTIAL = 64


def _wire(groups):
    return [[int(v) for v in g] for g in groups]


def _pow2(x):
    return 1 << max(0, (max(1, int(x)) - 1).bit_length())


def _serving_phase(ctx, info20, road5, seed):
    """Phase 12: the port's daemon in this process on a unix socket, on
    the card.  a. RMAT-20 (phase 5b's files and 64 groups) from four
    concurrent clients of 16 groups: one dispatch at k_exec = 64 (the
    counted path "serve rmat-20"), F equal to phase 5b's, a repeat from
    the result cache, a second bucket warmed once; b. 64 sequential
    one-source queries, their latency; c. a weighted query on phase 11b's
    road-512 files (the counted path "serve weighted road-512"); d. three
    mutations of road-512 on a daemon that retains planes, each answer
    equal to a fresh engine's and scipy's on the mutated graph; e. a
    reload releasing the old engine; f. a restart from the journal, ready,
    to the same answer, then a drain."""
    import gc
    import threading

    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.client import (
        MsbfsClient,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.registry import (
        build_supervised_engine,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.server import (
        MsbfsServer,
    )

    t_phase = time.perf_counter()
    queries, fv = info20["queries"], info20["fv"]
    winner = info20["winner"]
    quarters = [_wire(queries[16 * i:16 * (i + 1)]) for i in range(4)]
    widths = [_pow2(max(len(g) for g in qq)) for qq in quarters]
    assert len(set(widths)) == 1, f"the four clients' groups pad to {widths}: no one bucket"
    journal = os.path.join(tmp, "serve.journal")
    addr = f"unix:{tmp}/serve.sock"
    with _env(MSBFS_SERVE_WINDOW=SERVE_WINDOW_S):
        srv = MsbfsServer(listen=addr, journal_path=journal)
    srv.start()
    report = {}
    try:
        # -- 12a. four concurrent clients, one dispatch.
        gc.collect()
        m0 = torch.cuda.memory_allocated()
        timing.reset_launch_counts()
        t0 = time.perf_counter()
        with MsbfsClient(addr, timeout=600) as c:
            c.load(info20["gpath"], graph="rmat20")
        load_s = time.perf_counter() - t0
        engine_bytes = torch.cuda.memory_allocated() - m0
        out = [None] * 4
        barrier = threading.Barrier(4)

        def client(i):
            with MsbfsClient(addr, timeout=600) as c:
                barrier.wait()
                out[i] = c.query(quarters[i], graph="rmat20")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        coalesced_s = time.perf_counter() - t0
        counts = timing.launch_counts()
        launches["serve rmat-20"] = counts
        VARIANTS["serve rmat-20"] = timing.variant_counts()
        print(f"serve rmat-20 launches: {json.dumps(counts)}")
        for kernel in PATH_KERNELS["serve rmat-20"]:
            assert counts.get(kernel, 0) > 0, f"{kernel} never launched on serve rmat-20"
        assert all(r is not None and r["ok"] for r in out), out
        f = [x for r in out for x in r["f_values"]]
        assert f == [int(x) for x in fv], "served F differs from phase 5b's"
        assert int(np.argmin(f)) == winner and f[winner] == info20["want"][winner]
        for r in out:
            assert r["bucket"] == [64, widths[0]] and r["batched_with"] == 3, r["bucket"]
        stats = srv.stats()
        assert stats["queue"]["batches"] == 1 and stats["queue"]["coalesced"] == 3, \
            stats["queue"]
        assert stats["compiles_total"] == 1, stats["compiles"]
        with MsbfsClient(addr, timeout=600) as c:
            again = c.query(quarters[0], graph="rmat20")
            assert again["cached"] and again["f_values"] == out[0]["f_values"]
            wide = [i for i, g in enumerate(queries) if _pow2(len(g)) == widths[0]][:4]
            b1 = c.query(_wire([queries[i] for i in wide[:2]]), graph="rmat20")
            b2 = c.query(_wire([queries[i] for i in wide[2:]]), graph="rmat20")
        assert b1["compiled"] and not b2["compiled"] and b1["bucket"] == [2, widths[0]]
        assert b1["f_values"] + b2["f_values"] == [int(fv[i]) for i in wide]
        assert srv.stats()["compiles_total"] == 2
        report["a"] = dict(
            n=int(srv.registry.get("rmat20").graph.n), groups=64, clients=4,
            bucket=out[0]["bucket"], dispatches=1, batched_with=3,
            winner=winner + 1, min_f=f[winner], scipy_f=info20["want"][winner],
            load_s=load_s, four_clients_s=coalesced_s,
            server_latency_ms=[r["latency_ms"] for r in out],
            engine_device_bytes=engine_bytes, repeat_cached=True,
            second_bucket_compiles=1, card=CARD)
        print("serve rmat-20: " + json.dumps(report["a"]))

        # -- 12b. sequential one-source queries in one warm bucket, at the
        # default coalescing window (12a's wide one would be most of each
        # request's latency).
        from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve import (
            batcher,
        )

        srv.batcher.window_s = batcher.DEFAULT_WINDOW_S
        single = [[[int(g[0])]] for g in queries[:SERVE_SEQUENTIAL]]
        with MsbfsClient(addr, timeout=600) as c:
            c.query([[int(queries[-1][-1])]], graph="rmat20")  # warm the 1x1 bucket
            rtt = []
            for q in single:
                t0 = time.perf_counter()
                r = c.query(q, graph="rmat20")
                rtt.append((time.perf_counter() - t0) * 1e3)
                assert r["ok"] and not r["compiled"], r
        label = [k for k in srv.stats()["buckets"] if k.endswith(":1x1")]
        assert len(label) == 1, label
        b = srv.stats()["buckets"][label[0]]
        rtt.sort()
        report["b"] = dict(
            queries=SERVE_SEQUENTIAL, bucket=label[0], window_s=srv.batcher.window_s,
            server_p50_ms=b["p50_ms"],
            server_p99_ms=b["p99_ms"], server_samples=b["requests"],
            client_p50_ms=rtt[len(rtt) // 2], client_p99_ms=rtt[int(0.99 * (len(rtt) - 1))],
            card=CARD)
        print(f"serve rmat-20 sequential latency: p50 {b['p50_ms']} ms, p99 "
              f"{b['p99_ms']} ms (stats verb, {b['requests']} requests in bucket "
              f"{label[0]}); card: {CARD}")
        print("serve rmat-20 sequential: " + json.dumps(report["b"]))

        # -- 12c. a weighted query on phase 11b's road-512 files.
        w5 = _wire(road5["queries"])
        timing.reset_launch_counts()
        with MsbfsClient(addr, timeout=600) as c:
            c.load(road5["gpath"], graph="road512w")
            rw = c.query(w5, graph="road512w", weighted=True)
        counts = timing.launch_counts()
        launches["serve weighted road-512"] = counts
        print(f"serve weighted road-512 launches: {json.dumps(counts)}")
        for kernel in PATH_KERNELS["serve weighted road-512"]:
            assert counts.get(kernel, 0) > 0, f"{kernel} never launched on serve weighted"
        assert rw["weighted"] and rw["f_values"] == [int(x) for x in road5["f"]], rw
        report["c"] = dict(K=len(w5), winner=rw["min_k"] + 1, min_f=rw["min_f"],
                           f_equal_phase_11b=True, latency_ms=rw["latency_ms"],
                           weighted_relax_launches=counts.get("weighted_relax", 0), card=CARD)
        print("serve weighted road-512: " + json.dumps(report["c"]))

        # -- 12e. reload: two engines resident during the swap, one after.
        gc.collect()
        m_before = torch.cuda.memory_allocated()
        old = srv.registry.get("rmat20")
        t0 = time.perf_counter()
        with MsbfsClient(addr, timeout=600) as c:
            info = c.reload(graph="rmat20")
        reload_s = time.perf_counter() - t0
        m_two = torch.cuda.memory_allocated()
        del old
        gc.collect()
        m_one = torch.cuda.memory_allocated()
        assert info["graph"]["version"] == 2 and info["invalidated_results"] >= 1, info
        assert m_two - m_one >= 0.9 * engine_bytes, (m_two, m_one, engine_bytes)
        assert m_one <= m_before + 0.05 * engine_bytes, (m_one, m_before, engine_bytes)
        report["e"] = dict(reload_s=reload_s, engine_bytes=engine_bytes,
                           allocated_before=m_before, allocated_two_engines=m_two,
                           allocated_after_release=m_one,
                           invalidated_results=info["invalidated_results"])
        print("serve reload rmat-20: " + json.dumps(report["e"]))
    finally:
        srv.stop()

    # -- 12f. restart from the journal, ready, the same answer; then drain.
    t0 = time.perf_counter()
    srv = MsbfsServer(listen=addr, journal_path=journal)
    srv.start()
    try:
        with MsbfsClient(addr, timeout=600) as c:
            while not c.health()["ready"]:
                time.sleep(0.05)
            ready_s = time.perf_counter() - t0
            rewarmed = srv.stats()["compiles_total"]
            health = c.health()
            again = c.query(quarters[0], graph="rmat20")
        assert health["ready"] and health["graphs"] == ["rmat20", "road512w"], health
        assert again["f_values"] == out[0]["f_values"], again
        stats = srv.stats()
    finally:
        drained = srv.drain()
    assert drained
    report["f"] = dict(ready_s=ready_s, journal=health["journal"],
                       rewarmed_buckets=rewarmed, compiles_total=stats["compiles_total"],
                       drained=drained,
                       query_compiled=again["compiled"])
    print("serve restart from journal: " + json.dumps(report["f"]))

    # -- 12d. mutations of road-512 on a daemon that retains planes.
    n5 = road5["n"]
    e5 = road5["edges"]
    gpath = os.path.join(tmp, "road512-u.bin")
    tio.save_graph_bin(gpath, n5, e5)
    q5 = road5["queries"]
    padded5 = tio.pad_queries(q5)
    batches = generators.delta_batches(n5, e5, batches=3, batch_size=16, locality=0.9,
                                       seed=seed)
    # The mutated edge set is replayed here with NumPy alone, not through
    # the port's DeltaLog that the registry uses: canonical (min, max)
    # pairs as keys lo * n + hi, self-loops dropped, deletes removed, then
    # inserts added (a pair in both lists ends up present).
    def _keys(pairs):
        p = np.asarray(pairs, np.int64).reshape(-1, 2)
        lo, hi = p.min(axis=1), p.max(axis=1)
        return np.unique((lo * n5 + hi)[lo != hi])

    edge_keys = _keys(e5)
    with _env(MSBFS_SERVE_PLANES="1"):
        srv = MsbfsServer(listen=addr)
    srv.start()
    rows = []
    try:
        with MsbfsClient(addr, timeout=600) as c:
            c.load(gpath, graph="road512")
            first = c.query(_wire(q5), graph="road512")
            for i, (ins, dels) in enumerate(batches):
                m = c.mutate(inserts=ins.tolist(), deletes=dels.tolist(), graph="road512")
                edge_keys = np.union1d(np.setdiff1d(edge_keys, _keys(dels)), _keys(ins))
                t0 = time.perf_counter()
                r = c.query(_wire(q5), graph="road512")
                rtt_ms = (time.perf_counter() - t0) * 1e3
                assert r["repaired"], r
                served = srv.registry.get("road512").graph
                u, v = edge_keys // n5, edge_keys % n5
                mine = CSRGraph.from_edges(n5, np.stack([u, v], axis=1).astype(np.int32))
                assert np.array_equal(served.row_offsets, mine.row_offsets)
                assert np.array_equal(served.col_indices, mine.col_indices)
                t0 = time.perf_counter()
                fresh = build_supervised_engine(mine, dev)
                fresh.compile(padded5.shape)
                build_s = time.perf_counter() - t0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f_fresh = torch.as_tensor(fresh.f_values(padded5)).cpu().numpy()
                recompute_ms = (time.perf_counter() - t0) * 1e3
                a = sp.csr_matrix((np.ones(2 * u.size, np.float32),
                                   (np.concatenate([u, v]), np.concatenate([v, u]))),
                                  shape=(n5, n5))
                want = [_scipy_f(cg, np, a, g) for g in q5]
                assert r["f_values"] == [int(x) for x in f_fresh] == want, (i, r["f_values"])
                rows.append(dict(
                    version=m["version"], digest=m["digest"], inserts=m["applied"]["inserts"],
                    deletes=m["applied"]["deletes"], repair_host_ms=r["latency_ms"],
                    repair_round_trip_ms=rtt_ms, repair=r["dynamic"],
                    fresh_engine=fresh.engine_label, fresh_build_and_warm_s=build_s,
                    fresh_recompute_ms=recompute_ms, f_equal_fresh_engine_and_scipy=True))
                del fresh
        stats = srv.stats()["dynamic"]
    finally:
        srv.stop()
    assert stats["requests_repaired"] == 3 and stats["planes_retained"] >= 1, stats
    report["d"] = dict(K=len(q5), first_latency_ms=first["latency_ms"], mutations=rows,
                       dynamic=stats, card=CARD)
    for row in rows:
        print(f"serve road-512 mutation v{row['version']}: repair {row['repair_host_ms']} ms "
              f"host (fallback {row['repair']['fallback']}, cone {row['repair']['cone_size']}) "
              f"against recompute {row['fresh_recompute_ms']:.3f} ms on a fresh "
              f"{row['fresh_engine']} engine (+{row['fresh_build_and_warm_s']:.3f} s build "
              f"and warm-up); card: {CARD}")
    print("serve road-512 mutations: " + json.dumps(report["d"]))
    os.remove(gpath)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# ---- phase 13: the replicated fleet on the card (serve/fleet.py,
# serve/router.py, serve/shards.py)

# Phase 13b's shard bound: RMAT-20's file lies above it, road-1024's and
# RMAT-16's below, so RMAT-20 alone is served as shards.
FLEET_SHARD_MAX_BYTES = 64 << 20
# Phase 5b's groups that the sharded RMAT-20 query takes: every
# shard_step frame of four groups stays below the 64 MiB frame bound.
FLEET_SHARD_GROUPS = 4
# The fleet's heartbeat (the fleet subcommand's --heartbeat-ms), and the
# request deadline of the chaos run's queries.
FLEET_HEARTBEAT_MS = 250
FLEET_DEADLINE_S = 30.0
# The chaos run's replica_kill fires on the victim's n-th heartbeat, and
# heartbeats count from the replicas' spawn: n is sized so that the kill
# lands FLEET_CHAOS_LEAD_S after the front end is up in a fleet
# FLEET_CHAOS_SLACK times as slow from its replicas' spawn to its front
# end's ready as the first one (the first of two fleets on one H100 at
# 700 W booted in 29.7 s, the second in 24.8; a heartbeat takes at least
# its period, so the kill only comes later than planned).  At 1.15 and
# 3 s a second fleet once lost its victim before its front end was up.
FLEET_CHAOS_LEAD_S = 4.0
FLEET_CHAOS_SLACK = 1.3
# Phase 13's target, against which its time is printed.
FLEET_PHASE_TARGET_S = 90.0
# How long the replicas of a stopped fleet may take to exit after the
# fleet process has.
FLEET_EXIT_S = 30.0
# A fragment frame's bytes beside its vertex ids: at most one decimal id
# and a comma per vertex, two brackets per group, and the envelope.
FLEET_FRAME_ENVELOPE_BYTES = 4096
# The chaos run's client threads.
FLEET_CLIENTS = 4


def _started_at(pid: int) -> float:
    """A process's start, in seconds since the epoch, from /proc (its
    starttime in clock ticks since boot, plus the boot time)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime "))
    return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _compute_apps() -> list:
    """nvidia-smi's rows of processes with a context on a card, as it
    prints them (in a container it may list them under pids of another
    namespace, or folded into one row, so they name no replica)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _card_used_mib() -> int:
    """The card's used memory, MiB, as nvidia-smi reads it."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def _replica_card_memory(address: str) -> dict:
    """One replica's own reading, on its own socket: its ``health`` pid
    and its ``metrics`` verb's card-memory gauges (what its caching
    allocator holds on the card)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.client import (
        MsbfsClient,
    )

    with MsbfsClient(address, timeout=60) as c:
        pid = int(c.health()["pid"])
        text = c.metrics()
    got = {"pid": pid}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name in ("msbfs_device_memory_allocated_bytes",
                    "msbfs_device_memory_reserved_bytes"):
            got[name[len("msbfs_device_memory_"):-len("_bytes")]] = int(float(value))
    return got


def _fleet_process(argv, base, listen, log_path, env):
    """Start ``python -m <port> fleet`` (from the repo root) and wait for
    its front end to answer ``health`` ready; meanwhile poll each
    replica's own socket.  Returns (process, boot seconds, {replica:
    (pid, seconds from its spawn to ready)}, seconds from the first
    replica's spawn to the front end's ready)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime.supervisor import (
        RetryPolicy,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.client import (
        MsbfsClient, ServerError,
    )

    cmd = [sys.executable, "-m", PKG, "fleet", "--listen", listen, "--base-dir", base,
           "--heartbeat-ms", str(FLEET_HEARTBEAT_MS)] + argv
    log = open(log_path, "ab")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=_ROOT, env=env, stdout=log, stderr=log)
    log.close()
    once = RetryPolicy(max_retries=0)

    def health(addr):
        try:
            with MsbfsClient(addr, timeout=5.0, retry=once) as c:
                return c.health()
        except (ServerError, OSError, ValueError):
            return None

    ready, starts = {}, {}
    deadline = time.perf_counter() + 300.0
    while True:
        assert proc.poll() is None, (
            f"the fleet exited {proc.returncode}: "
            + open(log_path, errors="replace").read()[-3000:])
        assert time.perf_counter() < deadline, "the fleet never came up in 300 s"
        for i in range(3):
            name = f"r{i}"
            if name not in ready:
                h = health(f"unix:{base}/{name}.sock")
                if h and h.get("ready"):
                    starts[name] = _started_at(int(h["pid"]))
                    ready[name] = (int(h["pid"]), time.time() - starts[name])
        h = health(listen)
        if h and h.get("ready") and len(ready) == 3:
            return proc, time.perf_counter() - t0, ready, time.time() - min(starts.values())
        time.sleep(0.05)


def _exited(pid: int) -> bool:
    """True once the process has exited (a zombie holds nothing)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _stop_fleet(proc, pids):
    """SIGTERM the fleet (its front end stops, its replicas drain) and
    check that it exits 0 and that every replica process exits within
    FLEET_EXIT_S after it.  The check is made before anything is killed:
    what is still running then is killed, and the check fails."""
    import signal

    rc, left = None, list(pids)
    try:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        with contextlib.suppress(subprocess.TimeoutExpired):
            rc = proc.wait(timeout=120)
        deadline = time.monotonic() + FLEET_EXIT_S
        while True:
            left = [pid for pid in pids if not _exited(pid)]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for pid in pids:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                if not _exited(pid):
                    os.kill(pid, signal.SIGKILL)
    assert rc == 0 and not left, f"the fleet exited {rc}; replicas still running: {left}"


def _fleet_phase(ctx, info20, road1024, rmat16, seed):
    """Phase 13: the replicated fleet on the card.  a. three of the port's
    daemons in this process behind the port's FleetRouter (replication 2):
    phase 5b's 64 groups (the counted path "fleet rmat-20") and phase 6's
    road-1024 groups (the counted path "fleet road-1024") to those phases'
    F; then at replication 3 with every query voted: an agreeing vote, a
    bitflip:dist on the primary outvoted and quarantined, a net_drop on
    the primary's route failed over, each to phase 5b's F.  b. the
    ``fleet`` subcommand as a child process (three replicas, replication
    2, RMAT-20 sharded): each replica on the card (nvidia-smi), its boot
    to ready; road-1024, RMAT-16 and the sharded RMAT-20 through the
    front end to scipy's and phase 5b's F; the metrics and trace verbs;
    then a second fleet with a replica_kill on road-1024's primary owner
    while four clients query it: no acknowledged query lost, the
    failover time, the victim restarted from its journal, every graph and
    shard back at full replication; then drained and stopped."""
    import threading

    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.client import (
        MsbfsClient,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.registry import (
        content_hash,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.ring import (
        PlacementRing,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.router import (
        FleetRouter,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.server import (
        MsbfsServer,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        faults, telemetry,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fv = [int(x) for x in info20["fv"]]
    q64 = _wire(info20["queries"])
    road_q = _wire(road1024["queries"])
    road_f = [int(x) for x in road1024["f"]]
    files = {"rmat20": info20["gpath"], "road1024": road1024["gpath"]}
    digests = {g: content_hash(p) for g, p in files.items()}
    report = {}

    steps = _Steps("phase 13")
    # -- 13a. three daemons in this process behind the port's router.
    addresses = {f"r{i}": f"unix:{tmp}/fleet-r{i}.sock" for i in range(3)}
    servers = {}
    try:
        t0 = time.perf_counter()
        for name, addr in addresses.items():
            servers[name] = MsbfsServer(listen=addr, graphs=files, window_s=0.0,
                                        request_timeout_s=600.0)
            servers[name].start()
        start_s = time.perf_counter() - t0
        router = FleetRouter(PlacementRing(list(addresses), replication=2), addresses,
                             digests, timeout=600.0)
        owners = {g: router.owners_for(g) for g in files}
        for path, graph, q, want in (("fleet rmat-20", "rmat20", q64, fv),
                                     ("fleet road-1024", "road1024", road_q, road_f)):
            timing.reset_launch_counts()
            t0 = time.perf_counter()
            out = router.query(q, graph=graph)
            wall_s = time.perf_counter() - t0
            counts = timing.launch_counts()
            launches[path] = counts
            VARIANTS[path] = timing.variant_counts()
            print(f"{path} launches: {json.dumps(counts)}")
            print(f"{path} variants: {json.dumps(VARIANTS[path])}")
            for kernel in PATH_KERNELS[path]:
                assert counts.get(kernel, 0) > 0, f"{kernel} never launched on {path}"
            assert out["f_values"] == want, f"{path}: F differs from the earlier phase's"
            assert out["replica"] == owners[graph][0] and out["failovers"] == 0, out
            report[path] = dict(K=len(q), owners=owners[graph], replica=out["replica"],
                                server_latency_ms=out["latency_ms"], router_wall_s=wall_s,
                                f_equal=True, card=CARD)
            print(f"{path}: " + json.dumps(report[path]))

        # Replication 3, every query voted; quarantine only recorded here.
        quarantined = []
        voter = FleetRouter(PlacementRing(list(addresses), replication=3), addresses, digests,
                            timeout=600.0, vote_rate=1.0,
                            quarantine_fn=lambda m: quarantined.append(m) or True)
        own3 = voter.owners_for("rmat20")
        assert own3[0] == owners["rmat20"][0], (own3, owners)
        t0 = time.perf_counter()
        agree = voter.query(q64[:16], graph="rmat20")
        agree_s = time.perf_counter() - t0
        assert agree["voted"] and "vote_mismatch" not in agree and agree["f_values"] == fv[:16]
        assert quarantined == []
        sup = servers[own3[0]].registry.get("rmat20").supervisor
        sup.plan = faults.FaultPlan.parse("bitflip:dist:1")
        try:
            t0 = time.perf_counter()
            flip = voter.query(q64[16:32], graph="rmat20")
            flip_s = time.perf_counter() - t0
        finally:
            sup.plan = None
        assert flip["f_values"] == fv[16:32], "a corrupt answer escaped the vote"
        assert flip["vote_mismatch"] and flip["replica"] == own3[1], flip
        assert quarantined == [own3[0]], quarantined
        vstats = voter.stats()
        assert (vstats["votes"], vstats["vote_mismatches"], vstats["quarantined"],
                vstats["vote_unresolved"]) == (2, 1, 1, 0), vstats
        idx = router._route_index(owners["rmat20"][0])
        faults.activate(faults.FaultPlan.parse(f"net_drop:route{idx}:1"))
        try:
            t0 = time.perf_counter()
            dropped = router.query(q64[48:64], graph="rmat20")
            drop_s = time.perf_counter() - t0
        finally:
            faults.activate(None)
        assert dropped["f_values"] == fv[48:64], "the failed-over answer differs"
        assert dropped["failovers"] == 1 and dropped["replica"] == owners["rmat20"][1], dropped
        assert router.stats()["net_drops"] == 1
        report["a"] = dict(daemons=3, start_s=start_s, vote_agree_s=agree_s,
                           vote_outvoted_s=flip_s, outvoted=own3[0],
                           served_by=flip["replica"], vote_stats={
                               k: vstats[k] for k in ("votes", "vote_mismatches",
                                                      "vote_unresolved", "quarantined")},
                           net_drop_failover_s=drop_s, failed_over_to=dropped["replica"],
                           card=CARD)
        print("fleet in-process vote and failover: " + json.dumps(report["a"]))
    finally:
        faults.activate(None)
        for srv in servers.values():
            srv.stop()
    del servers, router, voter, sup
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    steps("13a in-process fleet")
    # -- 13b. the fleet subcommand as a child process.
    graphs = dict(files, rmat16=rmat16["gpath"])
    sizes = {g: os.path.getsize(p) for g, p in graphs.items()}
    assert sizes["rmat20"] > FLEET_SHARD_MAX_BYTES, sizes
    assert max(sizes["road1024"], sizes["rmat16"]) <= FLEET_SHARD_MAX_BYTES, sizes
    argv = ["--size", "3", "--replication", "2", "--shard-max-bytes",
            str(FLEET_SHARD_MAX_BYTES)] + [a for g, p in graphs.items() for a in ("-g", f"{g}={p}")]
    env = dict(os.environ)
    env.pop("MSBFS_FAULTS", None)
    listen = f"unix:{tmp}/fleet.sock"
    log_path = os.path.join(tmp, "fleet.log")
    base = os.path.join(tmp, "fleet")
    used_before = _card_used_mib()
    proc, boot_s, ready, front_s = _fleet_process(argv, base, listen, log_path, env)
    pids = [pid for pid, _ in ready.values()]
    try:
        # Each replica process holds memory on the card.  nvidia-smi names
        # no replica here (it lists the container's processes under other
        # pids, or folds them into one row), so each replica reports its
        # own on its own socket, beside its health pid; and the card's
        # used memory rises by at least what they report.
        apps = _compute_apps()
        used_fleet = _card_used_mib()
        held = {name: _replica_card_memory(f"unix:{base}/{name}.sock")
                for name in sorted(ready)}
        print(f"fleet on the card: replicas' own card memory {json.dumps(held)}; "
              f"card memory used {used_before} -> {used_fleet} MiB; nvidia-smi compute "
              f"apps {json.dumps(apps)}; card: {CARD}")
        for name, got in held.items():
            assert got["pid"] == ready[name][0], (name, got, ready[name])
            assert got["allocated"] > 0 and got["reserved"] > 0, (name, got)
        assert (used_fleet - used_before) << 20 >= sum(g["reserved"] for g in held.values()), (
            used_before, used_fleet, held)
        with MsbfsClient(listen, timeout=600) as c:
            stats = c.stats()
            plan = stats["shards"]["rmat20"]
            report["b"] = dict(
                artifact_bytes=sizes, shard_max_bytes=FLEET_SHARD_MAX_BYTES,
                rmat20_shards=len(plan["shards"]), shard_copies=plan["replicas"],
                shard_rows=[s["rows"] for s in plan["shards"]],
                whole={g: stats["fleet"]["graphs"][g]["owners"] for g in ("road1024", "rmat16")},
                fleet_boot_s=boot_s,
                replica_spawn_to_ready_s={n: s for n, (_, s) in sorted(ready.items())},
                replicas_spawn_to_front_end_ready_s=front_s,
                replica_card_memory_bytes=held,
                card_memory_used_mib=dict(before=used_before, fleet=used_fleet),
                card=CARD)
            print("fleet boot: " + json.dumps(report["b"]))
            assert len(plan["shards"]) >= 2 and plan["replicas"] == 2, plan
            assert "road1024" in stats["fleet"]["graphs"] and "rmat16" in stats["fleet"]["graphs"]
            assert not any(g.startswith(("road1024#", "rmat16#")) for g in stats["fleet"]["graphs"])
            t0 = time.perf_counter()
            r = c.query(road_q, graph="road1024")
            road_s = time.perf_counter() - t0
            assert r["f_values"] == road_f, "fleet road-1024 F differs from scipy's"
            t0 = time.perf_counter()
            r16 = c.query([[rmat16["source"]]], graph="rmat16")
            rmat16_s = time.perf_counter() - t0
            assert r16["f_values"] == [rmat16["want"]], (r16["f_values"], rmat16["want"])
            t0 = time.perf_counter()
            rs = c.query(q64[:FLEET_SHARD_GROUPS], graph="rmat20")
            shard_s = time.perf_counter() - t0
            assert rs["sharded"] and rs["f_values"] == fv[:FLEET_SHARD_GROUPS], rs["f_values"]
            ids = rs["largest_fragment_ids"]
            frame_at_most = {
                way: n * (len(str(rs["n"] - 1)) + 1) + 2 * FLEET_SHARD_GROUPS
                + FLEET_FRAME_ENVELOPE_BYTES for way, n in ids.items()}
            report["queries"] = dict(
                road1024_s=road_s, road1024_replica=r["replica"], rmat16_s=rmat16_s,
                rmat20_sharded_s=shard_s, rmat20_groups=FLEET_SHARD_GROUPS,
                levels=rs["rounds"], fragments=rs["fragments"], shards=rs["shards"],
                largest_fragment_ids=ids, largest_fragment_frame_bytes_at_most=frame_at_most,
                frame_bound_bytes=64 << 20, card=CARD)
            print("fleet queries: " + json.dumps(report["queries"]))
            assert max(frame_at_most.values()) < 64 << 20, frame_at_most
            families = telemetry.parse_prometheus(c.metrics())
            assert families.get("msbfs_fleet_routed_total") == "counter", sorted(families)
            trace = telemetry.new_trace()
            with telemetry.use_trace(trace):
                c.query(road_q[:2], graph="road1024")
            events = c.trace(trace.trace_id)["events"]
            names = {e["name"] for e in events}
            assert {"route.query", "serve.query"} <= names, sorted(names)
            report["observe"] = dict(metric_families=len(families), trace_events=len(events),
                                     trace_spans=sorted(names))
            print("fleet metrics and trace: " + json.dumps(report["observe"]))
    finally:
        _stop_fleet(proc, pids)
    print(f"fleet stopped: card memory used {_card_used_mib()} MiB; nvidia-smi compute apps "
          f"{json.dumps(_compute_apps())}")

    steps("13b fleet subcommand")
    # -- 13b, chaos: a second fleet with a replica_kill on road-1024's
    # primary owner while four clients query road-1024.
    victim = PlacementRing([f"r{i}" for i in range(3)], replication=2).owners(
        digests["road1024"])[0]
    vi = int(victim[1:])
    trips = int(np.ceil((FLEET_CHAOS_SLACK * front_s + FLEET_CHAOS_LEAD_S) * 1000
                        / FLEET_HEARTBEAT_MS))
    env["MSBFS_FAULTS"] = f"replica_kill:replica{vi}:{trips}"
    base = os.path.join(tmp, "fleet-chaos")
    proc, boot2_s, ready2, front2_s = _fleet_process(argv, base, listen, log_path, env)
    pids = [pid for pid, _ in ready2.values()]
    try:
        def victim_row(c):
            return next(x for x in c.health()["fleet"]["replicas"] if x["name"] == victim)

        with MsbfsClient(listen, timeout=600) as c:
            assert victim_row(c)["injected_kills"] == 0, "the kill fired before the clients ran"
        stop = threading.Event()
        lat, errors, answered = [], [], [0]

        def client(i):
            with MsbfsClient(listen, timeout=600) as c:
                j = i
                while not stop.is_set():
                    g = j % len(road_q)
                    t0 = time.perf_counter()
                    try:
                        r = c.query([road_q[g]], graph="road1024", deadline_s=FLEET_DEADLINE_S)
                    except Exception as exc:  # noqa: BLE001 — every failure is a finding
                        errors.append(repr(exc))
                        continue
                    lat.append((time.perf_counter() - t0, time.time()))
                    if r["f_values"] != [road_f[g]]:
                        errors.append(f"group {g}: {r['f_values']} != {road_f[g]}")
                    answered[0] += 1
                    j += FLEET_CLIENTS

        threads = [threading.Thread(target=client, args=(i,)) for i in range(FLEET_CLIENTS)]
        t_chaos = time.perf_counter()
        for t in threads:
            t.start()
        killed_at = None
        row, st, full = {}, {}, False
        try:
            with MsbfsClient(listen, timeout=600) as c:
                deadline = time.perf_counter() + 240.0
                while time.perf_counter() < deadline and not errors:
                    row = victim_row(c)
                    if killed_at is None and row["injected_kills"] >= 1:
                        killed_at = time.time()
                    st = c.stats()
                    full = all(len(g["live_owners"]) == 2
                               for g in st["fleet"]["graphs"].values())
                    if (killed_at is not None and row["restarts"] >= 1
                            and row["state"] == "ready" and full
                            and st["totals"].get("under_replicated_shards", 0) == 0):
                        break
                    time.sleep(0.1)
        finally:
            stop.set()
            for t in threads:
                t.join(600)
        chaos_s = time.perf_counter() - t_chaos
        assert not errors, errors[:5]
        assert killed_at is not None, "replica_kill never fired"
        assert row["restarts"] >= 1 and row["state"] == "ready", row
        assert full, st["fleet"]["graphs"]
        around = [s for s, at in lat if abs(at - killed_at) <= 5.0]
        with MsbfsClient(f"unix:{base}/{victim}.sock", timeout=60) as c:
            vh = c.health()
        assert "road1024" in vh["graphs"], vh
        report["chaos"] = dict(
            victim=victim, kill_at_trip=trips, fleet_boot_s=boot2_s,
            replicas_spawn_to_front_end_ready_s=front2_s, answered=answered[0],
            failed=0, lost=0, longest_request_s=max(s for s, _ in lat),
            longest_request_within_5s_of_kill_s=max(around) if around else None,
            deadline_s=FLEET_DEADLINE_S, victim_restarts=row["restarts"],
            victim_graphs_after_replay=vh["graphs"],
            every_graph_and_shard_live_owners=2, chaos_s=chaos_s, card=CARD)
        print(f"fleet chaos: longest request {report['chaos']['longest_request_s']:.3f} s "
              f"against the {FLEET_DEADLINE_S:g} s deadline; card: {CARD}")
        print("fleet chaos: " + json.dumps(report["chaos"]))
        pids = sorted(set(pids) | {vh["pid"]})
    finally:
        _stop_fleet(proc, pids)
    apps = _compute_apps()
    used_after = _card_used_mib()
    assert used_after < used_before + (used_fleet - used_before) / 6, (used_before, used_after)
    print(f"fleet stopped: card memory used {used_after} MiB (before the fleets "
          f"{used_before}); nvidia-smi compute apps {json.dumps(apps)}")
    steps("13b chaos fleet")
    steps.print()
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s against a target of "
          f"{FLEET_PHASE_TARGET_S:g} s; card: {CARD}")


# ---- phase 14: the port's tooling (gen_cli, the text converters, the
# profiler trace of the computation span, the analyzer)

# Each counted kernel's device functions as torch.profiler names them:
# (one event a launch, events a launch adds to those). A forest_or launch
# is one forest_level_kernel a non-empty forest level, then the gather.
TRACE_SYMBOLS = {
    "batch_start": (("batch_start_kernel",), ()),
    "stencil_sweep": (("sweep_ring_kernel", "sweep_l2_kernel"), ()),
    "level_apply": (("level_apply_vector_kernel", "level_apply_column_kernel",
                     "level_apply_rows_kernel"), ()),
    "push_or": (("push_or_kernel",), ()),
    "forest_or": (("forest_gather_kernel",), ("forest_level_kernel",)),
}
# Phase 14's sizes: gen_cli's R-MAT scale, the DIMACS road's side, the
# SNAP R-MAT's scale (the names of its paths and lines say 20, 1024, 16).
TOOLING_RMAT_SCALE = 20
TOOLING_ROAD_SIDE = 1024
TOOLING_SNAP_SCALE = 16
# The 7 report lines' form (reference main.cu:409-418).
REPORT_FORM = (
    r"Graph: .+", r"Query: .+", r"Query number \(k\) with minimum F value: \d+",
    r"Minimum F value: \d+", r"GPU # : \d+ GPU", r"Preprocessing time: \d+\.\d{9} s",
    r"Computation time: \d+\.\d{9} s",
)


def _sha256(path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


def _gen_cli(argv, label, **env):
    """``python -m <port>.gen_cli argv`` as a child process with ``env``
    (a None value unsets a variable): (host seconds, its stderr lines)."""
    child_env = dict(os.environ)
    for key, value in env.items():
        if value is None:
            child_env.pop(key, None)
        else:
            child_env[key] = value
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.gen_cli", *argv], cwd=_ROOT,
                          env=child_env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, (label, proc.returncode, proc.stderr[-3000:])
    return seconds, proc.stderr.splitlines()


def _busy_ms(events):
    """The union of the device events' intervals, in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e3


# Each profiled run's CLI call with its MSBFS_PROFILE_DIR, in a fresh
# process (argv: a JSON list of [argv, trace directory] pairs).
_PROFILE_CHILD = f"""
import json, os, sys
from {PKG} import cli
for argv, trace_dir in json.loads(sys.argv[1]):
    os.environ["MSBFS_PROFILE_DIR"] = trace_dir
    rc = cli.main(argv)
    if rc:
        sys.exit(rc)
"""


def _profiled_paths(runs, launches):
    """Counted CLI paths under MSBFS_PROFILE_DIR, as a user takes a trace:
    ``cli.main`` with the knob set, each run of ``runs`` ((argv, name,
    trace directory)) in turn in one fresh child process (in this
    script's process, minutes old, the card's first events of a trace
    went missing, PERF.md §7).  Returns each run's report numbers."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _PROFILE_CHILD,
         json.dumps([[argv, trace_dir] for argv, _, trace_dir in runs])],
        cwd=_ROOT, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    print(proc.stdout, end="")
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    assert len(lines) == len(REPORT_FORM) * len(runs), lines
    results = []
    for i, (_, name, trace_dir) in enumerate(runs):
        report = "\n".join(lines[i * len(REPORT_FORM):(i + 1) * len(REPORT_FORM)])
        results.append(_trace_check(_parse_report(report), name, launches, trace_dir, child_s))
    return results


def _trace_check(result, name, launches, trace_dir, child_s):
    """A profiled path's trace: the file exists, every kernel the span
    launched (the trace's ``msbfs_launches``: the child's launch counters
    over the span, which count as the path's) is named by as many device
    events as it has launches (forest_or's level kernels a whole multiple
    of them), no device event of a hand-written kernel goes uncounted, and
    the device's busy share of the span is read from the trace."""
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
               if f.startswith("msbfs.") and f.endswith(".pt.trace.json")]
    t0 = time.perf_counter()
    with open(path) as f:
        trace = json.load(f)
    span = trace["msbfs_launches"]
    launches[name] = span
    print(f"{name} launches: {json.dumps(span)} (the span's, in the child)")
    assert span, (name, "the span launched no counted kernel")
    for kernel in PATH_KERNELS[name]:
        assert kernel in span, (name, kernel, "not launched inside the span")
    device = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = {}
    for e in device:
        if e["cat"] == "kernel":
            op = _op_name(e["name"])
            kernels[op] = kernels.get(op, 0) + 1
    ours = {s for markers, extra in TRACE_SYMBOLS.values() for s in (*markers, *extra)}
    per_launch = {}
    for kernel, count in span.items():
        markers, extra = TRACE_SYMBOLS[kernel]
        seen = sum(kernels.get(s, 0) for s in markers)
        assert seen == count, (name, kernel, "trace events", seen, "launches", count, kernels)
        for s in extra:
            assert kernels.get(s, 0) % count == 0, (name, s, kernels.get(s, 0), count)
            per_launch[s] = kernels.get(s, 0) // count
    named = {s for k in span for s in (*TRACE_SYMBOLS[k][0], *TRACE_SYMBOLS[k][1])}
    stray = {s: c for s, c in kernels.items() if s in ours and s not in named}
    assert not stray, (name, "device events of kernels no counter saw", stray)
    busy = _busy_ms(device)
    span_ms = result[3] * 1e3
    window = (max(e["ts"] + e["dur"] for e in device) - min(e["ts"] for e in device)) / 1e3
    print(f"profile {name}: " + json.dumps(dict(
        trace=os.path.basename(path), trace_bytes=os.path.getsize(path),
        child_s_for_every_profiled_run=child_s,
        trace_read_s=time.perf_counter() - t0, span_launches=span,
        trace_kernel_events={k: v for k, v in kernels.items() if k in ours},
        events_a_launch=per_launch,
        other_device_events=sum(1 for e in device if e["cat"] != "kernel"
                                or _op_name(e["name"]) not in ours),
        busy_ms=busy, span_ms=span_ms, device_window_ms=window, busy_share=busy / span_ms,
        card=CARD)))
    return result


def _ingest(ctx, fmt, text_path, write_s, label, seed, queries, max_group, scipy_f=None):
    """One real-format file through ``gen_cli --convert`` (the native
    parser; in this process, its host time without a child's start),
    timed against the Python parser on the same file (the same edges);
    returns what the port's CLI on the converted graph needs, and scipy's
    F of its groups."""
    (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev) = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import gen_cli
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )

    gpath = os.path.join(tmp, f"{label}-converted.bin")
    qpath = os.path.join(tmp, f"{label}-converted-q.bin")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = gen_cli.main(["--convert", text_path, "--informat", fmt, "--graph", gpath,
                           "--queries", str(queries), "--max-group", str(max_group),
                           "--query-file", qpath, "--seed", str(seed)])
    convert_s = time.perf_counter() - t0
    assert rc == 0, (label, rc, err.getvalue())
    read = tio.load_dimacs_gr if fmt == "dimacs" else tio.load_edgelist
    t0 = time.perf_counter()
    native = read(text_path, native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = read(text_path, native=False)
    python_s = time.perf_counter() - t0
    assert native[0] == python[0] and np.array_equal(native[1], python[1]), label
    g = tio.load_graph_bin(gpath)
    assert g.n == native[0] and g.m == len(native[1]), (label, g.n, g.m)
    argv = ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"]
    name = f"tooling {label}"
    if scipy_f is None:
        a = _scipy_matrix(sp, np, CSRGraph.from_edges(g.n, native[1]))
        scipy_f = np.array(_scipy_map(_scipy_f, a, tio.load_query_bin(qpath)))
    return dict(gpath=gpath, qpath=qpath, argv=argv, name=name, scipy_f=scipy_f, row=dict(
        file_bytes=os.path.getsize(text_path), write_s=write_s, gen_cli_convert_s=convert_s,
        native_parse_s=native_s, python_parse_s=python_s, python_over_native=python_s / native_s,
        n=g.n, edges=g.m, stderr=err.getvalue().splitlines(), card=CARD, host=HOST))


def _check_winner(np, ingest, run):
    want = ingest["scipy_f"]
    assert run[:2] == (int(np.argmin(want)), int(want.min())), (ingest["name"], run, want)


def _tooling_phase(ctx, seed, road=None, rmat20_gpath=None):
    """Phase 14 on the card: gen_cli as a child (RMAT-20 from the native
    sampler and the NumPy stream, the latter's bytes held against the
    in-process generator), road-1024 as DIMACS and RMAT-16 as SNAP
    converted by gen_cli and by the Python parser, the port's CLI on each
    against scipy, ``MSBFS_PROFILE_DIR`` on the converted road-1024
    (stencil) and on gen_cli's RMAT-20 K = 64 (bitbell), and ``analyze``.
    ``road``: (n, edges, want F of the 16 groups random_queries(n, 16,
    seed=seed + 3) draws) when an earlier phase has them; ``rmat20_gpath``:
    a file save_graph_bin wrote of rmat_edges(20, 16, seed)."""
    (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev) = ctx

    t_phase = time.perf_counter()
    analyze = subprocess.Popen([sys.executable, "-m", PKG, "analyze"], cwd=_ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # -- a. gen_cli's RMAT-20, K = 64: the native sampler, the NumPy stream.
        scale = TOOLING_RMAT_SCALE
        common = ["--kind", "rmat", "--scale", str(scale), "--edge-factor", "16", "--queries", "64",
                  "--max-group", "128", "--seed", str(seed)]
        native_g = os.path.join(tmp, "gen-rmat20-native.bin")
        numpy_g = os.path.join(tmp, "gen-rmat20-numpy.bin")
        qn, qp = os.path.join(tmp, "gen-q-native.bin"), os.path.join(tmp, "gen-q.bin")
        native_s, native_err = _gen_cli([*common, "--graph", native_g, "--query-file", qn],
                                        "gen_cli native", MSBFS_NATIVE_RMAT="1")
        numpy_s, numpy_err = _gen_cli([*common, "--graph", numpy_g, "--query-file", qp],
                                      "gen_cli numpy", MSBFS_NATIVE_RMAT=None)
        t0 = time.perf_counter()
        if rmat20_gpath is None:
            rmat20_gpath = os.path.join(tmp, "rmat20-inprocess.bin")
            tio.save_graph_bin(rmat20_gpath, *generators.rmat_edges(scale, edge_factor=16,
                                                                    seed=seed))
        assert _sha256(numpy_g) == _sha256(rmat20_gpath), "gen_cli's NumPy stream differs"
        assert _sha256(qn) == _sha256(qp)
        native = tio.load_graph_bin(native_g)
        assert (native.n, native.m) == (1 << scale, 16 << scale)
        assert _sha256(native_g) != _sha256(numpy_g)
        del native
        print("gen_cli rmat-20: " + json.dumps(dict(
            native_child_s=native_s, numpy_child_s=numpy_s, numpy_over_native=numpy_s / native_s,
            digests_and_native_load_s=time.perf_counter() - t0, numpy_bytes_equal_generator=True,
            native_stderr=native_err, numpy_stderr=numpy_err, card=CARD, host=HOST)))

        # -- b. road-1024 as DIMACS, RMAT-16 as SNAP: converted natively,
        # timed against the Python parser; the CLI on each against scipy.
        if road is None:
            n1, e1 = generators.road_edges(TOOLING_ROAD_SIDE, TOOLING_ROAD_SIDE, seed=seed + 1)
            want1 = None
        else:
            n1, e1, want1 = road
        gr_path = os.path.join(tmp, "road1024.gr")
        t0 = time.perf_counter()
        tio.save_dimacs_gr(gr_path, n1, e1, comment=f"road_edges, seed {seed + 1}")
        gr_write = time.perf_counter() - t0
        # gen_cli draws its queries with seed + 1: phase 6's 16 groups.
        road_in = _ingest(ctx, "dimacs", gr_path, gr_write, "road-1024", seed + 2, 16, 128,
                          want1)
        os.remove(gr_path)
        n16, e16 = generators.rmat_edges(TOOLING_SNAP_SCALE, edge_factor=16, seed=seed)
        snap_path = os.path.join(tmp, "rmat16.txt")
        t0 = time.perf_counter()
        with open(snap_path, "w") as f:
            f.write(f"# rmat_edges, seed {seed}: {n16} nodes, {len(e16)} records\n")
            np.savetxt(f, e16, fmt="%d\t%d")
        snap_write = time.perf_counter() - t0
        rmat_in = _ingest(ctx, "snap", snap_path, snap_write, "rmat-16", seed, 8, 16)
        os.remove(snap_path)

        # -- c. MSBFS_PROFILE_DIR on the converted road-1024 (stencil) and
        # gen_cli's RMAT-20 K = 64 (bitbell); the CLI on RMAT-16 plain.
        road_run, _ = _profiled_paths([
            (road_in["argv"], road_in["name"], os.path.join(tmp, "trace-road1024")),
            (["chip_smoke", "-g", numpy_g, "-q", qp, "-gn", "1"], "tooling rmat-20",
             os.path.join(tmp, "trace-rmat20")),
        ], launches)
        _check_winner(np, road_in, road_run)
        rmat_run = _run_path(cli, timing, rmat_in["argv"], rmat_in["name"], launches)
        _check_winner(np, rmat_in, rmat_run)
        for ingest, run in ((road_in, road_run), (rmat_in, rmat_run)):
            print(f"ingest {ingest['name']}: " + json.dumps(dict(
                **ingest["row"], winner=run[0] + 1, min_f=run[1], scipy_f=int(ingest["scipy_f"].min()),
                preprocessing_s=run[2], computation_s=run[3])))
        for path in (native_g, numpy_g, road_in["gpath"], rmat_in["gpath"]):
            os.remove(path)

        # -- d. the analyzer on the committed tree.
        out, err = analyze.communicate(timeout=300)
        assert analyze.returncode == 0, (analyze.returncode, out[-3000:], err[-3000:])
        print(f"analyze: rc 0; {out.splitlines()[0]}")
    finally:
        if analyze.poll() is None:
            analyze.kill()
            analyze.wait()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; card: {CARD}")


# ---- phase 15: the mesh engines (-gn > 1) on a logical mesh over the card

# Entries of the logical mesh: four shards, every one on cuda:0.
MESH_SHARDS = 4
# Groups checked against scipy on the road-1024 paths (besides the winner).
MESH_SCIPY_GROUPS = 8


def _stats_table(np, text):
    """(levels, reached, F) int64 arrays of the MSBFS_STATS query table."""
    lines = text.splitlines()
    at = lines.index("query  levels  reached  F")
    rows = []
    for line in lines[at + 1:]:
        parts = line.split()
        if len(parts) != 4 or not all(p.isdigit() for p in parts):
            break
        rows.append([int(p) for p in parts[1:]])
    table = np.asarray(rows, dtype=np.int64)
    return table[:, 0], table[:, 1], table[:, 2]


def _halo_table(text):
    """Route counts, levels and total bytes of the MSBFS_STATS=2 halo table."""
    lines = text.splitlines()
    at = lines.index("level  own_rows  route   halo_bytes")
    routes, levels = {}, 0
    for line in lines[at + 1:]:
        if line.startswith("total halo bytes:"):
            return routes, levels, int(line.split(":")[1])
        parts = line.split()
        routes[parts[2]] = routes.get(parts[2], 0) + 1
        levels += 1
    raise AssertionError("halo table without a total")


# Device cycles slept before each launch of a timed recording (about 0.5
# ms): the wrapper's host time falls in the sleep, not between the events.
LAUNCH_SLACK = 1_000_000


@contextlib.contextmanager
def _record(module, name, pick, timed=False):
    """Every call of ``module.name`` still runs; ``pick(args, kwargs)``
    returns (weight, snapshot) of its inputs before the call (the snapshot
    may be a function that makes it, called only for a call that is kept),
    and the snapshot of the heaviest call is kept in the yielded dict.
    ``timed``: each call also timed alone (CUDA events behind a queued
    device sleep), their sum and count kept as ``sum_ms`` and ``calls``
    once the block ends."""
    import torch

    real = getattr(module, name)
    best, events = {}, []

    def wrapped(*args, **kwargs):
        weight, snap = pick(args, kwargs)
        if snap is not None and weight > best.get("weight", -1):
            best.update(weight=weight, snap=snap() if callable(snap) else snap)
        if not timed:
            return real(*args, **kwargs)
        ev = _events(torch, 2)
        torch.cuda._sleep(LAUNCH_SLACK)
        ev[0].record()
        out = real(*args, **kwargs)
        ev[1].record()
        events.append(ev)
        return out

    setattr(module, name, wrapped)
    if timed:
        gc.collect()
        gc.disable()  # a collection inside a timed call would land between its events
    try:
        yield best
    finally:
        gc.enable()
        setattr(module, name, real)
    if timed:
        torch.cuda.synchronize()
        best.update(sum_ms=sum(e0.elapsed_time(e1) for e0, e1 in events), calls=len(events))


def _hold(torch, kernel, plain, fresh, outputs, nbytes):
    """A kernel held bit for bit against its plain version on fresh copies
    of one recorded call's inputs, both timed (``fresh()`` -> the call's
    arguments; ``outputs(args)`` -> the tensors it writes) beside the
    bound of ``nbytes`` moved; no torch call computes the same function,
    so there is no library time."""
    args_k, args_p = fresh(), fresh()
    kernel(*args_k)
    plain(*args_p)
    err = _max_abs_err(torch, zip(outputs(args_k), outputs(args_p)))
    work = {}

    def restore():
        work["args"] = fresh()

    ms = _time_ms(torch, lambda: kernel(*work["args"]), restore)
    plain_ms = _time_ms(torch, lambda: plain(*work["args"]), restore, reps=3, warm=1)
    bound_ms, bound_by = _bound_ms(nbytes, 0)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_bytes=int(nbytes))


def _commit_bytes(torch, commit, delta):
    """The bytes a commit (``ops/cuda_mesh.py`` ``Commit``) of neg's lanes
    must move, given the lanes it improved (``delta``, from the plain
    version): neg read, delta and the send written whole, the changed
    mask written whole when it is set; neg written, and the mask when it
    is ORed (no read: an OR of 1s is a write of 1s), only in the 32-byte
    sectors that hold an improved lane; the flag.  Returns (bytes,
    improved lanes, neg's written sectors, the mask's written sectors)."""
    lanes = delta.numel()
    idx = delta.reshape(-1).nonzero().squeeze(1)

    def sectors(lanes_a_sector):
        return int(torch.unique(idx // lanes_a_sector).numel())

    neg_sectors = sectors(8)
    mask_sectors = 0
    if commit.acc is not None:
        mask_sectors = -(-lanes // 32) if commit.acc_set else sectors(32)
    nbytes = (4 * lanes + lanes + 32 * neg_sectors + 32 * mask_sectors
              + (0 if commit.send is None else 4 * lanes) + 4)
    return nbytes, int(idx.numel()), neg_sectors, mask_sectors


def _mesh_path(ctx, name, argv, env, single, checks, direct=None):
    """One -gn 4 CLI run over the logical mesh as a counted path, its F
    vector (the MSBFS_STATS table; ``direct()`` on an engine without one,
    the engine the CLI builds, run again) equal to the single-device route's,
    its winner and the checked groups equal to scipy's; prints its span
    beside the single-device span, its halo and its peak memory."""
    torch, np, cli, timing, launches, dev = ctx
    err = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with _env(**{"MSBFS_STATS": "1", **env}), contextlib.redirect_stderr(err):
        min_k, min_f, pre_s, comp_s = _run_path(
            cli, timing, argv, name, launches, mesh_devices=[dev] * MESH_SHARDS)
    peak = torch.cuda.max_memory_allocated(dev) - base
    text = err.getvalue()
    if direct is None:
        levels, reached, f = _stats_table(np, text)
    else:
        assert "per-query stats are not available" in text, text
        levels, f = None, direct().cpu().numpy()
    fv, want = checks
    assert np.array_equal(f, fv), (name, f, fv)
    assert (min_k, min_f) == (int(np.argmin(fv)), int(fv.min())), (name, min_k, min_f)
    for q, wf in want.items():
        assert int(f[q]) == wf, (name, q, int(f[q]), wf)
    row = dict(winner=min_k + 1, min_f=min_f, f_equal_single_device=True,
               scipy_groups_equal=len(want), cli_computation_s=comp_s,
               single_device_computation_s=single, preprocessing_s=pre_s,
               levels=None if levels is None else int(levels.max()),
               peak_mib=peak / 2**20, halo_bytes_per_level=0, card=CARD)
    if "halo_bytes" in text:
        routes, halo_levels, total = _halo_table(text)
        row.update(halo_routes=routes, halo_bytes_per_level=total / max(halo_levels, 1))
    return row, text


def _h2_rows(torch, cuda_halo, push_snap, match_snap, n_pad):
    """H2's match and push, each held bit for bit against its plain version
    and timed beside its bound: the push on the widest recorded push (its
    recorded match as input), the match on that call's pairs and on the
    widest recorded match.  Bounds: the match reads every pair's id and a
    matched pair's CSR entry, and writes every pair's (st, deg, pos) and
    the total; the push reads a matched pair's st, pos and words, each
    edge's slot, and reads and writes each landed hit row once.  No torch
    call computes either, so neither has a library time."""
    ids, words, csr, hits, match, edges_read = push_snap
    src_ids, src_start, src_cnt, vals = csr
    w = hits.shape[1]
    deg = match.deg.long()
    matched = int((deg > 0).sum())
    edges = int(match.total[0])
    assert edges == edges_read, (edges, edges_read)
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=ids.device), deg)
    within = torch.arange(owner.numel(), device=ids.device) - torch.repeat_interleave(
        match.pos.long(), deg)
    dst = vals[match.st.long()[owner] + within]
    landed = int(torch.unique(dst).numel())
    rows = {}
    rows["halo_push_or"] = _hold(
        torch, lambda i, x, c, h, m: cuda_halo.halo_push_or(i, x, c, h, m, edges),
        cuda_halo.halo_push_or_plain, lambda: (ids, words, csr, hits.clone(), match),
        lambda a: [a[3]], matched * (8 + 4 * w) + edges * 4 + landed * 8 * w)
    rows["halo_push_or"].update(pairs=int(ids.numel()), valid=int((ids < n_pad).sum()),
                                matched=matched, edges=edges, rows_written=landed, w=w)

    def match_row(ids_, csr_):
        def kernel(i, c, box):
            box.append(cuda_halo.halo_push_match(i, c))

        def plain(i, c, box):
            box.append(cuda_halo.halo_push_match_plain(i, c))

        want = cuda_halo.halo_push_match_plain(ids_, csr_)
        hit = int((want.deg > 0).sum())
        row = _hold(torch, kernel, plain, lambda: (ids_, csr_, []), lambda a: list(a[2][-1]),
                    ids_.numel() * 16 + hit * 12 + 8)
        row.update(pairs=int(ids_.numel()), valid=int((ids_ < n_pad).sum()), matched=hit,
                   edges=int(want.total[0]), sources=int(csr_[0].numel()))
        return row

    rows["halo_push_match"] = match_row(ids, csr)
    rows["halo_push_match"]["widest_recorded_match"] = match_row(*match_snap)
    return rows


def _mesh_phase(ctx, rmat, road, seed):
    """Phase 15: the -gn > 1 routes over a logical mesh of MESH_SHARDS
    entries on the card (``cli.main(..., mesh_devices=[cuda:0] * 4)``):
    the query-sharded bitbell and CSR pull and the vertex-sharded forest
    (both halo routes) on RMAT-20 K = 64, the owner-partitioned and the
    query-sharded push on road-1024 K = 16, a chip loss resharded; H1-H3
    held against their plain versions on their widest recorded calls."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    t_phase = time.perf_counter()
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, push_sharded, sharded_bell,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        telemetry,
    )

    pctx = (torch, np, cli, timing, launches, dev)
    rows = {}
    argv20 = ["chip_smoke", "-g", rmat["gpath"], "-q", rmat["qpath"], "-gn", str(MESH_SHARDS)]
    argv1 = ["chip_smoke", "-g", road["gpath"], "-q", road["qpath"], "-gn", str(MESH_SHARDS)]
    single20 = rmat["single_s"] = _run_cli(cli, argv20[:-1] + ["1"])[3]
    single1 = road["single_s"] = _run_cli(cli, argv1[:-1] + ["1"])[3]
    checks20 = (rmat["fv"], rmat["want"])
    checks1 = (road["fv"], road["want"])
    g20 = tio.load_graph_bin(rmat["gpath"])
    n_pad2 = 2 * -(-g20.n // 2)
    halo2 = dict(MSBFS_VSHARD="2", MSBFS_STATS="2",
                 MSBFS_HALO_BUDGET=str(sharded_bell.default_halo_budget(n_pad2, 2)),
                 MSBFS_PUSH_HALO=str(sharded_bell.default_push_halo_budget(
                     g20.num_directed_edges, 2)))
    n_pad4 = 4 * -(-g20.n // 4)
    halo4 = dict(MSBFS_VSHARD="4", MSBFS_STATS="2", MSBFS_PUSH_HALO="0",
                 MSBFS_HALO_BUDGET=str(sharded_bell.default_halo_budget(n_pad4, 4)))

    rows["mesh rmat-20"], _ = _mesh_path(pctx, "mesh rmat-20", argv20, {}, single20, checks20)
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel.distributed import (
        DistributedEngine,
    )

    def csr_f():
        mesh4 = mesh.make_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
        return DistributedEngine(mesh4, g20, backend="csr").f_values(
            tio.pad_queries(rmat["queries"]))

    rows["mesh csr rmat-20"], _ = _mesh_path(pctx, "mesh csr rmat-20", argv20,
                                             dict(MSBFS_BACKEND="csr"), single20,
                                             checks20, direct=csr_f)

    rows["vshard2 rmat-20"], text2 = _mesh_path(pctx, "vshard2 rmat-20", argv20, halo2,
                                                single20, checks20)
    assert set(rows["vshard2 rmat-20"]["halo_routes"]) >= {"sparse", "dense"}, text2
    rows["vshard4 rmat-20"], text4 = _mesh_path(pctx, "vshard4 rmat-20", argv20, halo4,
                                                single20, checks20)
    assert set(rows["vshard4 rmat-20"]["halo_routes"]) >= {"sparse", "dense"}, text4

    telemetry.flight_recorder().clear()
    rows["reshard rmat-20"], _ = _mesh_path(pctx, "reshard rmat-20", argv20,
                                            dict(MSBFS_FAULTS="chip:rank1:1"), single20,
                                            checks20)
    ring = [e for e in telemetry.flight_recorder().snapshot() if e["kind"] == "reshard"]
    assert ring and ring[-1]["failed_ranks"] == [1], ring
    rows["reshard rmat-20"].update(failed_ranks=[1], survivor_shards=ring[-1]["survivor_shards"])

    rows["vshard4 road-1024"], _ = _mesh_path(pctx, "vshard4 road-1024", argv1,
                                              dict(MSBFS_VSHARD="4"), single1, checks1)
    rows["mesh push road-1024"], _ = _mesh_path(pctx, "mesh push road-1024", argv1,
                                                dict(MSBFS_BACKEND="push"), single1, checks1)
    # H3 on the owner-partitioned push's widest level of road-1024 and on
    # its first thin one: the engine as the CLI builds it, recorded call by
    # call (a host read each), every launch timed alone.
    g1 = tio.load_graph_bin(road["gpath"])
    eng = push_sharded.ShardedPushEngine(mesh.make_mesh(1, MESH_SHARDS, devices=[dev] * 4), g1)
    thin3 = {}

    def pick_expand(args, kwargs):
        table, queue, count, frontier, hits, lo, n_pad, ids, words, bcount, peak, ctrl = args[:12]
        if not bool(ctrl[0]):
            return 0, None
        listed = min(int(count[0]), queue.shape[0])
        snap = (table, queue.clone(), count.clone(), frontier.clone(), hits.clone(),
                lo, n_pad, ids.clone(), words.clone(), bcount.clone(), peak.clone(), ctrl.clone())
        if 0 < listed < THIN_ENTRIES and not thin3:
            thin3.update(weight=listed, snap=snap)
        return listed, snap

    with _record(push_sharded, "owner_push_expand", pick_expand, timed=True) as h3:
        f3 = eng.f_values(tio.pad_queries(road["queries"])).cpu().numpy()
    assert np.array_equal(f3, road["fv"]), (f3, road["fv"])
    w3 = (eng.capacity, eng.boundary)
    block, width = eng.block, eng.width
    w_words = -(-len(road["queries"]) // 32)
    halo_push = MESH_SHARDS * eng.boundary * 4 * (1 + w_words)
    rows["vshard4 road-1024"].update(capacity=w3[0], boundary=w3[1],
                                     halo_bytes_per_level=halo_push)
    del eng, g1

    # H2 and H1 on the vertex-sharded forest's sparse levels of RMAT-20:
    # the engines of "vshard2 rmat-20" and "vshard4 rmat-20" as the CLI
    # builds them, run again outside the counted paths and recorded call
    # by call (a host read each); their F must still be the route's.
    def pick_push(args, kwargs):
        ids, words, csr, hits, match, edges = args
        valid = int((ids < n_pad2).sum())
        return valid, (ids.clone(), words.clone(), csr, hits.clone(),
                       type(match)(*(t.clone() for t in match)), edges)

    def pick_match(args, kwargs):
        ids, csr = args
        return int((ids < n_pad2).sum()), (ids.clone(), csr)

    def pick_pair(args, kwargs):
        ids, words, plane = args[:3]
        lo = args[3] if len(args) > 3 else 0
        valid = int(((ids >= lo) & (ids < lo + plane.shape[0])).sum())
        return valid, (ids.clone(), words.clone(), plane.clone(), lo)

    queries20 = tio.pad_queries(rmat["queries"])
    for (q, v, halo), fn, pick in (((2, 2, halo2), "halo_push_or", pick_push),
                                   ((1, 4, halo4), "halo_pair_or", pick_pair)):
        eng = sharded_bell.ShardedBellEngine(
            mesh.make_mesh(q, v, devices=[dev] * MESH_SHARDS), g20,
            halo_budget=int(halo["MSBFS_HALO_BUDGET"]),
            push_budget=int(halo["MSBFS_PUSH_HALO"]))
        with _record(sharded_bell, fn, pick) as rec, \
                _record(sharded_bell, "halo_push_match", pick_match) as rec_m:
            f = eng.f_values(queries20).cpu().numpy()
        assert np.array_equal(f, rmat["fv"]), (fn, f, rmat["fv"])
        assert "snap" in rec, fn
        if fn == "halo_push_or":
            h2, h2m = rec, rec_m
        else:
            h1 = rec
        del eng
    del g20
    torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"{name}: " + json.dumps(row))

    if torch.cuda.device_count() > 1:
        cards = min(MESH_SHARDS, torch.cuda.device_count())
        got = _run_cli(cli, argv20[:-1] + [str(cards)])
        assert got[:2] == (int(np.argmin(rmat["fv"])), int(rmat["fv"].min())), got
        print(f"distinct cards: -gn {cards} over cuda:0..{cards - 1} on rmat-20: winner "
              f"{got[0] + 1}, F {got[1]}, computation {got[3]} s")
    else:
        print("distinct cards: not run (this machine has one card); the peer copies "
              "between cards are unproven")

    # ---- H1-H3 against their plain versions on their widest recorded calls
    # The bounds count what each recorded call needs: every pair's id, but
    # words and a row's read-modify-write only for the pairs that land
    # (sentinel and unmatched pairs are never read past their id), each
    # written row once however many pairs it gets.  No single torch call
    # ORs rows (duplicates included), so none of H1-H3 has a library time.
    shape = {}
    shape.update(_h2_rows(torch, cuda_halo, h2["snap"], h2m["snap"], n_pad2))
    ids, words, plane, lo = h1["snap"]
    w = plane.shape[1]
    valid = (ids >= lo) & (ids < lo + plane.shape[0])
    landed = int(torch.unique(ids[valid]).numel())
    shape["halo_pair_or"] = _hold(
        torch, cuda_halo.halo_pair_or, cuda_halo.halo_pair_or_plain,
        lambda: (ids, words, plane.clone(), lo), lambda a: [a[2]],
        ids.numel() * 4 + h1["weight"] * 4 * w + landed * 8 * w)
    shape["halo_pair_or"].update(pairs=int(ids.numel()), valid=h1["weight"],
                                 rows_written=landed, w=w)
    def hold3(rec):
        snap = rec["snap"]
        table, queue, count, frontier, hits, lo, n_pad = snap[:7]
        listed = rec["weight"]
        w = frontier.shape[1]
        bnd = snap[7].shape[0]
        v = table[queue[:listed].long()].reshape(-1).long()
        inside = (v < n_pad) & (v >= lo) & (v < lo + block)
        landed = int(torch.unique(v[inside]).numel())
        border = int(((v < n_pad) & ~inside).sum())

        def fresh3():
            return (table, queue, count, frontier, hits.clone(), snap[5], snap[6],
                    snap[7].clone(), snap[8].clone(), snap[9].clone(), snap[10].clone(), snap[11])

        # The queue, table row and frontier words of each listed row; each
        # in-block hit row once; the boundary buffers, written whole.
        row = _hold(
            torch, cuda_halo.owner_push_expand, cuda_halo.owner_push_expand_plain, fresh3,
            lambda a: [a[4], a[7], a[8], a[9], a[10]],
            listed * (4 + 4 * width + 4 * w) + landed * 8 * w + bnd * 4 * (1 + w))
        row.update(listed=listed, width=width, slots=int(v.numel()), in_block=int(inside.sum()),
                   rows_written=landed, boundary_slots=border, boundary=bnd, w=w, block=block)
        return row

    shape["owner_push_expand"] = hold3(h3)
    shape["owner_push_expand"].update(run_sum_ms=h3["sum_ms"], run_launches=h3["calls"],
                                      run="vshard4 road-1024 f_values, a fresh engine")
    thin_row = hold3(thin3)
    for name, row in shape.items():
        print(f"compare mesh {name} (widest recorded call): " + json.dumps(row))
        assert row["max_abs_err"] == 0, (name, row)
    print("compare mesh owner_push_expand (thin level: the first with fewer than "
          f"{THIN_ENTRIES} listed rows): " + json.dumps(thin_row))
    assert thin_row["max_abs_err"] == 0, thin_row
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; card: {CARD}")
    return shape



# ---- phase 16: the 2D adjacency mesh (MSBFS_MESH=2x2, -gn 4) on a logical
# mesh over the card


def _small_data(ctx, name, n, edges, queries, groups=None):
    """A graph's files, its F vector from the single-device CLI on the
    card (MSBFS_STATS=1) and scipy's F of the winner and ``groups``."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )

    gpath, qpath = os.path.join(tmp, f"{name}-m2.bin"), os.path.join(tmp, f"{name}-m2-q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    err = io.StringIO()
    with _env(MSBFS_STATS="1"), contextlib.redirect_stderr(err):
        _run_cli(cli, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"])
    fv = _stats_table(np, err.getvalue())[2]
    a = _scipy_matrix(sp, np, CSRGraph.from_edges(n, edges))
    want = {q: _scipy_f(cg, np, a, np.asarray(queries[q]))
            for q in sorted({int(np.argmin(fv)), *(groups or range(MESH_SCIPY_GROUPS))})
            if q < len(queries)}
    return dict(gpath=gpath, qpath=qpath, queries=queries, fv=fv, want=want)


def _mesh2d_path(ctx, name, data, env, single):
    """One MSBFS_MESH=2x2 -gn 4 CLI run as a counted path (:func:`_mesh_path`)
    with its collective ledger and its mesh route line."""
    torch, np, cli, timing, launches, dev = ctx
    argv = ["chip_smoke", "-g", data["gpath"], "-q", data["qpath"], "-gn", str(MESH_SHARDS)]
    timing.reset_collective_bytes()
    timing.reset_collective_rounds()
    row, text = _mesh_path(ctx, name, argv, {"MSBFS_MESH": "2x2", **env}, single,
                           (data["fv"], data["want"]))
    route = [ln for ln in text.splitlines() if ln.startswith("mesh route:")]
    assert route, text
    row.update(route=route[0], collective_bytes=timing.collective_bytes(),
               collective_rounds=timing.collective_rounds(), env=env)
    return row


def _mesh2d_phase(ctx, rmat, road, rmat16, rmat14, seed):
    """Phase 16: MSBFS_MESH=2x2 at -gn 4 over a logical mesh of MESH_SHARDS
    entries on the card: RMAT-20 K = 64 (defaults; streamed; a chip loss
    rebuilt on the 1x2 survivor row, pipelined), road-1024 K = 16 (ring
    with the sparse wire; the async drive), RMAT-16 K = 1 on byte planes
    (one-shot) and RMAT-14 K = 64 on the mxu kernel; then M1, M2, M4's
    take form and H1's segmented form recorded call by call in engine runs
    of their own and held against their plain versions."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    t_phase = time.perf_counter()
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo,
        cuda_mesh,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, partition2d,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        telemetry,
    )

    pctx = (torch, np, cli, timing, launches, dev)
    rows = {}
    single = {}
    for key, data in (("rmat20", rmat), ("road1024", road), ("rmat16", rmat16),
                      ("rmat14", rmat14)):
        # Phase 15's single-device spans of the same files, where it ran.
        single[key] = data.get("single_s") or _run_cli(
            cli, ["chip_smoke", "-g", data["gpath"], "-q", data["qpath"], "-gn", "1"])[3]
    rows["mesh2d rmat-20"] = _mesh2d_path(pctx, "mesh2d rmat-20", rmat, {}, single["rmat20"])
    rows["mesh2d streamed rmat-20"] = _mesh2d_path(
        pctx, "mesh2d streamed rmat-20", rmat, dict(MSBFS_MESH_RESIDENCY="streamed"),
        single["rmat20"])
    telemetry.flight_recorder().clear()
    rows["mesh2d reshard rmat-20"] = _mesh2d_path(
        pctx, "mesh2d reshard rmat-20", rmat,
        dict(MSBFS_FAULTS="chip:rank1:1", MSBFS_MERGE_TREE="pipelined"), single["rmat20"])
    ring = [e for e in telemetry.flight_recorder().snapshot() if e["kind"] == "reshard"]
    assert ring and ring[-1]["failed_ranks"] == [1] and ring[-1]["survivor_shards"] == 2, ring
    rows["mesh2d reshard rmat-20"].update(failed_ranks=[1], survivor_shards=2,
                                          survivor_mesh="1x2")
    assert any(k.startswith("chunk_merge:or") for k in VARIANTS["mesh2d reshard rmat-20"])
    rows["mesh2d ring road-1024"] = _mesh2d_path(
        pctx, "mesh2d ring road-1024", road, dict(MSBFS_MERGE_TREE="ring"), single["road1024"])
    rows["mesh2d async road-1024"] = _mesh2d_path(
        pctx, "mesh2d async road-1024", road, dict(MSBFS_ASYNC_LEVELS="4"), single["road1024"])
    # M1 only on the exchanges' commits (one a shard a round, each writing
    # the first local wave's send); the local waves are M4's commit form.
    async_v = VARIANTS["mesh2d async road-1024"]
    assert async_v.get("chunk_merge:max/commit/send") == launches[
        "mesh2d async road-1024"]["chunk_merge"], async_v
    assert launches["mesh2d async road-1024"]["chunk_merge"] == MESH_SHARDS * rows[
        "mesh2d async road-1024"]["collective_rounds"], rows["mesh2d async road-1024"]
    assert async_v.get("forest_max_commit:cand/commit", 0) > 0, async_v
    # A one-level road forest is one M4 launch with the final take in it (no
    # forest_gather), and every sparse gather one H1 launch: fewer launches
    # than a launch a segment and an M1 merge a sparse OR col leg gave on
    # this data (H1 4332 ring / 800 async, chunk_merge 1736 ring; M4 1748
    # and as many forest_gather).
    ring_n = launches["mesh2d ring road-1024"]
    async_n = launches["mesh2d async road-1024"]
    assert "forest_gather" not in async_n and async_n["forest_max"] <= 1748, async_n
    assert VARIANTS["mesh2d async road-1024"].get("forest_max:cand/take") == async_n["forest_max"]
    assert ring_n["halo_pair_or"] < 4332 and async_n["halo_pair_or"] < 800, (ring_n, async_n)
    assert ring_n["chunk_merge"] < 1736, ring_n
    for path in ("mesh2d ring road-1024", "mesh2d async road-1024"):
        assert VARIANTS[path].get("halo_pair_or:seg") == launches[path]["halo_pair_or"], path
    print("mesh2d road-1024 gathers and folds: " + json.dumps({
        path: {k: launches[path].get(k, 0)
               for k in ("halo_pair_or", "chunk_merge", "forest_max", "forest_max_commit",
                         "forest_gather")}
        for path in ("mesh2d ring road-1024", "mesh2d async road-1024")}))
    rows["mesh2d byte rmat-16"] = _mesh2d_path(
        pctx, "mesh2d byte rmat-16", rmat16,
        dict(MSBFS_MESH_PLANE="byte", MSBFS_MERGE_TREE="oneshot"), single["rmat16"])
    assert "wire_encode:bytes" in VARIANTS["mesh2d byte rmat-16"]
    rows["mesh2d mxu rmat-14"] = _mesh2d_path(
        pctx, "mesh2d mxu rmat-14", rmat14, dict(MSBFS_MESH_KERNEL="mxu"), single["rmat14"])
    # Every merge tree runs once: halving is auto's choice on the 2x2 mesh.
    for tree, path in (("halving", "mesh2d rmat-20"), ("ring", "mesh2d ring road-1024"),
                       ("oneshot", "mesh2d byte rmat-16"),
                       ("pipelined", "mesh2d reshard rmat-20")):
        rows[path]["merge_tree"] = tree

    # The ring path's engine again, a level a step: the wire trace's sparse
    # levels (their decode is H1), and M1 and M2 recorded call by call.
    g1 = tio.load_graph_bin(road["gpath"])
    padded1 = tio.pad_queries(road["queries"])
    mesh4 = mesh.make_mesh2d(2, 2, devices=[dev] * MESH_SHARDS)
    eng = partition2d.Mesh2DEngine(mesh4, g1, merge_tree="ring", level_chunk=128)

    def pick_merge(args, kwargs):
        parts = args[0]
        commit = kwargs.get("commit")
        if commit is not None or len(parts) < 2:
            return 0, None
        out = kwargs.get("out", args[1] if len(args) > 1 else None)
        return parts[0].numel() * len(parts), lambda: (
            [p.clone() for p in parts], out.clone(), kwargs.get("op", "or"))

    def pick_encode(args, kwargs):
        plane, budget = args[0], args[1]
        lanes = args[2] if len(args) > 2 else kwargs.get("lanes", 1)
        return int((plane != 0).sum()), lambda: (plane.clone(), budget, lanes)

    def picks_gather(overlap):
        # The gathers whose segments land on disjoint rows (row gathers, MAX
        # col legs), or (``overlap``) on shared rows: an OR col leg's peers
        # all land on the own plane and OR together across segments.
        def pick(args, kwargs):
            segs, plane = list(args[0]), args[1]
            spans = sorted((x.base, x.base + x.rows) for x in segs)
            if any(a[1] > b[0] for a, b in zip(spans, spans[1:])) != overlap:
                return 0, None
            valid = torch.stack([((x.ids - x.lo >= 0) & (x.ids - x.lo < x.rows)).sum()
                                 for x in segs]).sum()
            return int(valid), lambda: ([x._replace(ids=x.ids.clone(), words=x.words.clone())
                                         for x in segs], plane.clone())

        return pick

    t0 = time.perf_counter()
    with _record(cuda_mesh, "chunk_merge", pick_merge) as m1, \
            _record(cuda_mesh, "halo_pair_or_segments", picks_gather(False)) as h1s, \
            _record(cuda_mesh, "halo_pair_or_segments", picks_gather(True)) as h1o, \
            _record(partition2d, "wire_encode", pick_encode, timed=True) as m2:
        trace = eng.wire_trace(padded1)
    trace_s = time.perf_counter() - t0
    assert trace["sparse_levels"] > 0, trace["sparse_levels"]
    assert len(trace["levels"]) == rows["mesh2d ring road-1024"]["levels"], trace["levels"][-1]
    encodings = {e["encoding"] for e in trace["levels"]}
    rows["mesh2d ring road-1024"].update(
        wire_trace_levels=len(trace["levels"]), sparse_levels=trace["sparse_levels"],
        bytes_measured=trace["bytes_measured"], bytes_dense_model=trace["bytes_dense_model"],
        encodings=sorted(encodings), wire_trace_s=trace_s)
    del eng

    # The async path's engine again: its rounds against the levels, and M4
    # and M1's commit recorded call by call.
    eng = partition2d.Mesh2DEngine(mesh4, g1, async_levels=4, level_chunk=128)

    def pick_take(args, kwargs):
        prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits, go = args[:10]
        floor = args[10] if len(args) > 10 else kwargs.get("floor")
        slots = sum(r * c for r, c in tables.pieces[i])
        return slots, lambda: (prev.clone(), prev_rows, cols, tables, i,
                               None if scratch is None else scratch.clone(), last_off,
                               final_slot, hits.clone(), go.clone(), floor)

    def pick_commit(args, kwargs):
        commit = kwargs.get("commit")
        if commit is None:
            return 0, None
        parts = args[0]
        return parts[0].numel() * len(parts), lambda: (
            [p.clone() for p in parts], commit.clone())

    # No snapshot is taken inside the profiled waves (its copies would land
    # in their profile); the next waves' calls have the same shapes.
    profiling = {"on": False}

    def pick_wave(args, kwargs):
        if profiling["on"]:
            return 0, None
        prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, row0, commit, go = args[:11]
        floor = args[11] if len(args) > 11 else kwargs.get("floor")
        slots = sum(r * c for r, c in tables.pieces[i])
        return slots, lambda: (prev.clone(), prev_rows, cols, tables, i,
                               None if scratch is None else scratch.clone(), last_off,
                               final_slot, row0, commit.clone(), go.clone(), floor)

    # The first local waves of the run profiled: every device kernel they
    # launch, beside their launch counts.
    real_waves = partition2d.Mesh2DEngine._local_waves
    profiled_waves = {}

    def local_waves(self, run, floor):
        if profiled_waves:
            return real_waves(self, run, floor)
        from torch.profiler import ProfilerActivity, profile

        tag, before = run.tag, dict(timing.launch_counts())
        profiling["on"] = True
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                real_waves(self, run, floor)
                torch.cuda.synchronize()
        finally:
            profiling["on"] = False
        after = timing.launch_counts()
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        profiled_waves.update(waves=run.tag - tag, kernels=names, launches={
            k: after.get(k, 0) - before.get(k, 0) for k in after if after.get(k, 0) != before.get(k, 0)})

    timing.reset_collective_rounds()
    partition2d.Mesh2DEngine._local_waves = local_waves
    t0 = time.perf_counter()
    try:
        with _record(cuda_mesh, "forest_max_take", pick_take) as m4, \
                _record(cuda_mesh, "forest_max_commit", pick_wave) as m4c, \
                _record(cuda_mesh, "chunk_merge", pick_commit) as m1c, \
                _record(cuda_mesh, "halo_pair_or_segments", picks_gather(False)) as h1c:
            f_async = eng.f_values(padded1).cpu().numpy()
    finally:
        partition2d.Mesh2DEngine._local_waves = real_waves
    async_s = time.perf_counter() - t0
    rounds = timing.collective_rounds()
    assert np.array_equal(f_async, road["fv"]), (f_async, road["fv"])
    depth = rows["mesh2d async road-1024"]["levels"]
    assert rounds < depth, (rounds, depth)
    # A local wave is M4's commit form, a launch a shard, and nothing else on
    # the device but the flags' one read (one stack kernel and its copy to
    # the host): no fill, and not the parent's where / zeros / copy / fill
    # and M1 a shard.
    waves = profiled_waves["waves"]
    assert profiled_waves["launches"] == {"forest_max_commit": MESH_SHARDS * waves}, profiled_waves
    others = {k: v for k, v in profiled_waves["kernels"].items()
              if "forest_max_kernel" not in k and not k.startswith("Memcpy DtoH")}
    assert sum(others.values()) <= waves and not any("Fill" in k for k in others), profiled_waves
    rows["mesh2d async road-1024"].update(rounds=rounds, levels=depth, engine_f_values_s=async_s,
                                          first_local_waves=profiled_waves)
    del eng, g1
    torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"{name}: " + json.dumps(row))
    if torch.cuda.device_count() >= MESH_SHARDS:
        with _env(MSBFS_MESH="2x2"):
            got = _run_cli(cli, ["chip_smoke", "-g", rmat["gpath"], "-q", rmat["qpath"],
                                 "-gn", str(MESH_SHARDS)])
        assert got[:2] == (int(np.argmin(rmat["fv"])), int(rmat["fv"].min())), got
        print(f"distinct cards: MSBFS_MESH=2x2 over cuda:0..3 on rmat-20: winner {got[0] + 1}, "
              f"F {got[1]}, computation {got[3]} s")
    else:
        print("distinct cards: mesh2d not run over distinct cards (this machine has "
              f"{torch.cuda.device_count()} card); the peer copies between cards are unproven")

    # ---- M1, M2, M4 and H1's segmented form against their plain versions on
    # their widest recorded calls.  M1 (two chunks: one bitwise_or or
    # maximum), M4 (a take, an amax a bucket and the final take) and the
    # gather (one index_put_ of the rebased pairs) have library times; no
    # torch call encodes a sparse wire.
    shape = {}
    parts, out, op = m1["snap"]
    words = out.numel()
    shape["chunk_merge"] = _hold(
        torch, cuda_mesh.chunk_merge, cuda_mesh.chunk_merge_plain,
        lambda: (parts, out.clone(), op), lambda a: [a[1]], 4 * words * (len(parts) + 1))
    if len(parts) == 2:
        lib_out = torch.empty_like(out)
        fn = torch.bitwise_or if op == "or" else torch.maximum
        library = lambda: fn(parts[0].view(-1), parts[1].view(-1), out=lib_out.view(-1))  # noqa: E731
        shape["chunk_merge"]["library_ms"] = _time_ms(torch, library, lambda: None)
        # M1 and the library call in turns (kernel first, then library first),
        # each a median of 10 launches: their spreads, side by side.
        m1_out = out.clone()
        kernel = lambda: cuda_mesh.chunk_merge(parts, out=m1_out, op=op)  # noqa: E731
        turns = []
        for i in range(4):
            pair = {}
            for which in (("kernel", "library") if i % 2 == 0 else ("library", "kernel")):
                pair[which] = _time_ms(torch, kernel if which == "kernel" else library,
                                       lambda: None)
            turns.append(pair)
        shape["chunk_merge"]["interleaved_ms"] = turns
    shape["chunk_merge"].update(chunks=len(parts), words=words, op=op)
    parts, c = m1c["snap"]
    words = parts[0].numel()
    # The chunks read, then the commit's bytes for the lanes it improved.
    plain_c = c.clone()
    cuda_mesh.chunk_merge_plain(parts, None, "max", plain_c)
    nbytes, improved, neg_sectors, mask_sectors = _commit_bytes(torch, c, plain_c.delta)
    commit_row = _hold(
        torch, lambda p, cm: cuda_mesh.chunk_merge(p, op="max", commit=cm),
        lambda p, cm: cuda_mesh.chunk_merge_plain(p, None, "max", cm),
        lambda: (parts, c.clone()), lambda a: [t for t in a[1].tensors() if t is not None],
        4 * words * len(parts) + nbytes)
    commit_row.update(chunks=len(parts), words=words, acc_set=bool(c.acc_set),
                      send=c.send is not None, improved_lanes=improved,
                      neg_sectors_written=neg_sectors, mask_sectors_written=mask_sectors)
    plane, budget, lanes = m2["snap"]
    total = plane.numel()

    def enc_kernel(p, b, ln, box):
        box.append(cuda_mesh.wire_encode(p, b, ln))

    def enc_plain(p, b, ln, box):
        box.append(cuda_mesh.wire_encode_plain(p, b, ln))

    shape["wire_encode"] = _hold(
        torch, enc_kernel, enc_plain, lambda: (plane, budget, lanes, []),
        lambda a: list(a[3][-1]), 4 * total + 8 * budget + 8)
    shape["wire_encode"].update(words=total, budget=budget, count=m2["weight"], lanes=lanes,
                                run_sum_ms=m2["sum_ms"], run_launches=m2["calls"],
                                run="mesh2d ring road-1024 wire_trace, a level a step")
    shape["forest_max_commit"] = _mesh2d_m4_commit(torch, cuda_mesh, m4c["snap"])
    extra = {"forest_max:level": _mesh2d_m4(torch, cuda_mesh, shape, m4["snap"]),
             "halo_pair_or:seg": _mesh2d_gather(
                 torch, cuda_halo, max((h1s, h1c), key=lambda r: r.get("weight", -1))["snap"]),
             "halo_pair_or:seg overlapping": _mesh2d_gather(
                 torch, cuda_halo, h1o["snap"], overlap=True)}
    for name, row in (*shape.items(), ("chunk_merge:max/commit", commit_row), *extra.items()):
        print(f"compare mesh2d {name} (widest recorded call): " + json.dumps(row))
        assert row["max_abs_err"] == 0, (name, row)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s; card: {CARD}")
    return shape


def _mesh2d_m4(torch, cuda_mesh, shape, snap):
    """M4 on its widest recorded call (the async path's take form): the
    take held and timed as the kernel line's row, with its library chain
    (the candidate step, a take, an amax a bucket, the final take); then
    the same level without the take (into scratch rows), and that level
    followed by K1s's forest_gather, the two launches the take replaced.
    Returns the level form's row."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell,
    )

    prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits, go, floor = snap
    pieces = tables.pieces[i]
    slots = sum(r * c for r, c in pieces)
    rows = sum(r for r, _ in pieces)
    n, w = hits.shape
    live_cols = cols[:slots][cols[:slots] < prev_rows]
    live = int(live_cols.numel())
    # A source row is read once however many live slots name it.
    distinct = int(torch.unique(live_cols).numel())
    slot = final_slot.long()
    copied = int((slot < last_off).sum())
    shape["forest_max"] = _hold(
        torch, cuda_mesh.forest_max_take,
        lambda pv, pr, cl, tb, ii, sc, lo, fs, h, g, fl: cuda_mesh.forest_max_take_plain(
            pv, pr, cl, tb.pieces[ii], sc, lo, fs, h, g, fl),
        lambda: (prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits.clone(),
                 go, floor),
        lambda a: [a[8]], 4 * slots + 4 * w * distinct + 4 * n + 4 * w * (n + copied))
    got = hits.clone()
    cuda_mesh.forest_max_take(prev, prev_rows, cols, tables, i, scratch, last_off, final_slot,
                              got, go, floor)
    # The library chain: every step a torch call on the same inputs.
    index = cols[:slots].long()
    vbuf = torch.zeros((last_off + rows + 1, w), dtype=torch.int32, device=hits.device)
    if last_off:
        vbuf[:last_off].copy_(scratch[:last_off])
    lib_hits = torch.empty_like(hits)

    def library(take=True):
        v = prev[:prev_rows] if floor is None else cuda_mesh._cand(prev[:prev_rows], floor)
        g = torch.index_select(torch.cat([v, v.new_zeros((1, w))]), 0, index)
        at = row = 0
        for r, c in pieces:
            torch.amax(g[at : at + r * c].view(r, c, w), 1,
                       out=vbuf[last_off + row : last_off + row + r])
            at, row = at + r * c, row + r
        if take:
            torch.index_select(vbuf, 0, slot, out=lib_hits)

    library()
    assert torch.equal(lib_hits, got), "M4's library chain disagrees with the kernel"
    shape["forest_max"].update(
        library_ms=_time_ms(torch, library, lambda: None), slots=slots, live_slots=live,
        source_rows=distinct, level_rows=rows, rows=n, copied_rows=copied, w=w, cand=floor is not None,
        levels_before=int(last_off > 0), variant="take")
    # The same level without the take: its rows into scratch (the level form).
    level = _hold(
        torch, cuda_mesh.forest_max,
        lambda pv, pr, cl, tb, ii, o, fl: cuda_mesh.forest_max_plain(
            pv, pr, cl[:slots], tb.pieces[ii], o, fl),
        lambda: (prev, prev_rows, cols, tables, i,
                 torch.empty((rows, w), dtype=torch.int32, device=hits.device), floor),
        lambda a: [a[5]], 4 * slots + 4 * w * distinct + 4 * w * rows)
    level["library_ms"] = _time_ms(torch, lambda: library(take=False), lambda: None)
    v_cat = torch.zeros((last_off + rows + 1, w), dtype=torch.int32, device=hits.device)
    if last_off:
        v_cat[:last_off].copy_(scratch[:last_off])
    split_hits = hits.clone()

    def split():
        cuda_mesh.forest_max(prev, prev_rows, cols, tables, i, v_cat[last_off : last_off + rows],
                             floor)
        cuda_bell.forest_final_gather(v_cat, final_slot, split_hits, go)

    split()
    assert torch.equal(split_hits, got), "the level and forest_gather disagree with the take"
    level.update(level_and_forest_gather_ms=_time_ms(torch, split, lambda: None),
                 take_ms=shape["forest_max"]["ms"], slots=slots, live_slots=live,
                 source_rows=distinct, rows=rows, w=w)
    return level


def _mesh2d_m4_commit(torch, cuda_mesh, snap):
    """M4's commit form on its widest recorded call (a local wave of the
    async path), held bit for bit against its plain version (the take into
    a scratch hit plane, then the commit and the send's where) over neg,
    delta, the changed mask, the flag and the send, and timed beside its
    bound: the cols of the own rows' slots, each distinct live source row
    they name, the own rows' final slots and copied scratch rows, and the
    commit's bytes for the lanes it improved (:func:`_commit_bytes`).
    Beside it, the parent's wave on the same inputs: the
    take of every hit row, M1's commit of the own rows and the send's
    where, zeros and copy and the flag's fill.  No torch call computes the
    commit form, so it has no library time."""
    prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, row0, c, go, floor = snap
    pieces = tables.pieces[i]
    rows, w = c.neg.shape
    dev = c.neg.device
    # Each level row's first slot and width, then the own final rows' slots.
    widths = torch.cat([torch.full((r,), cw, dtype=torch.int64, device=dev) for r, cw in pieces])
    starts = torch.cumsum(widths, 0) - widths
    slot = final_slot[row0 : row0 + rows].long()
    level_row = slot - last_off
    folded = (level_row >= 0) & (level_row < widths.numel())
    lr = level_row[folded]
    own_w = widths[lr]
    flat = torch.repeat_interleave(starts[lr], own_w) + (
        torch.arange(int(own_w.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(own_w, 0) - own_w, own_w))
    own_cols = cols[flat]
    live = own_cols[own_cols < prev_rows]
    distinct = int(torch.unique(live).numel())
    copied = int((slot < last_off).sum())
    plain_c = c.clone()
    cuda_mesh.forest_max_commit_plain(prev, prev_rows, cols, pieces, scratch, last_off, final_slot,
                                      row0, plain_c, go, floor)
    commit_bytes, improved, neg_sectors, mask_sectors = _commit_bytes(torch, c, plain_c.delta)
    nbytes = (4 * int(own_cols.numel()) + 4 * w * distinct + 4 * rows + 4 * w * copied
              + commit_bytes)
    row = _hold(
        torch, cuda_mesh.forest_max_commit,
        lambda pv, pr, cl, tb, ii, sc, lo, fs, r0, cm, g, fl: cuda_mesh.forest_max_commit_plain(
            pv, pr, cl, tb.pieces[ii], sc, lo, fs, r0, cm, g, fl),
        lambda: (prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, row0,
                 c.clone(), go, floor),
        lambda a: [t for t in a[9].tensors() if t is not None], nbytes)
    hits = torch.zeros((final_slot.shape[0], w), dtype=torch.int32, device=dev)
    work = {}

    def parent_wave():
        cm = work["c"]
        cuda_mesh.forest_max_take(prev, prev_rows, cols, tables, i, scratch, last_off, final_slot,
                                  hits, go, floor)
        cuda_mesh.chunk_merge([hits[row0 : row0 + rows]], op="max",
                              commit=cm._replace(send=None))
        cm.send.copy_(torch.where(cm.delta, cm.neg, torch.zeros_like(cm.neg)))
        cm.flag.zero_()

    def restore():
        work["c"] = c.clone()

    restore()
    parent_wave()
    row.update(parent_wave_ms=_time_ms(torch, parent_wave, restore), own_rows=rows, w=w,
               row0=row0, level_rows=int(widths.numel()), own_slots=int(own_cols.numel()),
               live_slots=int(live.numel()), source_rows=distinct, improved_lanes=improved,
               neg_sectors_written=neg_sectors, mask_sectors_written=mask_sectors,
               copied_rows=copied,
               tile_slots=sum(r * cw for r, cw in pieces), cand=floor is not None,
               variant=("cand" if floor is not None else "max") + "/commit")
    return row


def _mesh2d_gather(torch, cuda_halo, snap, overlap=False):
    """H1's segmented form on its widest recorded gather of the 2D mesh
    (row gathers and sparse col legs, both mesh2d road-1024 runs), held
    against its plain version; its library time is one index_put_ of the
    pairs rebased outside the timing (the sentinels re-clamped to a
    scratch word past the plane, as JAX does), into zeros: the recorded
    decodes land unique indices on zeroed planes.  ``overlap``: the
    widest gather whose segments share rows (a sparse OR col leg, its
    duplicates ORed across segments), held the same way; index_put_ does
    not OR duplicates, so it has no library time."""
    segs, plane = snap
    w = plane.shape[1]
    ids = [x.ids.long() - x.lo for x in segs]
    ok = [(r >= 0) & (r < x.rows) for r, x in zip(ids, segs)]
    valid = int(sum(int(m.sum()) for m in ok))
    flat = torch.cat([torch.where(m, r + x.base, plane.shape[0]) for r, m, x in zip(ids, ok, segs)])
    vals = torch.cat([x.words for x in segs])
    landed = int(torch.unique(flat[flat < plane.shape[0]]).numel())
    row = _hold(torch, cuda_halo.halo_pair_or_segments, cuda_halo.halo_pair_or_segments_plain,
                lambda: (segs, plane.clone()), lambda a: [a[1]],
                4 * flat.numel() + 4 * w * valid + 8 * w * landed)
    row.update(segments=len(segs), pairs=int(flat.numel()), valid=valid, rows_written=landed,
               w=w, plane_rows=int(plane.shape[0]))
    if overlap:
        return row
    got = plane.clone()
    cuda_halo.halo_pair_or_segments(segs, got)
    buf = torch.zeros((plane.shape[0] + 1, w), dtype=plane.dtype, device=plane.device)
    library = lambda: buf.index_put_((flat,), vals)  # noqa: E731
    library()
    assert bool((plane == 0).all()) and landed == valid, (landed, valid)
    assert torch.equal(buf[:-1], got), "index_put_ disagrees with the segmented decode"
    row["library_ms"] = _time_ms(torch, library, lambda: buf.zero_())
    return row


def _mesh2d_data(ctx, seed):
    """Phase 16's small graphs (the same seeds as phases 4 and 5a): RMAT-16
    with phase 5a's one source, RMAT-14 with phase 4's K = 64 groups."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )

    n16, e16 = generators.rmat_edges(16, edge_factor=16, seed=seed)
    deg = CSRGraph.from_edges(n16, e16).degrees
    source = int(np.random.default_rng(seed).choice(np.nonzero(deg > 0)[0]))
    rmat16 = _small_data(ctx, "rmat16", n16, e16, [np.array([source], dtype=np.int32)], [0])
    n14, e14 = generators.rmat_edges(14, edge_factor=16, seed=seed)
    rmat14 = _small_data(ctx, "rmat14", n14, e14,
                         generators.random_queries(n14, 64, seed=seed + 8))
    return rmat16, rmat14


def _mesh_data(ctx, seed):
    """Phase 15's own data when it runs alone: phase 5b's RMAT-20 K = 64
    and phase 6's road-1024 K = 16 files (the same seeds), each route's F
    vector from the single-device CLI (MSBFS_STATS=1) and scipy's F of
    the winner and the first groups."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )

    out = []
    for name, (n, edges), k, qseed in (
        ("rmat20", generators.rmat_edges(20, edge_factor=16, seed=seed), 64, seed + 12),
        ("road1024", generators.road_edges(1024, 1024, seed=seed + 1), 16, seed + 3),
    ):
        gpath, qpath = os.path.join(tmp, f"{name}.bin"), os.path.join(tmp, f"{name}-q.bin")
        queries = generators.random_queries(n, k, seed=qseed)
        tio.save_graph_bin(gpath, n, edges)
        tio.save_query_bin(qpath, queries)
        err = io.StringIO()
        with _env(MSBFS_STATS="1"), contextlib.redirect_stderr(err):
            _run_cli(cli, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"])
        fv = _stats_table(np, err.getvalue())[2]
        a = _scipy_matrix(sp, np, CSRGraph.from_edges(n, edges))
        groups = sorted({int(np.argmin(fv)), *range(MESH_SCIPY_GROUPS)})
        want = {q: _scipy_f(cg, np, a, queries[q]) for q in groups}
        out.append(dict(gpath=gpath, qpath=qpath, queries=queries, fv=fv, want=want))
    return out

def _run_cli(cli, argv, native=True, mesh_devices=None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, native=native, mesh_devices=mesh_devices)
    report = buf.getvalue()
    print(report, end="")
    assert rc == 0, rc
    return _parse_report(report)


def _parse_report(report):
    """(winner 0-based, F, preprocessing s, computation s) of the CLI's 7
    report lines, after each line is held to its form."""
    import re

    lines = report.splitlines()
    assert len(lines) == len(REPORT_FORM), lines
    for line, form in zip(lines, REPORT_FORM):
        assert re.fullmatch(form, line), (line, form)
    min_k = int(lines[2].rsplit(":", 1)[1]) - 1
    min_f = int(lines[3].rsplit(":", 1)[1])
    comp_s = float(lines[6].split(":", 1)[1].split()[0])
    pre_s = float(lines[5].split(":", 1)[1].split()[0])
    return min_k, min_f, pre_s, comp_s


def main() -> int:
    global DETAIL_DIR, CARD, HOST
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detail-dir", default=DETAIL_DIR,
                    help="directory for the per-level rows of the hybrid paths")
    ap.add_argument("--phases", default="all", choices=("all", "14", "15", "16"),
                    help="all (the proof), 14 (the build, then the tooling phase alone), "
                         "15 (the build, then the mesh phase alone) or 16 (the build, "
                         "then the 2D mesh phase alone)")
    args = ap.parse_args()
    DETAIL_DIR = args.detail_dir
    t_start = time.perf_counter()

    def elapsed(phase):
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s at the start of {phase}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as cg

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.ell import (
        EllGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, mxu, packed, stencil,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels, native_loader,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio, timing,
    )

    card = CARD = _card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # ---- 1. build: the kernels (nvcc, in parallel) and, beside them, the
    # native host runtime (the host C++ compiler)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        loader_job = pool.submit(native_loader.build)
        built = kernels.build_all()
        kernels.library()
        build_s = time.perf_counter() - t0
        loader = loader_job.result()
    native_loader.library()
    loader_s = time.perf_counter() - t0
    print(f"build: {build_s:.3f} s wall for {len(built)} kernels in parallel, "
          f"{loader_s:.3f} s with the native runtime built beside them")
    for name, res in built.items():
        regs = [ln.strip() for ln in res.log.splitlines() if "Used" in ln]
        print(f"  {name}: {res.seconds:.3f} s; {'; '.join(regs)}")
    print(f"  runtime/loader.cpp: {loader.seconds:.3f} s "
          f"({native_loader.CXX_FLAGS}) -> {loader.path.name}")
    HOST = dict(cpus=os.cpu_count(), native_threads=native_loader.threads(1 << 40),
                MSBFS_NATIVE_THREADS=os.environ.get("MSBFS_NATIVE_THREADS"))
    print("host: " + json.dumps(HOST))

    print("host dispatch: " + json.dumps(dict(
        us_per_small_torch_op=_host_dispatch_us(torch, dev),
        event_pair_ms=_time_ms(torch, lambda: None, lambda: None),
        note="host time to enqueue one small torch op on the card; the device "
             "time between two CUDA events with nothing between them")))
    if args.phases in ("14", "15", "16"):
        with tempfile.TemporaryDirectory(prefix="msbfs_smoke_") as tmp:
            ctx = (torch, np, sp, cg, cli, tio, timing, generators, {}, tmp, dev)
            if args.phases == "14":
                elapsed("phase 14")
                _tooling_phase(ctx, args.seed)
            elif args.phases == "15":
                rmat15, road15 = _mesh_data(ctx, args.seed)
                elapsed("phase 15")
                _mesh_phase(ctx, rmat15, road15, args.seed)
            else:
                rmat15, road15 = _mesh_data(ctx, args.seed)
                rmat16, rmat14 = _mesh2d_data(ctx, args.seed)
                elapsed("phase 16")
                _mesh2d_phase(ctx, rmat15, road15, rmat16, rmat14, args.seed)
        print(f"total: {time.perf_counter() - t_start:.1f} s")
        print(_card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    elapsed("phase 2")
    # ---- data: road-4096 (stencil main path), road-1024, RMAT-14 (mxu main
    # path: bench.py config "6") and road-512
    seed = args.seed
    t0 = time.perf_counter()
    n4, e4 = generators.road_edges(4096, 4096, seed=seed)
    g4 = CSRGraph.from_edges(n4, e4)
    sg4 = stencil.StencilGraph.from_host(g4, dev)
    n1, e1 = generators.road_edges(1024, 1024, seed=seed + 1)
    g1 = CSRGraph.from_edges(n1, e1)
    sg1 = stencil.StencilGraph.from_host(g1, dev)
    nr, er = generators.rmat_edges(14, edge_factor=16, seed=seed)
    gr = CSRGraph.from_edges(nr, er)
    mgr = mxu.MxuGraph.from_host(gr, dev)
    n5, e5 = generators.road_edges(512, 512, seed=seed)
    g5 = CSRGraph.from_edges(n5, e5)
    mg5 = mxu.MxuGraph.from_host(g5, dev)
    print(f"data: road-4096 n={n4} directed={g4.num_directed_edges} "
          f"offsets={len(sg4.offsets)} residual={int(sg4.res_src.shape[0])}; "
          f"road-1024 n={n1} residual={int(sg1.res_src.shape[0])}; "
          f"rmat-14 n={nr} dedup={int(mgr.vals.shape[0])} tiles={mgr.nt}; "
          f"road-512 n={n5} dedup={int(mg5.vals.shape[0])} tiles={mg5.nt}; "
          f"{time.perf_counter() - t0:.1f} s host")

    # ---- 2. kernels against their plain versions
    main_shape = _compare_kernels(torch, sg4, 1, seed, "road-4096")
    _compare_kernels(torch, sg1, 8, seed + 1, "road-1024")
    main_shape.update(_compare_mxu(torch, mgr, 2, seed + 6, "rmat-14"))
    _compare_mxu(torch, mg5, 1, seed + 7, "road-512")
    # The level apply at the mxu route's plane shapes.
    _compare_apply(torch, mgr.n_pad, mgr.n, 2, dev, seed + 13, "rmat-14")
    _compare_apply(torch, mg5.n_pad, mg5.n, 1, dev, seed + 14, "road-512")

    elapsed("phase 3")
    # ---- 3. main path through the CLI
    # Removed when the script ends, whichever way it ends.
    tmpdir = tempfile.TemporaryDirectory(prefix="msbfs_smoke_")
    tmp = tmpdir.name
    gpath, qpath = os.path.join(tmp, "road4096.bin"), os.path.join(tmp, "q.bin")
    q4 = generators.random_queries(n4, 16, seed=seed + 2)
    tio.save_graph_bin(gpath, n4, e4)
    tio.save_query_bin(qpath, q4)
    launches = {}
    min_k, min_f, pre_s, comp_s = _run_path(
        cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"],
        "stencil road-4096", launches,
    )
    sweeps = [k for k in VARIANTS["stencil road-4096"] if k.startswith("stencil_sweep:")]
    assert sweeps and all(k.endswith("/res") for k in sweeps), sweeps

    padded4 = tio.pad_queries(q4)
    fast = stencil.StencilEngine(sg4, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    plain = stencil.StencilEngine(
        sg4, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK, plain=True
    )
    t0 = time.perf_counter()
    levels4, reached4, f_fast = fast.query_stats(padded4)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_plain = plain.f_values(padded4).cpu().numpy()
    plain_s = time.perf_counter() - t0
    assert np.array_equal(f_fast, f_plain), (f_fast, f_plain)
    assert int(f_fast[min_k]) == min_f
    want_f = _scipy_stats(cg, np, _scipy_matrix(sp, np, g4), q4[min_k])[2]
    assert want_f == min_f, (want_f, min_f)
    depth = int(levels4.max())
    _batch_start_check(torch, fast, n4, padded4, "stencil road-4096")
    print("main path: " + json.dumps(dict(
        graph="road-4096", K=16, winner=min_k + 1, min_f=min_f, scipy_f=want_f,
        preprocessing_s=pre_s, computation_s=comp_s, levels=depth,
        reached=int(reached4.sum()), engine_query_stats_s=fast_s,
        plain_path_f_values_s=plain_s,
        ms_per_level=comp_s * 1e3 / max(depth, 1),
    )))
    # The sweep and the apply on the planes of a real level, and one chunk
    # of real levels split by kernel.
    mid_carry = _real_level(torch, sg4, padded4, depth, "road-4096")
    _level_split(torch, sg4, mid_carry, 64, "road-4096")
    del mid_carry, fast, plain

    elapsed("phases 4-5")
    # ---- 4-5. the mxu route: RMAT-14 with K = 64, road-512 with K = 16
    ctx = (torch, np, sp, cg, cli, tio, timing, generators, mxu, dev, tmp, launches)
    _mxu_path(ctx, "mxu rmat-14", nr, er, gr, 64, seed + 8)
    trace5 = _mxu_path(ctx, "mxu road-512", n5, e5, g5, 16, seed + 9)
    assert {"push", "matmul"} <= set(trace5), "road-512 ran one direction only"
    del mgr, mg5

    elapsed("phase 5a")
    # ---- 5a. the low-K route on RMAT-16 with one source (BASELINE.json
    # config 1)
    rmat16 = _lowk16_path((torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
                          seed)

    elapsed("phase 5b")
    # ---- 4b. RMAT-20 (BASELINE.json config 2): the forest and ELL kernels
    # against their plain versions at K = 64 and K = 256, then the default
    # and ELL routes through the CLI with K = 64
    t0 = time.perf_counter()
    n20, e20 = generators.rmat_edges(20, edge_factor=16, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g20 = CSRGraph.from_edges(n20, e20)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    bg20 = BellGraph.from_host(g20, dev)
    t_bell = time.perf_counter() - t0
    _host_layouts(torch, n20, e20, g20, bg20, dev, t_csr, t_bell)
    t0 = time.perf_counter()
    eg20 = EllGraph.from_host(g20, dev)
    t_ell = time.perf_counter() - t0
    dedup = int(bg20.sparse[2].shape[0])
    print(f"data: rmat-20 n={n20} directed={g20.num_directed_edges} dedup={dedup} "
          f"max_dedup_degree={int(bg20.sparse[1].max())} "
          f"isolated={int((g20.degrees == 0).sum())} forest_levels={list(bg20.level_sizes)} "
          f"fill={bg20.fill:.3f} ell_vrows={eg20.num_vrows}; host s: generate "
          f"{t_gen:.1f}, csr {t_csr:.1f}, bell {t_bell:.1f}, ell {t_ell:.1f}")
    main_shape.update(_compare_forest_ell(torch, bg20, eg20, 64, seed + 10, "rmat-20"))
    budget = bitbell.default_sparse_budget(dedup)
    _compare_apply(torch, n20, n20, 2, dev, seed + 15, "rmat-20",
                   (bg20.sparse[1], budget, budget))
    _compare_forest_ell(torch, bg20, eg20, 256, seed + 11, "rmat-20")
    torch.cuda.empty_cache()
    ctx20 = (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp)
    rows20, info20 = _rmat20_paths(ctx20, n20, e20, g20, bg20, eg20, 64, seed + 12)
    main_shape.update(rows20)
    main_shape["batch_start"] = BATCH_ROWS["bitbell rmat-20"]
    del eg20
    torch.cuda.empty_cache()

    elapsed("phase 9")
    # ---- 9. resilience on the same RMAT-20 files: the host-streamed route
    # (K1's segment form), the ladder, a real out-of-memory error,
    # checkpoint, MSBFS_STATS=2
    main_shape.update(_streamed_phase(ctx20, n20, g20, bg20, info20, seed))

    elapsed("phase 10")
    # ---- 10. the single-device engines: vmap and packed on the same
    # RMAT-20 files (K9), dense on phase 4's RMAT-14, push and ppush on
    # road-1024 (K10, K11, K3) with phase 6's groups
    gpath1, qpath1 = os.path.join(tmp, "road1024.bin"), os.path.join(tmp, "q1.bin")
    q1 = generators.random_queries(n1, 16, seed=seed + 3)
    tio.save_graph_bin(gpath1, n1, e1)
    tio.save_query_bin(qpath1, q1)
    files = {
        "rmat20": (info20["gpath"], info20["qpath"], info20["queries"], info20["scipy"],
                   info20["scipy_stats"]),
        "rmat14": (os.path.join(tmp, "rmat-14.bin"), os.path.join(tmp, "rmat-14-q.bin"),
                   generators.random_queries(nr, 64, seed=seed + 8)),
        "road1024": (gpath1, qpath1, q1),
    }
    t0 = time.perf_counter()
    main_shape.update(_single_device_phase(
        (torch, np, sp, cg, cli, tio, timing, launches, dev, g20, gr, g1), files, seed))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    del files
    torch.cuda.empty_cache()

    elapsed("phase 11")
    # ---- 11. the weighted route: RMAT-20 (phase 5b's groups, K = 64),
    # road-512 (every flavor), road-128 (the audit and verify)
    rows11, road5 = _weighted_phase(
        (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
        n20, e20, info20["queries"], n5, e5, seed)
    main_shape.update(rows11)
    torch.cuda.empty_cache()

    elapsed("phase 12")
    # ---- 12. the serving daemon: RMAT-20 from four concurrent clients,
    # sequential latency, a weighted query, mutations and repair on
    # road-512, a reload, a restart from the journal
    road5.update(n=n5, edges=e5)
    _serving_phase((torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
                   info20, road5, seed)
    os.remove(road5["gpath"])
    del bg20, g20, e20
    torch.cuda.empty_cache()

    elapsed("phase 6")
    # ---- 6. road-1024, K = 16 (phase 10's files): every F against scipy
    k1, f1, pre1, comp1 = _run_cli(
        cli, ["chip_smoke", "-g", gpath1, "-q", qpath1, "-gn", "1"]
    )
    eng1 = stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    lv1, _, fv1 = eng1.query_stats(tio.pad_queries(q1))
    a1 = _scipy_matrix(sp, np, g1)
    want1 = np.array(_scipy_map(_scipy_f, a1, list(q1)))
    assert np.array_equal(fv1, want1), (fv1, want1)
    assert (k1, f1) == (int(np.argmin(want1)), int(want1.min()))
    print("road-1024 K=16: " + json.dumps(dict(
        winner=k1 + 1, min_f=f1, all_f_equal_scipy=True, levels=int(lv1.max()),
        preprocessing_s=pre1, computation_s=comp1,
    )))

    elapsed("phase 7")
    # ---- 7. road-1024, K = 300: the sub-batch split
    q300 = tio.pad_queries(generators.random_queries(n1, 300, max_group=8, seed=seed + 4))
    sub_fast = packed.SubBatchEngine(
        stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK))
    sub_plain = packed.SubBatchEngine(stencil.StencilEngine(
        sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK, plain=True))
    timing.reset_launch_counts()
    t0 = time.perf_counter()
    best300 = sub_fast.best(q300)
    sub_s = time.perf_counter() - t0
    print(f"road-1024 K=300 variants: {json.dumps(timing.variant_counts())}")
    f300 = sub_fast.f_values(q300).cpu().numpy()
    assert np.array_equal(f300, sub_plain.f_values(q300).cpu().numpy())
    assert best300 == (int(f300.min()), int(np.argmin(f300)))
    print(f"road-1024 K=300: best={best300} kernel-path best {sub_s:.3f} s, "
          "F equals plain path")

    elapsed("phase 8")
    # ---- 8. the active-row window on a residual-free grid
    ng, eg = generators.grid_edges(2048, 2048)
    sgg = stencil.StencilGraph.from_host(CSRGraph.from_edges(ng, eg), dev)
    rng = np.random.default_rng(seed + 5)
    qg = tio.pad_queries(
        [rng.integers(0, 32 * 2048, size=4).astype(np.int32) for _ in range(8)]
    )
    win = stencil.StencilEngine(sgg, level_chunk=64, megachunk=1, window=True)
    ref = stencil.StencilEngine(sgg, level_chunk=64, megachunk=1, window=False,
                                plain=True)
    timing.reset_plane_pass()
    timing.reset_launch_counts()
    t0 = time.perf_counter()
    got = win.query_stats(qg)
    win_s = time.perf_counter() - t0
    print(f"grid-2048 window variants: {json.dumps(timing.variant_counts())}")
    win_bytes = timing.plane_pass_bytes()
    want = ref.query_stats(qg)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    narrow = sum(1 for *_, rows in win.last_window_trace if rows < ng)
    assert narrow > 0, win.last_window_trace[:4]
    print(f"grid-2048 window: {narrow} of {len(win.last_window_trace)} chunks "
          f"on fewer than n rows, {win_s:.3f} s, plane-pass bytes {win_bytes}, "
          "equal to the plain full-plane path")
    del win, ref, sgg, sub_fast, sub_plain, eng1, sg1
    torch.cuda.empty_cache()

    elapsed("phase 13")
    # ---- 13. the replicated fleet: three daemons in this process behind
    # the router (RMAT-20, road-1024, the vote and failover), then the
    # fleet subcommand with RMAT-20 sharded, and a replica_kill
    _fleet_phase((torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
                 info20, dict(gpath=gpath1, queries=q1, f=want1), rmat16, seed)

    # ---- 14. the port's tooling: gen_cli, the DIMACS/SNAP converters,
    # MSBFS_PROFILE_DIR, analyze
    elapsed("phase 14")
    _tooling_phase((torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
                   seed, road=(n1, e1, want1), rmat20_gpath=info20["gpath"])

    # ---- 15. the -gn > 1 routes over a logical mesh on the card: phase
    # 5b's RMAT-20 files and phase 6's road-1024 files
    elapsed("phase 15")
    rmat15 = {key: info20[key] for key in ("gpath", "qpath", "queries", "fv", "want")}
    road15 = dict(gpath=gpath1, qpath=qpath1, queries=q1, fv=fv1, want={
        q: int(want1[q]) for q in sorted({int(np.argmin(want1)), *range(MESH_SCIPY_GROUPS)})})
    main_shape.update(_mesh_phase(
        (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
        rmat15, road15, seed))

    # ---- 16. the 2D adjacency mesh (MSBFS_MESH=2x2) over the same logical
    # mesh: phase 15's RMAT-20 and road-1024 files, phase 5a's RMAT-16 and
    # phase 4's RMAT-14 files, their F vectors equal to scipy's there
    elapsed("phase 16")
    rmat16m = dict(gpath=rmat16["gpath"], qpath=rmat16["qpath"],
                   queries=[np.array([rmat16["source"]], dtype=np.int32)],
                   fv=np.array([rmat16["want"]]), want={0: rmat16["want"]},
                   single_s=rmat16["single_s"])
    rmat14m = dict(MXU_RUNS["mxu rmat-14"])
    rmat14m["want"] = {q: int(rmat14m["fv"][q]) for q in sorted(
        {int(np.argmin(rmat14m["fv"])), *range(MESH_SCIPY_GROUPS)})}
    main_shape.update(_mesh2d_phase(
        (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev),
        rmat15, road15, rmat16m, rmat14m, seed))
    os.remove(info20["gpath"])
    del info20
    tmpdir.cleanup()
    total = {name: sum(c.get(name, 0) for c in launches.values())
             for name in kernels.KERNELS}
    for name, count in total.items():
        assert count > 0, f"{name} launched on no path"

    # ---- the kernel line, the card, the verdict
    replaces = {
        "stencil_sweep": "ops/pallas_stencil.py:75",
        "level_apply": "ops/bitbell.py:333",
        "tile_hits": "ops/pallas_mxu.py:48",
        "push_or": "ops/bitbell.py:225",
        "forest_or": "ops/bell.py:75",
        "ell_hits": "ops/pallas_bfs.py:44",
        "batch_start": "ops/bitbell.py:93, {JAX_PKG}/ops/lowk.py:66, "
                       "{JAX_PKG}/ops/bitbell.py:311",
        "flag_pull": "ops/bell.py:144, {JAX_PKG}/ops/lowk.py:126",
        "flag_pull:push": "ops/lowk.py:87",
        "forest_map": "ops/streamed.py:117",
        "forest_segment": "ops/streamed.py:117, {JAX_PKG}/ops/streamed.py:139",
        "forest_gather": "ops/streamed.py:146",
        "csr_pull": "ops/bfs.py:65, {JAX_PKG}/ops/packed.py:111",
        "queue_expand": "ops/push.py:185",
        "queue_compact": "ops/push.py:57, {JAX_PKG}/ops/push.py:83, "
                         "{JAX_PKG}/ops/push_packed.py:110",
        "weighted_relax": "weighted/deltastep.py:84",
        "halo_pair_or": "parallel/sharded_bell.py:444, {JAX_PKG}/parallel/push_sharded.py:176",
        "halo_push_match": "parallel/sharded_bell.py:459",
        "halo_push_or": "parallel/sharded_bell.py:350",
        "owner_push_expand": "parallel/push_sharded.py:131",
        "chunk_merge": "parallel/partition2d.py:571, {JAX_PKG}/parallel/partition2d.py:558",
        "wire_encode": "parallel/partition2d.py:291, {JAX_PKG}/parallel/partition2d.py:305",
        "forest_max": "parallel/partition2d.py:1116, {JAX_PKG}/ops/streamed.py:117",
        "forest_max_commit": "parallel/partition2d.py:1298, {JAX_PKG}/ops/bitbell.py:200, "
                             "{JAX_PKG}/ops/bitbell.py:190",
    }
    # K5's push: the flag_pull launches with the push folded in, on the
    # byte paths.
    total["flag_pull:push"] = sum(v for p in BYTE_PATHS for k_, v in VARIANTS[p].items()
                                  if k_.startswith("flag_pull:") and k_.endswith("/push"))
    assert total["flag_pull:push"] > 0, "no path launched K5's push"
    rows = []
    for name in (*kernels.KERNELS, "flag_pull:push"):
        row = main_shape[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"{PKG}/csrc/{kernels.source(name.split(':')[0])}.cu",
            replaces=f"{JAX_PKG}/{replaces[name].format(JAX_PKG=JAX_PKG)}",
            launches=total[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"),
        ))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
