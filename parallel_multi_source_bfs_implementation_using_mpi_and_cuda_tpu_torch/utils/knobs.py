"""``MSBFS_*`` environment knobs the port reads, declared once.

Same names, defaults and parse convention as the JAX package's registry:
a malformed value falls back to the call site's default, the empty string
means unset, and reading an undeclared name raises.  The CLI reads the
knobs of routes that are not yet ported only to refuse them loudly.
The table in README.md's port section lists these knobs; the analyzer's
knobs pass (analysis/knobs_pass.py) holds the two against each other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Knob:
    """One registered environment knob."""

    name: str
    default: Optional[str]  # documented default as the env string; None = unset
    kind: str  # int / float / flag / str / path / spec
    doc: str


_ALL = (
    Knob("MSBFS_BACKEND", "auto", "str", "engine selection: auto, stencil, mxu, pallas, bell, lowk, streamed, vmap, packed, dense, push, ppush and bitbell (any other name runs bitbell, as in JAX)"),
    Knob("MSBFS_EDGE_CHUNKS", "1", "int", "packed route: edge-axis slices of the plain pull's (E, K) gather (the CSR pull kernel makes no such intermediate)"),
    Knob("MSBFS_PUSH_CHUNK", "64", "int", "push and ppush routes: BFS levels between host reads"),
    Knob("MSBFS_MXU_TILE", "128", "int", "mxu adjacency tile side (multiple of 8; the CUDA tile kernel takes 32, 64, 96 or 128)"),
    Knob("MSBFS_MXU_MAX_TILES", "32768", "int", "mxu densification ceiling in nonzero tiles"),
    Knob("MSBFS_MXU_SWITCH", None, "int", "mxu per-level direction switch threshold in active rows; 0 never pushes, unset = auto n/64"),
    Knob("MSBFS_MXU_KERNEL", None, "flag", "1 runs the mxu tile products in the CUDA tile kernel (no fallback); unset = batched bf16 torch.bmm"),
    Knob("MSBFS_STENCIL", None, "flag", "0 disables the banded-adjacency auto route"),
    Knob("MSBFS_SLOT_BUDGET", None, "int", "bitbell forest gather-segment budget in slots; 0 never segments, unset = auto"),
    Knob("MSBFS_HBM_BYTES", None, "int", "device memory budget for routing; unset = the card's total memory (16 GiB off the card)"),
    Knob("MSBFS_LOWK", None, "flag", "0 disables the low-K auto route"),
    Knob("MSBFS_LOWK_MAX_K", "4", "int", "largest K the low-K auto route takes"),
    Knob("MSBFS_LEVEL_CHUNK", None, "int", "BFS levels between host syncs; 0 disables the bound, unset = auto"),
    Knob("MSBFS_MEGACHUNK", None, "int", "level chunks fused per host sync; unset = auto factor 8"),
    Knob("MSBFS_STENCIL_WINDOW", None, "flag", "0 disables the stencil active-row window"),
    Knob("MSBFS_SUBBATCH_K", "256", "int", "K above which a batch splits into ordered sub-batches; 0 disables"),
    Knob("MSBFS_RETRIES", "2", "int", "supervisor transient-retry budget per call"),
    Knob("MSBFS_BACKOFF", "0.1", "float", "supervisor base backoff delay in seconds"),
    Knob("MSBFS_WATCHDOG", "0", "float", "wall-clock deadline per supervised call in seconds; 0/unset = off"),
    Knob("MSBFS_FAULT_SEED", "0", "int", "backoff-jitter RNG stream"),
    Knob("MSBFS_NATIVE_THREADS", None, "int", "exact thread count of every native loader pass (runtime/loader.cpp); unset = the hardware's, fewer on small inputs"),
    Knob("MSBFS_NATIVE_RMAT", None, "flag", "1 samples R-MAT edges in the native runtime (splitmix64 streams: another graph than the NumPy stream's for one seed, JAX's native one)"),
    Knob("MSBFS_STREAM_PREFETCH", "2", "int", "host-streamed engine: forest-segment upload lookahead (device buffers in the ring)"),
    Knob("MSBFS_FAULTS", None, "spec", "deterministic fault-injection plan: kind:site:n[,...]"),
    Knob("MSBFS_FAULT_HANG", "60", "float", "injected-hang stall seconds"),
    Knob("MSBFS_FAULT_SLOW", "0.25", "float", "replica_slow stall seconds"),
    Knob("MSBFS_CHECKPOINT", None, "path", "resumable journal path for chunk-wise execution"),
    Knob("MSBFS_CHECKPOINT_CHUNK", "64", "int", "queries per checkpointed chunk"),
    Knob("MSBFS_STATS", None, "str", "1 = per-query stats table, 2 = + per-level trace"),
    Knob("MSBFS_FLIGHT_RECORDER", None, "path", "append the flight ring as JSONL here on typed exits"),
    Knob("MSBFS_AUDIT", "off", "spec", "output certification: off / full / a sampled rate in (0, 1)"),
    Knob("MSBFS_WEIGHTED", None, "flag", "1 routes the CLI batch run through the weighted delta-stepping engines (graph must carry a cost section)"),
    Knob("MSBFS_WEIGHTED_ENGINE", "auto", "str", "weighted engine flavor: auto/bitbell/stencil/mesh2d (capability-token negotiated; impossible asks fail loud)"),
    Knob("MSBFS_DELTA", "0", "int", "delta-stepping bucket width; 0/unset auto-derives from the mean edge cost"),
    # The serving daemon (serve/) and the dynamic graphs (dynamic/).
    Knob("MSBFS_SERVE_LISTEN", "unix:/tmp/msbfs.sock", "spec", "serving daemon listen address"),
    Knob("MSBFS_SERVE_QUEUE", "64", "int", "admission queue capacity (full -> typed exit-7 rejection)"),
    Knob("MSBFS_SERVE_WINDOW", "0.002", "float", "micro-batching coalescing window in seconds"),
    Knob("MSBFS_SERVE_MAX_ROWS", "1024", "int", "max query rows per dispatched batch"),
    Knob("MSBFS_SERVE_RESULT_CACHE", "1024", "int", "result-cache LRU entries; 0 disables"),
    Knob("MSBFS_SERVE_TIMEOUT", "300", "float", "per-request deadline in seconds"),
    Knob("MSBFS_SERVE_MAX_FRAME", "67108864", "int", "wire-frame byte bound"),
    Knob("MSBFS_SERVE_JOURNAL", None, "path", "crash-recovery state journal path"),
    Knob("MSBFS_SERVE_DRAIN", "10", "float", "SIGTERM graceful-drain deadline in seconds"),
    Knob("MSBFS_SERVE_CLIENT_RATE", "0", "float", "per-client admission tokens per second; 0 disables"),
    Knob("MSBFS_SERVE_CLIENT_BURST", None, "float", "per-client token-bucket burst; unset = max(8, 2*rate)"),
    Knob("MSBFS_SERVE_BATCH_ADMIT", "0.75", "float", "batch-class admission headroom fraction of queue capacity"),
    Knob("MSBFS_SERVE_CODEL_TARGET_MS", "0", "float", "CoDel sojourn target in ms; 0 disables"),
    Knob("MSBFS_SERVE_CODEL_INTERVAL_MS", "100", "float", "CoDel control interval in ms"),
    Knob("MSBFS_SERVE_PLANES", "auto", "str", "retain distance planes as repair seeds: auto/1/0"),
    Knob("MSBFS_SERVE_PLANE_CACHE_BYTES", "268435456", "int", "plane-cache byte cap"),
    Knob("MSBFS_JOURNAL_MAX_BYTES", "1048576", "int", "journal auto-compaction threshold in bytes"),
    Knob("MSBFS_MXU_CACHE_BYTES", "268435456", "int", "registry mxu tile-index cache byte cap (LRU); <= 0 disables"),
    Knob("MSBFS_WIRE_CRC", "on", "str", "protocol frame crc32: on / legacy (send pre-crc frames)"),
    Knob("MSBFS_NET_CONNECT_TIMEOUT_S", "5", "float", "socket connect deadline in seconds when the caller gave none; 0 = blocking"),
    Knob("MSBFS_NET_READ_TIMEOUT_S", "0", "float", "per-read socket timeout after connect; 0 = inherit the request timeout"),
    Knob("MSBFS_NET_KEEPALIVE", "1", "flag", "0 disables SO_KEEPALIVE on TCP legs"),
    Knob("MSBFS_MUTATE_DEDUP_WINDOW", "1024", "int", "exactly-once mutate: applied idempotency tokens remembered per daemon"),
    Knob("MSBFS_REPAIR_MAX_FRAC", "0.5", "float", "repair-cone fraction above which repair falls back to full recompute"),
    Knob("MSBFS_TRACE", None, "flag", "1 mints a per-query distributed trace at the client edge"),
    Knob("MSBFS_LOG_FORMAT", None, "str", "json switches daemon stderr to structured logs"),
    Knob("MSBFS_PROFILE_DIR", None, "path", "write a torch.profiler Chrome trace of the CLI's computation span into this directory (CPU activity, and the card's kernels on a CUDA device)"),
    Knob("MSBFS_LOCK_WATCHDOG", None, "flag", "1 arms the lock-order watchdog (analysis/lockwatch.py) where a test installs it"),
    # The replicated fleet (serve/fleet.py, serve/router.py).
    Knob("MSBFS_FLEET_LISTEN", None, "spec", "fleet front-end listen address (unset: unix:$TMPDIR/msbfs-fleet.sock)"),
    Knob("MSBFS_FLEET_DIR", None, "path", "fleet replica sockets/journals/logs directory (unset: $TMPDIR/msbfs-fleet)"),
    Knob("MSBFS_FLEET_BACKOFF", "0.2", "float", "replica restart base backoff in seconds"),
    Knob("MSBFS_VOTE", "off", "spec", "cross-replica vote: off / on / sample rate in (0,1)"),
    Knob("MSBFS_SHARD_MAX_BYTES", "0", "int", "shard graphs whose artifact exceeds this many bytes across the fleet; 0 serves every graph whole"),
    Knob("MSBFS_SHARD_REPLICAS", "2", "int", "copies per shard on the shard placement ring"),
    Knob("MSBFS_SHARD_FRAGMENT_TIMEOUT_S", "30", "float", "per-attempt wire deadline for one scatter fragment"),
    Knob("MSBFS_SHARD_HEDGE_MS", "0", "float", "race a shard fragment's second copy after this many ms; 0 disables hedging"),
    # The -gn > 1 routes (parallel/).
    Knob("MSBFS_VSHARD", None, "int", "with -gn > 1: vertex-shard the graph over a 'v' mesh axis of this size (the rest shard queries); unset = automatic when the graph's estimated footprint exceeds one device's memory"),
    Knob("MSBFS_HALO_BUDGET", None, "int", "vertex-sharded forest: compacted-halo threshold in own-frontier rows per shard; unset or 0 exchanges whole planes every level"),
    Knob("MSBFS_PUSH_HALO", None, "int", "vertex-sharded forest: in-block push edge budget inside the sparse halo (needs MSBFS_HALO_BUDGET; a lone value warns); unset or 0 disables"),
    # The 2D adjacency mesh (parallel/partition2d.py), at -gn > 1.
    Knob("MSBFS_MESH", None, "spec", "RxC selects the 2D adjacency partition at -gn > 1 (R*C must equal the devices -gn selected)"),
    Knob("MSBFS_MERGE_TREE", None, "str", "2D engine col-axis reduction tree: auto/ring/halving/oneshot/pipelined"),
    Knob("MSBFS_WIRE_SPARSE", None, "spec", "2D engine sparse wire budget in (index, word) pairs: auto/unset = Lsub*W/8, 0/off = always dense, int = exact budget"),
    Knob("MSBFS_WIRE_CHUNKS", "4", "int", "2D engine pipelined merge tree: word-plane stripes a level, run one after another"),
    Knob("MSBFS_MESH_RESIDENCY", "hbm", "str", "2D engine tile-forest residency: hbm (on the device) / streamed (host memory, uploaded every level through the MSBFS_STREAM_PREFETCH ring)"),
    Knob("MSBFS_MESH_PLANE", "bit", "str", "2D engine plane layout: bit (packed words) / byte (low-K byte lanes, K bytes a row on the wire)"),
    Knob("MSBFS_MESH_KERNEL", "xla", "str", "2D engine expansion kernel: xla (the BELL forest pull) / mxu (the tile-matmul kernel with a mesh-uniform direction switch)"),
    Knob("MSBFS_ASYNC_LEVELS", "1", "int", "2D engine bounded-staleness drive: local relax steps a collective round; 1 = level-synchronous"),
    # Routes and modes of the JAX CLI that the port refuses by name.
    Knob("MSBFS_CACHE_DIR", None, "path", "the JAX package's persistent XLA compile cache; the port builds its kernels into the package's build/ and refuses the knob (fails)"),
    Knob("MSBFS_COORDINATOR", None, "spec", "multi-host bring-up: coordinator addr:port (not yet ported: fails)"),
    Knob("MSBFS_NUM_PROCESSES", "1", "int", "multi-host bring-up: world size (not yet ported: fails)"),
    Knob("MSBFS_PROCESS_ID", "0", "int", "multi-host bring-up: this process's rank (not yet ported: fails)"),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}


def _check(name: str) -> None:
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}: declare it in utils/knobs.py")


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's raw env string, or ``default`` when unset."""
    _check(name)
    return os.environ.get(name, default)


def get_int(name: str, default: int) -> int:
    """Integer knob: unset, empty or malformed values give ``default``."""
    _check(name)
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    """Float knob, same malformed-falls-back convention."""
    _check(name)
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    try:
        return float(val)
    except ValueError:
        return default


def unported_cache_dir() -> Optional[str]:
    """What to name in the refusal when ``MSBFS_CACHE_DIR`` is set, else
    None.  The knob names the JAX package's persistent XLA compile cache;
    the port builds its kernels into the package's ``build/`` whatever it
    says, so the batch CLI and the daemon both refuse it."""
    if raw("MSBFS_CACHE_DIR", ""):
        return (
            "MSBFS_CACHE_DIR (the persistent XLA compile cache; the port "
            "builds its kernels into the package's build/)"
        )
    return None
