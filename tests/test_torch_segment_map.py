"""K1's segment form with the frontier map (ops/cuda_bell.py
``frontier_map``, ``segment_plan``, ``forest_segment``; csrc/forest_or.cu)
on the CPU: the map's plain version against NumPy, the instance plan,
and a torch emulation of the level-0 walk with the map — a slot whose
source bit is 0 reads the zero row, a 32-slot chunk with no source row
to read skips its fold and writes zero rows — equal to the plain
``segment_fold`` and to the JAX package's ``_segment_or`` on the same
seeded segments.  Everything is bits and integers: every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    streamed as jstreamed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bitbell,
    cuda_bell,
    streamed,
)

PULL = torch.tensor([1, 3, 0, bitbell.DIR_PULL], dtype=torch.int32)


def _frontier(rng, n, w, kind):
    """(n, w) int32 words: no nonzero row, about 1 % of rows, about 60 %,
    every row, or about 30 % of rows nonzero in one word only."""
    x = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    x[x == 0] = 1  # a kept row is nonzero in every word
    if kind == "empty":
        x[:] = 0
    elif kind == "thin":
        x[rng.random(n) >= 0.01] = 0
    elif kind == "dense":
        x[rng.random(n) >= 0.6] = 0
    elif kind == "one_word":
        keep = rng.random(n) < 0.3
        word = rng.integers(0, w, n)
        x[np.arange(w)[None, :] != word[:, None]] = 0
        x[~keep] = 0
    return x.view(np.int32)


def _numpy_map(frontier, weights, shift):
    """The map in NumPy: bit b of word b // 32 (little-endian bit order)
    set iff a row v with v >> shift == b is nonzero; the nonzero rows and
    their weights' sum."""
    on = (frontier != 0).any(axis=1)
    words = cuda_bell.map_words(-(-frontier.shape[0] >> shift))
    padded = np.zeros(32 * words << shift, dtype=bool)
    padded[: on.size] = on
    coarse = padded.reshape(-1, 1 << shift).any(axis=1)
    bits = np.packbits(coarse, bitorder="little").view(np.uint32).view(np.int32)
    return bits, int(on.sum()), int(weights[on].astype(np.int64).sum())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 128, 129, 1000])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["empty", "thin", "dense", "all", "one_word"])
@pytest.mark.parametrize("shift", [0, 1])
def test_frontier_map_plain_matches_numpy(n, w, kind, shift):
    """The map's plain version (via the wrapper on CPU tensors): one bit
    per vertex or per two, the bits past n zero, the nonzero rows and
    their weights' sum (random weights, and each row weighing 1); the
    running sums stay zero; gated off, nothing changes."""
    rng = np.random.default_rng(n * 10 + w)
    frontier = _frontier(rng, n, w, kind)
    for weights in (rng.integers(0, 300, n).astype(np.int32), np.ones(n, np.int32)):
        want, rows, slots = _numpy_map(frontier, weights, shift)
        fmap = cuda_bell.frontier_map_scratch(n, "cpu", torch.from_numpy(weights), shift)
        assert fmap.total == int(weights.sum())
        cuda_bell.frontier_map(torch.from_numpy(frontier), fmap, PULL)
        np.testing.assert_array_equal(fmap.bits.numpy(), want)
        assert fmap.bits.shape[0] % 4 == 0 and 32 * fmap.bits.shape[0] << shift >= n
        assert fmap.counts.tolist() == [0, 0, 0, rows, slots]
    for ctrl in ([1, 3, 0, bitbell.DIR_PUSH], [0, 3, 0, bitbell.DIR_PULL], [1, 3, 0, 0]):
        gate = torch.tensor(ctrl, dtype=torch.int32)
        stale = cuda_bell.frontier_map_scratch(n, "cpu", torch.ones(n, dtype=torch.int32), shift)
        stale.bits.fill_(5)
        cuda_bell.frontier_map(torch.from_numpy(frontier), stale, gate, max_levels=3)
        assert bool((stale.bits == 5).all()) and stale.counts.tolist() == [0] * 5


# Vertices two map blocks an SM hold at a bit a vertex, and at a bit per
# two: (228 KB / 2 - the bucket table - the runtime's 1 KB) * 8.
FINE = (cuda_bell.SM_SMEM_BYTES // 2 - cuda_bell.TABLE_BYTES - 1024) * 8
CAP = 2 * FINE


@pytest.mark.parametrize(
    "n,level,want,shift",
    [(3000, 0, "map", 0), (FINE, 0, "map", 0), (FINE + 1, 0, "map", 1),
     (2**20, 0, "map", 1), (CAP, 0, "map", 1), (CAP + 1, 0, "gmap", None),
     (2**23, 0, "gmap", None), (2**25, 0, "gmap", None), (2**20, 1, "nomap", 1),
     (2**23, 2, "nomap", None), (0, 0, "map", 0)],
)
@pytest.mark.parametrize("w,vec16", [(1, True), (2, True), (2, False), (3, True), (8, True)])
def test_segment_plan_by_n_level_and_alignment(n, level, want, shift, w, vec16):
    """Level 0 reads the map, in shared memory while two blocks of it fit
    an SM (a bit a vertex up to FINE vertices, a bit per two up to CAP)
    and from device memory above; later levels read every slot; the
    forest plan (width instance, vector access, chunks) is K1's; the plan
    is a pure function of its arguments and a forced instance wins."""
    assert (FINE, CAP) == (901_120, 1_802_240)
    assert cuda_bell.map_shift(n) == shift
    plan = cuda_bell.segment_plan(w, vec16, level, n)
    assert plan.instance == want
    assert plan.forest == cuda_bell.forest_plan(w, vec16)
    assert plan.label == f"{cuda_bell.forest_plan(w, vec16).label}/{want}"
    assert plan == cuda_bell.segment_plan(w, vec16, level, n)
    for forced in ("map", "gmap", "nomap"):
        assert cuda_bell.segment_plan(w, vec16, level, n, forced).instance == forced
    with pytest.raises(ValueError, match="unknown segment instance"):
        cuda_bell.segment_plan(w, vec16, level, n, "bitmap")
    if want == "map":
        block = cuda_bell.TABLE_BYTES + 4 * cuda_bell.map_words(-(-n >> shift)) + 1024
        assert 2 * block <= cuda_bell.SM_SMEM_BYTES


def _skip_emulation(v_prev, cols, pieces, bits, n, shift):
    """The map instance's level-0 walk in torch: a slot whose source's map
    bit (source >> shift) is 0 reads the zero row; a narrow piece's 32-slot
    chunks (32 // width rows each, from the piece's first row) in which no
    slot reads a row skip the fold and write zero rows; a wide row's warp
    ORs only the mapped slots.  Returns the rows and the slots read."""
    c = cols.long()
    real = c < n
    b = torch.where(real, c, torch.zeros_like(c)) >> shift
    bit = (bits.long()[b >> 5] >> (b & 31)) & 1
    mapped = real & (bit == 1)
    src = torch.where(mapped, c, torch.full_like(c, n))
    parts, off = [], 0
    for rc, wb in pieces:
        g = v_prev[src[off : off + rc * wb]].view(rc, wb, -1)
        rows = bell._or_rows(g.reshape(rc * wb, -1), rc, wb)
        if wb <= cuda_bell.NARROW_WIDTH:
            rpc = cuda_bell.NARROW_WIDTH // wb
            read = mapped[off : off + rc * wb].view(rc, wb).any(dim=1)
            chunk = torch.arange(rc) // rpc
            gathered = torch.zeros(int(chunk.max()) + 1 if rc else 0, dtype=torch.bool)
            gathered.index_put_((chunk,), read, accumulate=True)
            rows = torch.where(gathered[chunk][:, None], rows, torch.zeros_like(rows))
        parts.append(rows)
        off += rc * wb
    return torch.cat(parts), int(mapped.sum())


def _graph(n):
    """RMAT-9 edges, a 700-neighbour hub (wide rows and a second forest
    level) and isolated vertices up to ``n``."""
    _, edges = generators.rmat_edges(9, edge_factor=8, seed=n)
    hub = np.stack([np.full(700, 5, np.int32), np.arange(700, dtype=np.int32) % n], 1)
    return CSRGraph.from_edges(n, np.concatenate([edges, hub]))


@pytest.mark.parametrize("n", [1000, 1001])
@pytest.mark.parametrize("kind", ["empty", "thin", "dense", "all", "one_word"])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("slot_budget", [None, 700])
@pytest.mark.parametrize("shift", [0, 1])
def test_map_skip_equals_segment_fold_and_jax(n, kind, w, slot_budget, shift):
    """On every level-0 segment of the streamed schedule (whole level and
    700-slot cuts), the emulated map walk (a bit a vertex, or per two)
    equals the plain segment fold and JAX's ``_segment_or`` on the same
    frontier; at a bit a vertex it reads no row of a source outside the
    frontier, at a bit per two none outside the frontier's pairs (on the
    empty frontier none); the engine's pass with its map (the wrapper on
    CPU tensors) equals the in-memory forest."""
    host = BellGraph.from_host(_graph(n), False)
    eng = streamed.StreamedBitBellEngine(host, "cpu", slot_budget=slot_budget)
    frontier = torch.from_numpy(_frontier(np.random.default_rng(n + w), n, w, kind))
    fmap = cuda_bell.frontier_map_scratch(n, "cpu", eng._map.weights, shift)
    cuda_bell.frontier_map(frontier, fmap, PULL)
    v_prev = torch.cat([frontier, frontier.new_zeros((1, w))])
    nonzero = set(torch.nonzero((frontier != 0).any(dim=1)).flatten().tolist())
    pairs = {v >> shift for v in nonzero}
    level0 = [i for i, seg in enumerate(eng._segments) if seg.level == 0]
    assert len(level0) >= (1 if slot_budget is None else 2)
    for i in level0:
        cols = eng._slices[i]
        pieces = eng._tables.pieces[i]
        want = bell.segment_fold(v_prev, cols, pieces)
        got, read = _skip_emulation(v_prev, cols, pieces, fmap.bits, n, shift)
        assert torch.equal(got, want)
        theirs = jstreamed._segment_or(
            jnp.asarray(v_prev.numpy().view(np.uint32)), jnp.asarray(cols.numpy()), pieces)
        np.testing.assert_array_equal(np.asarray(theirs).view(np.int32), want.numpy())
        assert read == sum(1 for c in cols.tolist() if c < n and c >> shift in pairs)
        if kind == "empty":
            assert read == 0 and not bool(got.any())
    hits = torch.empty_like(frontier)
    eng.forest_pass(frontier, hits, PULL)
    assert torch.equal(hits, bell.forest_hits(frontier, BellGraph.from_host(_graph(n), "cpu")))
    if shift == cuda_bell.map_shift(n):
        assert torch.equal(eng._map.bits, fmap.bits)


def _reads_per_slot(entries, runs, chunks, slots):
    """How often the level kernel's runs (decoded as csrc/forest_or.cu
    decodes them: bucket search, ``chunks`` 32-lane chunks of whole rows
    for a narrow bucket, a warp a wide row) read each slot."""
    seen = np.zeros(slots, dtype=np.int64)
    tab = np.asarray(entries, dtype=np.int64)
    for run in range(runs):
        off, rows, width, _, first, rpc = tab[np.searchsorted(tab[:, 4], run, side="right") - 1]
        local = run - first
        if not rpc:
            seen[off + local * width : off + (local + 1) * width] += 1
            continue
        for s in range(chunks):
            first_row = local * chunks * rpc + s * rpc
            for lane in range(32):
                if lane // width < rpc and first_row + lane // width < rows:
                    seen[off + first_row * width + lane] += 1
    return seen


@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("slot_budget", [None, 700])
def test_map_instance_runs_cover_every_slot_once(w, slot_budget):
    """Every instance runs K1's run length (four chunks at up to four
    words a row, two at eight and the generic width), and each segment's
    table drives the kernel over every slot exactly once."""
    host = BellGraph.from_host(_graph(1000), False)
    eng = streamed.StreamedBitBellEngine(host, "cpu", slot_budget=slot_budget)
    chunks = {cuda_bell.segment_plan(w, True, 0, 1000, inst).forest.chunks
              for inst in ("map", "gmap", "nomap")}
    assert chunks == ({4} if w <= 2 else {2})
    for i, seg in enumerate(eng._segments):
        for c in chunks:
            entries, runs = cuda_bell.segment_table(eng._tables.pieces[i], c)
            assert (_reads_per_slot(entries, runs, c, seg.slots) == 1).all(), (i, c)
