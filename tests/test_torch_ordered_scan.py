"""The ordered compaction that H3 ``owner_push_expand`` and M2
``wire_encode`` share (``csrc/ordered_scan.cuh``), on the CPU.

The kernels run only on the card; here their host-side sizing helpers are
checked against the sources' constants, and a step-by-step emulation of
the decoupled look-back (tickets, epoch-tagged status words, the warp's
window and its wait mask, the finalizer and the ticket's reset), run
under random interleavings of the blocks over a scratch full of an
earlier launch's words, places every tile where the plain compaction puts
it.  The kernels' tile layouts (H3: consecutive slots a thread; M2:
consecutive words a thread) then place each entry, and the result is held
against the plain versions, which the JAX package's tests hold against
JAX.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    cuda_halo,
    cuda_mesh,
)

CSRC = Path(cuda_halo.__file__).resolve().parents[1] / "csrc"
AGGREGATE, PREFIX = 1, 2
EPOCH_SHIFT = 34


def _constant(text, name):
    return int(re.search(rf"constexpr [\w ]+ {name} = ([^;]+);", text).group(1)
               .replace("1u << 30", str(1 << 30)).replace("1 << 30", str(1 << 30)))


def test_sizes_match_the_sources():
    halo = (CSRC / "halo_exchange.cu").read_text()
    wire = (CSRC / "mesh_wire.cu").read_text()
    scan = (CSRC / "ordered_scan.cuh").read_text()
    assert ITEMS == _constant(halo, "kExpandItems")
    assert cuda_halo.EXPAND_TILE == (_constant(halo, "kExpandThreads")
                                     * _constant(halo, "kExpandItems"))
    assert cuda_mesh.ENCODE_TILE == (_constant(wire, "kEncodeThreads")
                                     * _constant(wire, "kEncodeWords"))
    assert cuda_halo.SCAN_HEADER == _constant(scan, "kHeader")
    assert cuda_halo.SCAN_EPOCHS == _constant(scan, "kEpochs")


@pytest.mark.parametrize("capacity,width,total", [(0, 1, 1), (1, 7, 2048), (41651, 7, 2049),
                                                  (146780, 7, 262144), (5, 3, 2**20 + 3)])
def test_tile_counts(capacity, width, total):
    tiles = cuda_halo.expand_tiles(capacity, width)
    assert (tiles - 1) * cuda_halo.EXPAND_TILE < capacity * width <= tiles * cuda_halo.EXPAND_TILE \
        or capacity * width == tiles == 0
    t = cuda_mesh.encode_tiles(total)
    assert (t - 1) * cuda_mesh.ENCODE_TILE < total <= t * cuda_mesh.ENCODE_TILE
    s = cuda_halo.ScanScratch(max(tiles, t), "cpu")
    assert s.tiles == max(tiles, t, 1)
    assert s.words.numel() == cuda_halo.SCAN_HEADER + 2 * s.tiles
    assert int(s.words.abs().sum()) == 0


def test_scratch_epochs_and_checks():
    s = cuda_halo.ScanScratch(3, "cpu")
    assert [s.next_epoch() for _ in range(3)] == [1, 2, 3]
    s.words.fill_(7)
    s.epoch = cuda_halo.SCAN_EPOCHS - 2
    assert s.next_epoch() == cuda_halo.SCAN_EPOCHS - 1
    assert int(s.words[0]) == 7
    assert s.next_epoch() == 1  # wrapped: zeroed first
    assert int(s.words.abs().sum()) == 0
    cpu = torch.device("cpu")
    assert cuda_halo.scan_scratch(cpu, 3, s) is s
    with pytest.raises(ValueError):
        cuda_halo.scan_scratch(cpu, 4, s)


# ---- the protocol, step by step ---------------------------------------------


# Consecutive slots an H3 thread takes (csrc/halo_exchange.cu kExpandItems).
ITEMS = 2
# Tiles a lane reads a round of the look-back (csrc/ordered_scan.cuh).
PER = int(re.search(r"constexpr int kLookBackPer = (\d+);",
                    (CSRC / "ordered_scan.cuh").read_text()).group(1))


def _word(epoch, flag, value):
    return (epoch << EPOCH_SHIFT) | (flag << 32) | value


def _flag(s, epoch):
    return (s >> 32) & 3 if s >> EPOCH_SHIFT == epoch else 0


def _launch(counts, grid, scratch, epoch, rng, stale_reads=0.3, per=None):
    """One launch over tiles of ``counts`` by ``grid`` blocks, interleaved
    at random (a block starts late, a lane's read lands before another's
    write); returns each tile's first slot and the finalizer's total.
    ``scratch`` (a list of ints) is updated as the kernel updates it."""
    tiles, head = len(counts), cuda_halo.SCAN_HEADER
    status = head
    per = PER if per is None else per
    first, published = {}, {}

    def block():
        while True:
            t = scratch[0]
            scratch[0] += 1
            yield
            if t >= tiles:
                if tiles == 0 and t == 0:
                    published["total"] = 0
                if t == tiles + grid - 1:
                    scratch[0] = 0
                return
            c = counts[t]
            excl = 0
            if t == 0:
                scratch[status] = _word(epoch, PREFIX, c)
            else:
                scratch[status + t] = _word(epoch, AGGREGATE, c)
                yield
                end = t
                while True:
                    while True:  # one read of the window a spin
                        flags, values = [], []
                        for k in range(32 * per):  # lane k // per, its entry k % per
                            i = end - 1 - k
                            if i < 0:
                                flags.append(PREFIX)
                                values.append(0)
                                continue
                            if rng.random() < stale_reads:
                                yield
                            s = scratch[status + i]
                            flags.append(_flag(s, epoch))
                            values.append(s & 0xFFFFFFFF)
                        near, waiting = [per] * 32, [False] * 32
                        for lane in range(32):
                            for j in range(per):
                                f = flags[lane * per + j]
                                if near[lane] == per:
                                    if f == PREFIX:
                                        near[lane] = j
                                    elif f == 0:
                                        waiting[lane] = True
                        has = [lane for lane in range(32) if near[lane] < per]
                        nearest = has[0] if has else 32
                        if not any(waiting[lane] for lane in range(min(nearest + 1, 32))):
                            break
                        yield
                    excl += sum(values[lane * per + j] for lane in range(min(nearest + 1, 32))
                                for j in range(per) if j <= near[lane])
                    if nearest < 32:
                        break
                    end -= 32 * per
                scratch[status + t] = _word(epoch, PREFIX, excl + c)
            first[t] = excl
            if t == tiles - 1:
                published["total"] = excl + c
            yield

    waiting = [block() for _ in range(grid)]
    running = []
    while waiting or running:
        if waiting and (not running or rng.random() < 0.2):
            running.append(waiting.pop())
        g = rng.choice(running)
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    return first, published["total"]


@pytest.mark.parametrize("per", sorted({1, 4, PER}))
@pytest.mark.parametrize("seed", range(4))
def test_look_back_places_every_tile(seed, per):
    """Three launches in a row on one scratch (an earlier epoch's words
    left in it), tile counts with long runs of zeros and more tiles than a
    window holds, at ``per`` tiles a lane (the kernels' kLookBackPer, and
    the others the code takes): each tile's first slot is the plain exclusive prefix,
    the total is whole, and the ticket is back at 0 after each launch."""
    rng = random.Random(seed)
    scratch = cuda_halo.ScanScratch(300, "cpu")
    words = scratch.words.tolist()
    for i in range(cuda_halo.SCAN_HEADER, len(words)):  # a launch before these
        words[i] = _word(cuda_halo.SCAN_EPOCHS - 1, rng.choice([AGGREGATE, PREFIX]),
                         rng.randrange(2**31))
    for _ in range(3):
        tiles = rng.choice([0, 1, 2, 33, 129, 300])
        counts = [0 if rng.random() < 0.4 else rng.randrange(1024) for _ in range(tiles)]
        grid = rng.choice([1, 3, 8, 40])
        first, total = _launch(counts, grid, words, scratch.next_epoch(), rng, per=per)
        assert [first[t] for t in range(tiles)] == np.concatenate(
            [[0], np.cumsum(counts)[:-1]]).tolist()[:tiles]
        assert total == sum(counts)
        assert words[0] == 0


# ---- the kernels' layouts on the protocol's slots ------------------------------


def _placed(flags, tile, per_thread, budget, rng):
    """The slots of the entries ``flags`` (one per input position) as the
    kernels place them: a tile of ``tile`` positions, ``per_thread``
    consecutive ones a thread, the thread's entries after the tile's
    first slot and its exclusive prefix inside the tile; -1 at or above
    the budget.  Also returns the total."""
    n = flags.size
    tiles = -(-n // tile)
    padded = np.zeros(tiles * tile, dtype=np.int64)
    padded[:n] = flags
    per = padded.reshape(tiles, tile // per_thread, per_thread)
    counts = per.sum(axis=(1, 2))
    first, total = _launch(counts.tolist(), 4, [0] * (2 + 2 * max(tiles, 1)), 1, rng, 0.0)
    thread_excl = np.cumsum(per.sum(axis=2), axis=1) - per.sum(axis=2)
    rank = np.cumsum(per, axis=2) - per
    slot = (np.array([first[t] for t in range(tiles)], dtype=np.int64)[:, None, None]
            + thread_excl[:, :, None] + rank).reshape(-1)[:n]
    return np.where((flags != 0) & (slot < budget), slot, -1), total


@pytest.mark.parametrize("listed,bnd,w", [(0, 8, 1), (37, 5, 2), (600, 1, 1), (600, 4096, 3),
                                          (900, 700, 2)])
def test_owner_expand_layout_matches_plain(listed, bnd, w):
    """H3's slots (EXPAND_TILE a tile, two consecutive a thread) placed
    by the emulated look-back give the plain version's boundary pairs,
    sentinels and count."""
    rng = np.random.default_rng(listed + bnd)
    block, width, lo = 1000, 7, 1000
    n_pad = 4 * block
    r = rng.random((block + 1, width))
    table = np.where(r < 0.5, lo + rng.integers(0, block, r.shape),
                     np.where(r < 0.6, rng.integers(0, lo, r.shape), n_pad)).astype(np.int32)
    table[block] = n_pad
    queue = rng.permutation(block)[:max(listed, 1)].astype(np.int32)
    frontier = rng.integers(1, 2**31, (block, w)).astype(np.int32)
    v = table[queue[:listed]].reshape(-1).astype(np.int64)
    border = (v < n_pad) & ((v < lo) | (v >= lo + block))
    slot, total = _placed(border.astype(np.int64), cuda_halo.EXPAND_TILE, ITEMS, bnd,
                          random.Random(listed))
    ids = np.full(bnd, n_pad, dtype=np.int32)
    words = np.zeros((bnd, w), dtype=np.int32)
    src = np.repeat(queue[:listed], width)
    kept = slot >= 0
    ids[slot[kept]] = v[kept]
    words[slot[kept]] = frontier[src[kept]]
    t = torch.from_numpy
    out = [torch.zeros((block, w), dtype=torch.int32), torch.zeros(bnd, dtype=torch.int32),
           torch.zeros((bnd, w), dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32)]
    cuda_halo.owner_push_expand(t(table), t(queue), torch.tensor([listed], dtype=torch.int32),
                                t(frontier), out[0], lo, n_pad, out[1], out[2], out[3], out[4],
                                torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    np.testing.assert_array_equal(out[1].numpy(), ids)
    np.testing.assert_array_equal(out[2].numpy(), words)
    assert int(out[3]) == total == int(border.sum())


@pytest.mark.parametrize("total,density,budget", [(1, 1.0, 1), (2048, 0.5, 1024),
                                                  (6147, 0.3, 900), (20000, 0.02, 32768),
                                                  (20000, 0.9, 4096)])
def test_wire_encode_layout_matches_plain(total, density, budget):
    """M2's words (ENCODE_TILE a tile, eight consecutive a thread) placed
    by the emulated look-back give the plain version's indices, words and
    sentinels."""
    rng = np.random.default_rng(total + budget)
    plane = np.where(rng.random(total) < density, rng.integers(1, 2**31, total), 0)
    plane = plane.astype(np.int32)
    slot, count = _placed((plane != 0).astype(np.int64), cuda_mesh.ENCODE_TILE, 8, budget,
                          random.Random(total))
    idx = np.full(budget, total, dtype=np.int32)
    words = np.zeros(budget, dtype=np.int32)
    kept = slot >= 0
    idx[slot[kept]] = np.flatnonzero(kept)
    words[slot[kept]] = plane[kept]
    enc = cuda_mesh.wire_encode_plain(torch.from_numpy(plane), budget)
    np.testing.assert_array_equal(enc.idx.numpy(), idx)
    np.testing.assert_array_equal(enc.words.numpy(), words)
    assert int(enc.count) == count
