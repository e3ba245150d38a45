"""Kernel K5's byte pull (``ops/cuda_flag_pull.py``, ``csrc/flag_pull.cu``)
on the CPU: its plain version against the JAX package's low-K pull
(``lowk_expand``) and ``bell_expand_packed``; the forest's row owners; a
NumPy emulation of the kernel's walk (active lanes, live rows, the
frontier bitmap, the wide-row exit, the final gather over a stale
scratch) against the plain version, level by level through real BFSs;
and the plan.  Everything is bits and integers: every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    bell as jbell_model,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import bell as jbell
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import lowk as jlowk
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    DEFAULT_WIDTHS,
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bitbell,
    cuda_bell,
    cuda_flag_pull,
    lowk,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io

JBellGraph = jbell_model.BellGraph
NARROW = (1, 2, 4, 8)
FlagPullPlan = cuda_flag_pull.FlagPullPlan
# 32-slot chunks a warp reads of a wide row between two exit checks
# (csrc/flag_pull.cu kWideChunks).
WIDE_CHUNKS = 2


def _edges(kind):
    """(n, edges): RMAT with a 600-neighbour hub, a self-loop-only vertex
    and isolated vertices past the RMAT range; a road grid."""
    if kind == "hub":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=11)
        hub = np.stack([np.full(600, 3, np.int32), np.arange(600, dtype=np.int32) % 290 + 10], 1)
        return 400, np.concatenate([e, hub, [[350, 350], [8, 9], [8, 9]]]).astype(np.int32)
    return generators.road_edges(12, 12, seed=5)


@pytest.fixture(scope="module")
def graphs():
    """(n, port BellGraph, JAX BellGraph) by (kind, ladder): the narrow
    ladder splits every vertex of degree > 8 into chunk rows, so the
    forest has three levels and many wide rows."""
    out = {}
    for kind in ("hub", "road"):
        n, e = _edges(kind)
        g, jg = CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e)
        for name, widths in (("default", DEFAULT_WIDTHS), ("narrow", NARROW)):
            kw = dict(widths=widths, min_bucket_rows=0)
            out[kind, name] = (n, BellGraph.from_host(g, "cpu", **kw), JBellGraph.from_host(jg, **kw))
    return out


def _kp(k):
    return max(4, -(-k // 4) * 4)


def _plane(flags, kp):
    """(n, K) 0/1 flags -> the port's (n, Kp) uint8 byte plane."""
    out = np.zeros((flags.shape[0], kp), dtype=np.uint8)
    out[:, : flags.shape[1]] = flags
    return out


def _go(direction=bitbell.DIR_PULL, level=0):
    return torch.tensor([1, level, 0, direction], dtype=torch.int32)


def _visited(rng, frontier, density):
    """Visited flags: none, a share holding the frontier, or all."""
    if density == "none":
        return np.zeros_like(frontier)
    if density == "all":
        return np.ones_like(frontier)
    return (frontier | (rng.random(frontier.shape) < 0.4)).astype(np.uint8)


# -- (a) the plain pull against the JAX package ------------------------------


@pytest.mark.parametrize("ladder", ["default", "narrow"])
@pytest.mark.parametrize("density", ["none", "partial", "all"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_plain_pull_matches_jax_lowk_expand(graphs, ladder, density, k):
    """flag_pull_plain and the wrapper on CPU tensors against JAX's low-K
    pull, ``lowk_expand(graph, 0)(visited, frontier)`` (Kp = 4); gated off,
    the plane is untouched."""
    n, bg, jb = graphs["hub", ladder]
    rng = np.random.default_rng(k * 7 + len(density))
    frontier = (rng.random((n, k)) < 0.15).astype(np.uint8)
    visited = _visited(rng, frontier, density)
    want = np.asarray(jlowk.lowk_expand(jb, 0)(jnp.asarray(visited), jnp.asarray(frontier)))
    f, v = torch.from_numpy(_plane(frontier, 4)), torch.from_numpy(_plane(visited, 4))
    for pull in (cuda_flag_pull.flag_pull_plain, cuda_flag_pull.flag_pull):
        hits = torch.full_like(f, 9)
        pull(f, v, bg, hits, _go(), k)
        np.testing.assert_array_equal(hits.numpy()[:, :k], want, err_msg=pull.__name__)
        assert not hits[:, k:].any()
        stale = torch.full_like(f, 9)
        pull(f, v, bg, stale, _go(bitbell.DIR_PUSH), k)
        assert bool((stale == 9).all())
    if density == "all":
        assert not want.any()


@pytest.mark.parametrize("ladder", ["default", "narrow"])
@pytest.mark.parametrize("density", ["none", "partial", "all"])
@pytest.mark.parametrize("kind,k", [("hub", 8), ("hub", 64), ("road", 8), ("road", 64)])
def test_plain_pull_matches_jax_bell_expand_packed(graphs, ladder, density, kind, k):
    """flag_pull_plain against JAX's bell_expand_packed (Kp = 8, 64) on
    distances whose level-2 vertices are the frontier and whose -1s are
    the unvisited vertices."""
    n, bg, jb = graphs[kind, ladder]
    rng = np.random.default_rng(k + len(density) + len(kind))
    dist = rng.integers(0, 3, size=(n, k)).astype(np.int32)
    if density != "all":
        dist[rng.random((n, k)) < (0.9 if density == "none" else 0.5)] = -1
    frontier = (dist == 2).astype(np.uint8)
    visited = (dist != -1).astype(np.uint8)
    want = np.asarray(jbell.bell_expand_packed(jnp.asarray(dist), jnp.int32(2), jb))
    f, v = torch.from_numpy(frontier), torch.from_numpy(visited)
    hits = torch.full_like(f, 9)
    cuda_flag_pull.flag_pull_plain(f, v, bg, hits, _go(), k)
    np.testing.assert_array_equal(hits.numpy(), want.astype(np.uint8))


def test_wrapper_checks_its_inputs(graphs):
    n, bg, _ = graphs["hub", "default"]
    f = torch.zeros((n, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="real lanes"):
        cuda_flag_pull.flag_pull(f, f.clone(), bg, f.clone(), _go(), 5)
    with pytest.raises(ValueError, match="shape"):
        cuda_flag_pull.flag_pull(f, f.clone(), bg, f.clone(), _go(), 1,
                                 levels=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint8"):
        cuda_flag_pull.flag_pull(f.to(torch.int32), f, bg, f.clone(), _go(), 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_flag_pull.flag_pull(f[:5], f[:5].clone(), bg, f[:5].clone(), _go(), 1)


# -- (b) the owner of every forest row ---------------------------------------


def _level_rows(bg):
    """Per level: (out offset, [slot indices of each level-local row])."""
    out, off = [], 0
    for flat, shapes in zip(bg.level_cols, bg.level_shapes):
        cols, rows, slot = flat.numpy(), [], 0
        for r_b, w_b in shapes:
            for _ in range(r_b):
                rows.append(cols[slot : slot + w_b])
                slot += w_b
        out.append((off, rows))
        off += len(rows)
    return out


@pytest.mark.parametrize("kind,ladder", [("hub", "default"), ("hub", "narrow"), ("road", "default"),
                                         ("road", "narrow")])
def test_row_owner_leads_every_row_to_its_owner(graphs, kind, ladder):
    """Every row of every level belongs to the vertex whose final row
    reaches it through the forest: the rows below final_slot[v] are
    exactly the rows whose owner is v; isolated vertices own none."""
    n, bg, _ = graphs[kind, ladder]
    owner = bg.row_owner("cpu").numpy()
    assert owner.dtype == np.int32 and owner.shape == (bg.total_rows,)
    assert bg.row_owner("cpu") is bg.row_owner("cpu")  # cached
    levels = _level_rows(bg)
    if ladder == "narrow" and kind == "hub":
        assert len(levels) >= 3
    level_of = np.concatenate([np.full(len(rows), li) for li, (_, rows) in enumerate(levels)])
    final = bg.final_slot.numpy()
    for v in range(n):
        below, todo = set(), [int(final[v])] if final[v] < bg.total_rows else []
        while todo:
            g = todo.pop()
            below.add(g)
            li = int(level_of[g])
            if li:
                off, rows = levels[li]
                prev_off, prev_rows = levels[li - 1]
                todo += [prev_off + int(c) for c in rows[g - off] if c < len(prev_rows)]
        assert below == set(np.flatnonzero(owner == v).tolist()), v
    degrees = np.bincount(owner, minlength=n)
    assert (degrees[final == bg.total_rows] == 0).all()


# -- (c) a NumPy emulation of csrc/flag_pull.cu -------------------------------


def _active(k, kp, levels, level):
    """The kernel's active-lane mask: one 0x01 byte per lane of a query
    below k whose counter says its frontier is not empty."""
    act = np.zeros(kp, dtype=np.uint8)
    for q in range(k):
        act[q] = levels is None or levels[8 * q] == level + 1
    return act.view(np.uint32)


def _flag_emulation(bg, frontier, visited, k, levels, level, plan, v_cat, rule="kept"):
    """csrc/flag_pull.cu in NumPy on (n, Kp) uint8 planes, its scratch
    ``v_cat`` ((total_rows + 1, W) uint32) updated in place as the kernel
    leaves it: the pre-pass (mask, bitmap, live bits), each level's runs
    decoded from the table as the kernel decodes them (bucket search,
    32-lane chunks with the row OR at its first lane, a warp a wide row
    stopping, after a step of 64 slots, once its OR covers its owner's
    needed lanes), then the final
    gather.  A row that is not live is neither read nor written, a slot
    whose source the bitmap excludes reads no frontier row, and the bits
    instance none at all.  ``rule`` drops one of the two rules that keep
    a stale scratch out of the result: "level0_owners" takes the live bit
    of every level's row r from the owner of level-0 row r, "no_zero"
    lets the final gather read every vertex's row.  Returns the hit plane
    and the slots and frontier rows read."""
    n, kp = frontier.shape
    w = kp // 4
    f, vis = frontier.view(np.uint32), visited.view(np.uint32)
    mask = _active(k, kp, levels, level)
    owner = bg.row_owner("cpu").numpy().astype(np.int64)
    vlive = ((mask[None, :] & ~vis) != 0).any(axis=1)
    live = vlive[owner]
    fmap = (f != 0).any(axis=1) if plan.bitmap else None
    table, meta = cuda_flag_pull.flag_tables(bg, plan.chunks, "cpu")
    table, meta = table.numpy(), list(meta)
    p = w if plan.w_instance else 8
    if rule == "level0_owners":
        size0 = bg.level_sizes[0]
        for g in range(size0, bg.total_rows):
            live[g] = vlive[owner[(g - size0) % size0]]
    prev, frontier_reads, slots_read = f, 0, 0
    for li, flat in enumerate(bg.level_cols):
        cols = flat.numpy()
        _, prev_rows, out_off, begin, count, runs = meta[6 * li : 6 * li + 6]
        tab = table[begin : begin + count]
        read = np.zeros(cols.shape[0], dtype=np.int64)

        def source(c):
            if li == 0 and plan.bitmap and c < prev_rows and not fmap[c]:
                return prev_rows
            return c

        def value(c):
            nonlocal frontier_reads
            if c >= prev_rows:
                return np.zeros(w, dtype=np.uint32)
            if li == 0 and plan.bits:
                return np.array([1], dtype=np.uint32)
            frontier_reads += li == 0
            return prev[c]

        for run in range(runs):
            b = int(np.searchsorted(tab[:, 4], run, side="right")) - 1
            off, rows, width, row_base, first, rpc = (int(x) for x in tab[b])
            local, g0 = run - first, out_off + row_base
            if rpc:
                row0 = local * plan.chunks * rpc
                for s in range(plan.chunks):
                    for r in range(rpc):
                        row = row0 + s * rpc + r
                        if row >= rows or not live[g0 + row]:
                            continue
                        acc = np.zeros(w, dtype=np.uint32)
                        for j in range(width):
                            slot = off + row * width + j
                            read[slot] += 1
                            acc |= value(source(int(cols[slot])))
                        v_cat[g0 + row] = acc
            elif live[g0 + local]:
                need_row = mask & ~vis[owner[g0 + local]]
                for w0 in range(0, w, p):
                    need = need_row[w0 : w0 + p]
                    acc = np.zeros(need.shape[0], dtype=np.uint32)
                    j0 = 0
                    while need.any() and j0 < width:
                        for j in range(j0, min(j0 + 32 * WIDE_CHUNKS, width)):
                            slot = off + local * width + j
                            read[slot] += 1
                            acc |= value(source(int(cols[slot])))[w0 : w0 + p]
                        j0 += 32 * WIDE_CHUNKS
                        if ((acc & need) == need).all():
                            break
                    v_cat[g0 + local, w0 : w0 + p] = acc
        # Every slot of a live narrow row read once; no slot of a row that
        # is not live; a wide row's slots at most once a pass.
        slot_live = np.repeat(live[out_off : out_off + bg.level_sizes[li]],
                              [w_b for r_b, w_b in bg.level_shapes[li] for _ in range(r_b)])
        assert (read[~slot_live] == 0).all() and (read <= -(-w // p)).all()
        slots_read += int(read.sum())
        prev = v_cat[out_off : out_off + bg.level_sizes[li]]
    if plan.bits:
        assert frontier_reads == 0
    elif plan.bitmap and fmap is not None:
        in_map = fmap[np.minimum(bg.level_cols[0].numpy(), n - 1)] & (bg.level_cols[0].numpy() < n)
        assert frontier_reads <= int(in_map.sum())
    hits = np.zeros((n, w), dtype=np.uint32)
    final = bg.final_slot.numpy()
    for v in range(n):
        need = mask & ~vis[v]
        if (need.any() or rule == "no_zero") and final[v] < bg.total_rows:
            hits[v] = v_cat[final[v]] & (~vis[v] if rule == "no_zero" else need)
    return hits.view(np.uint8), dict(slots=slots_read, frontier_rows=frontier_reads)


PLANS = {
    "W1/map/bits": FlagPullPlan(1, False, True, True, 8),
    "W1/map": FlagPullPlan(1, False, True, False, 8),
    "W1/nomap": FlagPullPlan(1, False, False, False, 8),
    "W16/vec16/map": FlagPullPlan(16, True, True, False, 4),
    "W16/vec4/nomap": FlagPullPlan(16, False, False, False, 4),
    "Wn/map": FlagPullPlan(0, False, True, False, 2),
    "Wn/nomap": FlagPullPlan(0, False, False, False, 2),
}


def _bfs_levels(bg, sources, kp, plan, rule="kept"):
    """A BFS of the byte planes driven level by level, every pull through
    the emulation (its scratch carried from level to level, stale rows
    and all) and through flag_pull_plain; yields both hit planes."""
    n = bg.n
    k = len(sources)
    frontier = np.zeros((n, kp), dtype=np.uint8)
    for q, src in enumerate(sources):
        frontier[src, q] = 1
    visited = frontier.copy()
    levels = np.zeros(8 * kp, dtype=np.int32)
    levels[: 8 * k : 8] = frontier[:, :k].any(axis=0)
    v_cat = np.zeros((bg.total_rows + 1, kp // 4), dtype=np.uint32)
    for level in range(n):
        if not frontier.any():
            return
        got, _ = _flag_emulation(bg, frontier, visited, k, levels, level, plan, v_cat, rule)
        want = torch.empty((n, kp), dtype=torch.uint8)
        cuda_flag_pull.flag_pull_plain(torch.from_numpy(frontier), torch.from_numpy(visited), bg,
                                       want, _go(level=level), k)
        yield got, want.numpy()
        new = want.numpy() & ~visited
        visited |= new
        frontier = new
        found = new[:, :k].any(axis=0)
        levels[: 8 * k : 8] = np.where(found, level + 2, levels[: 8 * k : 8])


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("kind,ladder", [("hub", "default"), ("hub", "narrow"), ("road", "narrow")])
def test_emulated_kernel_equals_plain_through_a_bfs(graphs, plan, kind, ladder):
    """Through whole BFSs — queries that converge at different levels, one
    whose sources are isolated (never active after its first level) —
    the emulated kernel equals the plain pull on every level."""
    n, bg, _ = graphs[kind, ladder]
    p = PLANS[plan]
    k = 1 if p.bits else {1: 3, 16: 64}.get(p.w_instance, 6)
    kp = _kp(k) if p.w_instance != 16 else 64
    rng = np.random.default_rng(len(plan) + len(kind))
    final = bg.final_slot.numpy()
    isolated, reaching = np.flatnonzero(final == bg.total_rows), np.flatnonzero(final < bg.total_rows)
    sources = [rng.choice(reaching, size=int(rng.integers(1, 4))) for _ in range(k)]
    if k > 1 and isolated.size:
        sources[1] = isolated[:2]
    levels = 0
    for got, want in _bfs_levels(bg, sources, kp, p):
        np.testing.assert_array_equal(got, want, err_msg=f"level {levels}")
        levels += 1
    assert levels >= 3


@pytest.mark.parametrize("plan", ["W1/map", "Wn/nomap", "W16/vec16/map"])
def test_emulation_exits_wide_rows_early_and_skips_dead_rows(graphs, plan):
    """On a dense frontier the hub's 256-slot rows stop early and rows
    whose owners have visited every active lane are skipped: the
    emulation reads fewer slots than the live rows have, and still equals
    the plain pull."""
    n, bg, _ = graphs["hub", "default"]
    p = PLANS[plan]
    kp = 64 if p.w_instance == 16 else (4 if p.w_instance == 1 else 24)
    k = kp
    rng = np.random.default_rng(kp)
    frontier = (rng.random((n, kp)) < 0.5).astype(np.uint8)
    visited = frontier | (rng.random((n, 1)) < 0.5).astype(np.uint8)
    # Rows of fully visited owners are not live, so their scratch keeps
    # the marker written before the call; the final row stays zero.
    v_cat = np.full((bg.total_rows + 1, kp // 4), 0xDEADBEEF, dtype=np.uint32)
    v_cat[-1] = 0
    got, reads = _flag_emulation(bg, frontier, visited, k, None, 0, p, v_cat)
    want = torch.empty((n, kp), dtype=torch.uint8)
    cuda_flag_pull.flag_pull_plain(torch.from_numpy(frontier), torch.from_numpy(visited), bg,
                                   want, _go(), k)
    np.testing.assert_array_equal(got, want.numpy())
    owner = bg.row_owner("cpu").numpy()
    dead = (visited == 1).all(axis=1)[owner]
    assert dead.any() and (~dead).any()
    assert (v_cat[: bg.total_rows][dead] == 0xDEADBEEF).all()
    assert not (v_cat[: bg.total_rows][~dead] == 0xDEADBEEF).all(axis=1).any()
    # The live rows' slots, fewer where a wide row stopped early.
    widths = np.concatenate([np.full(r_b, w_b) for shapes in bg.level_shapes for r_b, w_b in shapes])
    assert 0 < reads["slots"] < int(widths[~dead].sum())


@pytest.mark.parametrize("rule", ["level0_owners", "no_zero"])
def test_dropping_a_stale_scratch_rule_gives_a_wrong_answer(graphs, rule):
    """Two pulls over one scratch.  The first, with a frontier in query 1
    only, leaves rows behind; the second sees query 1 converged (its
    counter one level old) and most vertices visited by query 0.  Taking the level-0
    owners for deeper rows leaves a hub's reducing row stale; letting the
    gather read the rows of vertices that need nothing leaks query 1's old
    hits.  With both rules the emulation equals the plain pull."""
    n, bg, _ = graphs["hub", "narrow"]
    p, kp, k = PLANS["W1/map"], 4, 2
    rng = np.random.default_rng(5)
    v_cat = np.zeros((bg.total_rows + 1, 1), dtype=np.uint32)
    first = np.zeros((n, kp), dtype=np.uint8)
    first[rng.random(n) < 0.3, 1] = 1
    _flag_emulation(bg, first, np.zeros_like(first), k, None, 0, p, v_cat)
    # Query 0: a fresh frontier, everything visited but the hub 3 and a
    # few others; query 1: no frontier, its counter says converged.
    second = np.zeros((n, kp), dtype=np.uint8)
    second[rng.random(n) < 0.3, 0] = 1
    visited = np.zeros((n, kp), dtype=np.uint8)
    visited[:, 0] = 1
    visited[[3, 10, 11, 12], 0] = 0
    levels = np.zeros(8 * kp, dtype=np.int32)
    levels[0], levels[8] = 2, 1
    want = torch.empty((n, kp), dtype=torch.uint8)
    cuda_flag_pull.flag_pull_plain(torch.from_numpy(second), torch.from_numpy(visited), bg,
                                   want, _go(level=1), k)
    kept, _ = _flag_emulation(bg, second, visited, k, levels, 1, p, v_cat.copy())
    np.testing.assert_array_equal(kept, want.numpy())
    dropped, _ = _flag_emulation(bg, second, visited, k, levels, 1, p, v_cat.copy(), rule)
    assert (dropped != want.numpy()).any()


@pytest.mark.parametrize("chunks", [2, 4, 8])
@pytest.mark.parametrize("kind,ladder", [("hub", "default"), ("hub", "narrow"), ("road", "default")])
def test_flag_tables_cover_every_row_once(graphs, chunks, kind, ladder):
    """flag_tables' runs, decoded as the kernel decodes them, cover every
    row of every level once: the forest's table recut for ``chunks``."""
    _, bg, _ = graphs[kind, ladder]
    table, meta = cuda_flag_pull.flag_tables(bg, chunks, "cpu")
    assert cuda_flag_pull.flag_tables(bg, chunks, "cpu")[0] is table
    table, meta = table.numpy(), list(meta)
    forest, forest_meta = cuda_bell.forest_tables(bg, 1, "cpu")
    assert list(forest_meta)[0::6] == meta[0::6]  # the same cols
    for li, size in enumerate(bg.level_sizes):
        _, _, _, begin, count, runs = meta[6 * li : 6 * li + 6]
        tab = table[begin : begin + count]
        seen = np.zeros(size, dtype=np.int64)
        for run in range(runs):
            b = int(np.searchsorted(tab[:, 4], run, side="right")) - 1
            _, rows, _, row_base, first, rpc = (int(x) for x in tab[b])
            local = run - first
            if rpc:
                lo = local * chunks * rpc
                assert lo < rows
                seen[row_base + lo : row_base + min(lo + chunks * rpc, rows)] += 1
            else:
                seen[row_base + local] += 1
        assert (seen == 1).all(), li


# -- (d) the plan -------------------------------------------------------------


CAP = (cuda_flag_pull.BLOCK_SMEM_BYTES - cuda_flag_pull.TABLE_BYTES) * 8


@pytest.mark.parametrize(
    "w,n,k,vec16,label",
    [
        (1, 1 << 20, 1, True, "W1/map/bits"),
        (1, 1 << 20, 4, True, "W1/map"),
        (1, 1 << 16, 3, False, "W1/map"),
        (1, CAP, 1, True, "W1/map/bits"),
        (1, CAP + 1, 1, True, "W1/nomap"),
        (1, 1 << 24, 2, True, "W1/nomap"),
        (16, 1 << 20, 64, True, "W16/vec16/map"),
        (16, 1 << 20, 64, False, "W16/vec4/map"),
        (16, CAP + 128, 61, True, "W16/vec16/nomap"),
        (2, 1 << 20, 8, True, "Wn/vec4/map"),
        (6, 5000, 24, True, "Wn/vec4/map"),
        (64, 1 << 22, 255, True, "Wn/vec4/nomap"),
    ],
)
def test_flag_pull_plan(w, n, k, vec16, label):
    plan = cuda_flag_pull.flag_pull_plan(w, n, k, vec16)
    assert plan.label == label
    assert plan.chunks == {1: 8, 16: 4}.get(w, 2) == cuda_flag_pull.run_chunks(w)
    assert plan.bits == (plan.bitmap and w == 1 and k == 1)
    assert plan == cuda_flag_pull.flag_pull_plan(w, n, k, vec16)
    # The bitmap and the table fit one block's shared memory.
    if plan.bitmap:
        assert 4 * cuda_flag_pull.map_words(n) + cuda_flag_pull.TABLE_BYTES <= 232_448
    assert cuda_flag_pull.map_words(n) % 4 == 0 and 32 * cuda_flag_pull.map_words(n) >= n


def test_cap_is_the_h100_block_limit():
    assert CAP == 1_835_008


# -- the engines --------------------------------------------------------------


@pytest.mark.parametrize("engine,k", [("lowk", 1), ("lowk", 3), ("bell", 13), ("bell", 64)])
def test_byte_engines_pull_through_flag_pull(graphs, monkeypatch, engine, k):
    """The byte engines hand the pull their carry's visited plane, query
    count and level counters, and equal the plain pull they replaced."""
    n, bg, _ = graphs["hub", "narrow"]
    seen = []
    real = cuda_flag_pull.flag_pull_plain

    def spy(frontier, visited, graph, hits, ctrl, k_, max_levels, scratch, levels):
        seen.append((k_, tuple(visited.shape), tuple(levels.shape)))
        real(frontier, visited, graph, hits, ctrl, k_, max_levels, scratch, levels)

    monkeypatch.setattr(lowk, "flag_pull_plain", spy)
    queries = io.pad_queries(generators.random_queries(n, k, max_group=4, seed=k))
    cls = lowk.LowKEngine if engine == "lowk" else bell.BellEngine
    kw = {"sparse_budget": 0} if engine == "lowk" else {}
    got = cls(bg, plain=True, **kw).query_stats(queries)
    assert seen
    kp = seen[0][1][1]
    k_pad = k if engine == "lowk" else -(-k // 8) * 8
    assert all(s == (k_pad, (n, kp), (8 * kp,)) for s in seen)
    want = lowk.LowKEngine(bg, sparse_budget=0).query_stats(queries)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
