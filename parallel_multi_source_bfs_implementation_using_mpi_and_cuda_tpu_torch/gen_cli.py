"""Fixture generator CLI: make or import reference-format graph and query
binaries (the reference reads them, main.cu:92-130 and 134-164, but ships
no tool that writes them).

    python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.gen_cli \
        --kind rmat --scale 16 --edge-factor 16 --graph g.bin \
        --queries 64 --max-group 64 --query-file q.bin --seed 42

Kinds: ``rmat`` (power-law, Graph500-style; ``MSBFS_NATIVE_RMAT=1`` samples
it in the native runtime, another graph than the NumPy stream's for one
seed), ``grid`` (side x side 4-neighbor lattice), ``road`` (the calibrated
road-network stand-in of models.generators.road_edges), ``gnm`` (uniform
random).  ``--weights`` appends a seeded cost section (the weighted
route's input), ``--deltas`` writes edge-delta batches against the graph
(dynamic.delta's format).  ``--convert <file>`` imports a public graph
instead: DIMACS ``.gr`` (``--informat dimacs``) or a SNAP edge list
(``--informat snap``), ``.gz`` read too.

The JAX package's generator, flag for flag: the same files byte for byte,
the same stderr lines, exit 0, 1 (a convert that failed) or 2 (a flag
error, found before anything is generated).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("rmat", "grid", "road", "gnm"), default="rmat")
    ap.add_argument(
        "--convert",
        default=None,
        metavar="FILE",
        help="convert a real dataset instead of generating (--informat)",
    )
    ap.add_argument(
        "--informat",
        choices=("dimacs", "snap"),
        default="dimacs",
        help="--convert input format: DIMACS .gr or SNAP edge list",
    )
    ap.add_argument("--scale", type=int, default=16, help="log2(n) for rmat; grid/road side = 2^(scale/2)")
    ap.add_argument("--edge-factor", type=int, default=16, help="edges per vertex (rmat/gnm)")
    ap.add_argument("--graph", required=True, help="output graph .bin path")
    ap.add_argument("--queries", type=int, default=0, help="number of query groups (0: no query file)")
    ap.add_argument("--max-group", type=int, default=64, help="max sources per group (<= 128)")
    ap.add_argument("--query-file", default=None)
    ap.add_argument(
        "--deltas",
        default=None,
        metavar="FILE",
        help="also emit a binary edge-delta file against the generated "
        "graph (dynamic.delta format)",
    )
    ap.add_argument("--delta-batches", type=int, default=1, help="batches in --deltas")
    ap.add_argument(
        "--delta-size",
        type=int,
        default=16,
        help="mutations per batch (half inserts, half deletes)",
    )
    ap.add_argument(
        "--delta-locality",
        type=float,
        default=0.9,
        help="0..1: 1 = street-closure-sized patch, 0 = whole-graph churn",
    )
    ap.add_argument(
        "--weights",
        choices=("uniform", "zipf"),
        default=None,
        metavar="DIST",
        help="also emit a trailing integer edge-cost section (uniform or "
        "zipf, seeded; the weighted route's input)",
    )
    ap.add_argument(
        "--max-cost",
        type=int,
        default=16,
        help="--weights cost ceiling (costs drawn in [1, max-cost])",
    )
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    # Flag errors before the (possibly minutes-long) generation: they fail
    # at once and write nothing.
    if args.queries and not args.query_file:
        print("--queries given without --query-file", file=sys.stderr)
        return 2
    if args.query_file and not args.queries:
        print("--query-file given without --queries", file=sys.stderr)
        return 2
    if args.queries and (not 0 < args.queries <= 255 or not 0 < args.max_group <= 128):
        # uint8 K and uint8 group sizes on the wire (main.cu:143-152)
        print("--queries must be 1..255, --max-group 1..128", file=sys.stderr)
        return 2
    if args.deltas and (
        args.delta_batches < 1
        or args.delta_size < 1
        or not 0.0 <= args.delta_locality <= 1.0
    ):
        print(
            "--delta-batches/--delta-size must be >= 1, "
            "--delta-locality in [0, 1]",
            file=sys.stderr,
        )
        return 2
    if args.weights and args.max_cost < 1:
        print("--max-cost must be >= 1", file=sys.stderr)
        return 2

    from .models import generators
    from .runtime.native_loader import NativeBuildError
    from .utils.io import load_dimacs_gr, load_edgelist, save_graph_bin, save_query_bin

    if args.convert:
        defaults = {"kind": "rmat", "scale": 16, "edge_factor": 16}
        ignored = [
            f"--{k.replace('_', '-')}" for k, d in defaults.items() if getattr(args, k) != d
        ]
        if ignored:
            print(
                f"--convert takes the graph from {args.convert}; "
                f"ignoring generation flags: {', '.join(ignored)}",
                file=sys.stderr,
            )
        try:
            if args.informat == "dimacs":
                n, edges = load_dimacs_gr(args.convert)
            else:
                n, edges = load_edgelist(args.convert)
        except (IOError, OSError, ValueError, OverflowError, NativeBuildError) as exc:
            # OverflowError: an id beyond int32 on the Python path;
            # NativeBuildError: no native parser (there is no fallback).
            print(f"convert failed: {exc}", file=sys.stderr)
            return 1
    elif args.kind == "rmat":
        n, edges = generators.rmat_edges(args.scale, edge_factor=args.edge_factor, seed=args.seed)
    elif args.kind == "grid":
        side = 1 << (args.scale // 2)
        n, edges = generators.grid_edges(side, side)
    elif args.kind == "road":
        side = 1 << (args.scale // 2)
        n, edges = generators.road_edges(side, side, seed=args.seed)
    else:
        n = 1 << args.scale
        n, edges = generators.gnm_edges(n, args.edge_factor * n, seed=args.seed)
    weights = None
    if args.weights:
        # Seeds --seed + 3, so that adding --weights leaves the graph,
        # query (+1) and delta (+2) streams of a recipe byte-identical.
        weights = generators.edge_costs(
            len(edges), dist=args.weights, max_cost=args.max_cost, seed=args.seed + 3,
        )
    save_graph_bin(args.graph, n, edges, weights=weights)
    wnote = f" weights={args.weights}[1,{args.max_cost}]" if args.weights else ""
    print(f"wrote {args.graph}: n={n} m={len(edges)}{wnote}", file=sys.stderr)

    if args.queries:
        qs = generators.random_queries(n, args.queries, max_group=args.max_group, seed=args.seed + 1)
        save_query_bin(args.query_file, qs)
        print(
            f"wrote {args.query_file}: K={len(qs)} sizes="
            f"{[len(q) for q in qs[:8]]}{'...' if len(qs) > 8 else ''}",
            file=sys.stderr,
        )

    if args.deltas:
        from .dynamic.delta import save_delta_bin

        batches = generators.delta_batches(
            n,
            edges,
            batches=args.delta_batches,
            batch_size=args.delta_size,
            locality=args.delta_locality,
            seed=args.seed + 2,
        )
        save_delta_bin(args.deltas, n, batches)
        sizes = [(len(i), len(d)) for i, d in batches[:8]]
        print(
            f"wrote {args.deltas}: batches={len(batches)} "
            f"(ins, del)={sizes}{'...' if len(batches) > 8 else ''}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
