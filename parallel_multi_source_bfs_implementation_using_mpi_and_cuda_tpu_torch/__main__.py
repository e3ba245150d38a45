"""``python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch
-g <graph.bin> -q <query.bin> -gn <numGPU>`` — the reference CLI contract,
run on the CUDA device."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv))
