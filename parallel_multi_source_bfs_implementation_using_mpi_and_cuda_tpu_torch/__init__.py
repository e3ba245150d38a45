"""PyTorch/CUDA port of the multi-source BFS (distance-to-set) framework.

Same contract as the JAX package beside it
(``parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu``): given
an undirected graph and K query groups of source vertices, run a
multi-source BFS per group, compute F(U_k) = sum of distances over reached
vertices, and report the group with the minimum F (ties to the lowest
index, 1-based in the report).

This package imports torch and numpy only — never jax, and nothing of the
JAX package, which stays the reference the port is held against.  Layout
mirrors the JAX package: :mod:`.utils` (I/O, knobs, timing, report, the fault
plan, checkpoint journal, stats tables and flight recorder),
:mod:`.models` (host CSR, generators), :mod:`.ops` (engines and kernel
wrappers), :mod:`.runtime` (kernel build, native host runtime,
supervisor), :mod:`.cli`.  Hand-written CUDA kernels live in ``csrc/``
and are compiled with nvcc at first use (:mod:`.runtime.kernels`); the
host preprocessing runs in ``runtime/loader.cpp``, compiled with the host
C++ compiler at first use (:mod:`.runtime.native_loader`).

Routes ported so far, on ``-gn 1``: the default bitbell route (the BELL
reduction forest with the on-device push/pull switch, and its capacity
ladder down to the host-streamed forest), the stencil (banded adjacency)
route, the low-K and byte-plane BELL routes, the tensor-core ``mxu``
route, the ELL route (``MSBFS_BACKEND=pallas``) and the host-streamed
route (``MSBFS_BACKEND=streamed``) — see :mod:`.cli` for the routes that
fail loudly as not yet ported.
"""

__version__ = "0.1.0"
