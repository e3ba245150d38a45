"""The multi-device layer: meshes of devices, query scheduling, the
collectives and the ('q', 'v') engines (the JAX package's parallel/).

The reference's MPI phase structure maps onto one controller driving a
:class:`.mesh.Mesh`: the round-robin assignment (main.cu:303-307) is the
cyclic grid of :mod:`.scheduler`, the Gather/Gatherv of (q, F) pairs
(main.cu:324-368) its fixed-shape max merge, and the engines hold a piece
of state per mesh entry on that entry's device.  Modules import lazily
from here: ``from .parallel.distributed import DistributedEngine``.
"""
