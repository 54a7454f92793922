"""Band and row parallelism over ``torch.distributed`` (port of
pfb_imaging_tpu/parallel/).

The reference distributes work over Ray band actors and dask row blocks;
the JAX package turned both into axes of a device mesh. PyTorch runs one
process per GPU, so the port maps JAX's two levels onto ranks:

  * a JAX process (host) is a torch node, the ranks that share a host
    (torchrun's ``LOCAL_WORLD_SIZE``, one rank per node when it is unset):
    ``multihost.process_index()`` / ``process_count()`` are the node index
    and count, and bands owned by process are owned by node;
  * a JAX device is a torch rank. A :class:`mesh.Mesh` is a band x row grid
    of ranks with its process groups: its row groups lie inside a node and
    its band axis spans the nodes (the reverse of the JAX package's
    ``spanning_devices`` layout, which puts the row axis across hosts).

``band``: every (nband, ...) cube is split over the band axis; the band sums
of the l2,1 prox and the solvers' inner products gather every band over
the band group and add them in band order, so a band-sharded run gives
the bits of the unsharded one. ``row``: visibility rows (the imager's gridding) or
the padded PSF grid's rows (the distributed FFT of the 8k-image Hessian)
are split over the row group. With one rank, or no process group, every
collective is the identity.
"""

from .mesh import Mesh, band_sharding, make_mesh, shard_cube, stream_band_stack  # noqa: F401
from .multihost import init_distributed  # noqa: F401
from .sharded import row_sharded_vis2dirty  # noqa: F401
