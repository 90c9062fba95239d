"""Domain decomposition of the 2D grids over a mesh of shards.

Counterpart of ``pfhubbenchmarks_tpu/parallel/``: the mesh and the block
layout (``mesh.py``), the halo-exchange layer that stands for ``lax.ppermute``
and ``lax.psum`` (``comm.py``: every shard in one process, or one shard per
rank over ``torch.distributed``), the explicit-halo residual and functional
(``halo.py``), the sharded LMR smoother over kernel S (``halo_smoother.py``)
and its dry run (``dryrun.py``).
"""
