"""Multi-device execution: device meshes (``mesh.py``), the sharded
window programs over them (``sharded.py``), the grid-partitioned
placement and halo exchange (``partition.py``, ``halo.py``) and
multi-process runs over ``torch.distributed`` (``multihost.py``,
``multihost_dryrun.py``). The exports are the JAX package's."""

from spatialflink_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh,
    make_mesh,
)
from spatialflink_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_range_query,
    sharded_range_query_2d,
    sharded_knn,
    sharded_knn_multi,
    sharded_join,
    sharded_traj_stats,
)
