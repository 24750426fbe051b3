"""Batched tensor operations: the device compute path.

Each operation runs on its inputs' device; the four hand kernels
(``kernels/csrc``) run on the card and their plain PyTorch versions on
the CPU. ``join_kernel`` of the JAX package is not here: see
``spatialflink_tpu_torch.NOT_EXPORTED``.
"""

from spatialflink_tpu_torch.ops.distances import (  # noqa: F401
    bbox_bbox_min_distance,
    bbox_point_min_distance,
    haversine_distance,
    pairwise_distance,
    point_point_distance,
    point_polyline_distance,
    point_segment_distance,
)
from spatialflink_tpu_torch.ops.cells import (  # noqa: F401
    assign_cells,
    gather_cell_flags,
)
from spatialflink_tpu_torch.ops.polygon import (  # noqa: F401
    point_polygon_distance,
    points_in_polygon,
)
from spatialflink_tpu_torch.ops.range import range_query_kernel  # noqa: F401
from spatialflink_tpu_torch.ops.knn import knn_kernel  # noqa: F401
from spatialflink_tpu_torch.ops.join import cross_join_kernel  # noqa: F401
