"""spatialflink_tpu_torch — the PyTorch/CUDA port of spatialflink_tpu.

The JAX package ``spatialflink_tpu`` is the reference; this package runs
the same operators in PyTorch, with the TPU kernels rewritten by hand in
CUDA for Hopper (``kernels/csrc``). Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead. The package imports nothing of JAX.

Each package re-exports the names its JAX counterpart's ``__init__``
exports, at the same path; ``NOT_EXPORTED`` lists the ones it does not,
each with the ROADMAP item it waits for or why it is absent.
"""

__version__ = "0.1.0"

#: Names a JAX package ``__init__`` exports that the port's package at
#: the same path (relative to the top; "" is the top) does not, with the
#: ROADMAP item each waits for or the reason it is absent. ``"*"`` stands
#: for a whole package.
NOT_EXPORTED = {
    "": {"runtime": "no counterpart: it configures the JAX compile cache"},
    "ops": {"join_kernel": "deliberately absent: the XLA gather join, "
                           "which the hand kernel B3 replaces on the card; "
                           "ops.join_kernel is the module of B3's wrapper"},
}

from spatialflink_tpu_torch.grid import UniformGrid  # noqa: E402,F401
from spatialflink_tpu_torch.models.objects import (  # noqa: E402,F401
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.models.batch import (  # noqa: E402,F401
    GeometryBatch,
    PointBatch,
)
from spatialflink_tpu_torch.driver import (  # noqa: F401
    RetryPolicy,
    WindowedDataflowDriver,
    strict_driver,
)
