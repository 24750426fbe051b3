"""The object model and the padded batches that cross to the device."""

from spatialflink_tpu_torch.models.objects import (  # noqa: F401
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.models.batch import (  # noqa: F401
    GeometryBatch,
    PointBatch,
)
