from spatialflink_tpu_torch.operators.query_config import (  # noqa: F401
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.operators.knn_query import (  # noqa: F401
    KnnWindowResult,
    LineStringLineStringKNNQuery,
    LineStringPointKNNQuery,
    LineStringPolygonKNNQuery,
    MultiKnnWindowResult,
    PointLineStringKNNQuery,
    PointPointKNNQuery,
    PointPolygonKNNQuery,
    PolygonLineStringKNNQuery,
    PolygonPointKNNQuery,
    PolygonPolygonKNNQuery,
)
from spatialflink_tpu_torch.operators.join_query import (  # noqa: F401
    JoinWindowResult,
    LineStringLineStringJoinQuery,
    LineStringPointJoinQuery,
    LineStringPolygonJoinQuery,
    PointLineStringJoinQuery,
    PointPointJoinQuery,
    PointPolygonJoinQuery,
    PolygonLineStringJoinQuery,
    PolygonPointJoinQuery,
    PolygonPolygonJoinQuery,
)
from spatialflink_tpu_torch.operators.range_query import (  # noqa: F401
    LineStringLineStringRangeQuery,
    LineStringPointRangeQuery,
    LineStringPolygonRangeQuery,
    PointLineStringRangeQuery,
    PointPointRangeQuery,
    PointPolygonRangeQuery,
    PolygonLineStringRangeQuery,
    PolygonPointRangeQuery,
    PolygonPolygonRangeQuery,
    RangeResult,
)
