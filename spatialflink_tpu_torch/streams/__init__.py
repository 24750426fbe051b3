"""The host control plane: windows, sources, sinks, serde and the SoA and
wire ingest paths."""

from spatialflink_tpu_torch.streams.windows import (  # noqa: F401
    CountWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
    WindowAssembler,
    WindowBatch,
)
from spatialflink_tpu_torch.streams.sources import (  # noqa: F401
    SyntheticGpsSource,
    collection_source,
    csv_source,
    socket_source,
)
from spatialflink_tpu_torch.streams.sinks import (  # noqa: F401
    CollectSink,
    CsvFileSink,
    LatencySink,
    MultiSink,
    PrintSink,
    TransactionalFileSink,
)
