"""The host control plane: windows, sources, serde and the SoA and wire
ingest paths. The JAX package's sinks wait for ROADMAP A11.2
(``spatialflink_tpu_torch.NOT_EXPORTED``)."""

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
