"""MobilityNebula instrumentation: NES metrics, counting stages and sinks,
the NES stats reporter and the instrumented MN queries (``mn/queries.py``).
Host code; the instrumented Q5's fence test runs on the card."""

from spatialflink_tpu_torch.mn.metrics import (  # noqa: F401
    BUCKETS_MS,
    FixedBucketLatency,
    MetricNames,
    MetricRegistry,
)
from spatialflink_tpu_torch.mn.operators import (  # noqa: F401
    Stamped,
    CsvParseAndStamp,
    CountingStage,
)
from spatialflink_tpu_torch.mn.sinks import (  # noqa: F401
    CountingLatencyFileSink,
    CountingLatencyPrintSink,
)
from spatialflink_tpu_torch.mn.reporter import NESFileReporter  # noqa: F401
