"""The SNCB railway domain: event types, CRS enrichment, buffered zones
(the zone test on the card), Q1–Q5, MN_Q1–Q5 and their runners."""

from spatialflink_tpu_torch.sncb.common import (  # noqa: F401
    GpsEvent,
    EnrichedEvent,
    CRSUtils,
    BufferedZone,
    PolygonLoader,
    csv_to_gps_event,
    gps_events_to_points,
)
