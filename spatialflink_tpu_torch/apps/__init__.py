"""The CheckIn and StayTime applications."""

from spatialflink_tpu_torch.apps.checkin import (  # noqa: F401
    CheckInEvent,
    check_in_query,
)
from spatialflink_tpu_torch.apps.staytime import (  # noqa: F401
    cell_sensor_range_intersection,
    cell_stay_time,
    normalized_cell_stay_time,
)
