"""Host helpers: interning, bucketed padding, CRS transforms."""

from spatialflink_tpu_torch.utils.interning import Interner  # noqa: F401
from spatialflink_tpu_torch.utils.padding import (  # noqa: F401
    next_bucket,
    pad_to_bucket,
)
