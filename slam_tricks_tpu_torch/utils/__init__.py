"""Observability + misc utilities (logger/timer roles of the reference's
'artwork' library and st16 logger subsystem); port of
``slam_tricks_tpu/utils``. ``checkpoint`` and ``io`` are imported by name."""

from slam_tricks_tpu_torch.utils import datasets  # noqa: F401
from slam_tricks_tpu_torch.utils.logging import get_logger, log_var  # noqa: F401
from slam_tricks_tpu_torch.utils.timer import Timer, time_fn, timed  # noqa: F401
