"""Debug, counters and tracing utilities."""

from .debug import qz_log, qz_error, Counters, get_counters  # noqa: F401
from .trace import qz_trace, stage, maybe_trace_from_env  # noqa: F401
