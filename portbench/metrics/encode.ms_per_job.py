"""Host encode (``verify.encode_job``, ``h2c.encode_field_draws``): the
mean host-clock milliseconds of an ``encode_job`` call in the window."""
from portbench.metrics._layers import encode_ms_per_job as read  # noqa: F401
