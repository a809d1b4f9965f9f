"""Device programs (``verify.py`` ``hashed``, replayed by ``aot/graphs.py``):
the mean card milliseconds between CUDA events around ``execute_batch``."""
from portbench.metrics._layers import replay_ms as read  # noqa: F401
