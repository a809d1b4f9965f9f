"""Tower / curve / field (``tower.py``, ``curve.py``, ``fp_kernels.add_mod``
and ``sub_mod``): card milliseconds per profiled replay of every kernel
that is not one of the hand-written K1-K3."""
from portbench.metrics._layers import elementwise_ms as read  # noqa: F401
