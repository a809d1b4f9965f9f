"""Pool layer (``chain/bls/device_pool.py``): real sets per job, the mean
over the ``encode_job`` calls that started in the window (spans)."""
from portbench.metrics._layers import sets_per_job as read  # noqa: F401
