"""Device: the share of the window in which the card ran no program of
the pool, 100 x (1 - the event-timed device calls / the window)."""
from portbench.metrics._layers import idle_pct as read  # noqa: F401
