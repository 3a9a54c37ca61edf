"""Share of the traced window in which the device runs nothing."""
from benchmark.readers import device_idle as read  # noqa: F401
