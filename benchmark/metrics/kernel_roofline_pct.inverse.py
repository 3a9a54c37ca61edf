"""The hand-written kernels' least time over their device time."""
from benchmark.readers import kernel_roofline as read  # noqa: F401
