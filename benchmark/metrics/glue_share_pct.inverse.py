"""Share of the window's device time in kernels that are not the port's
hand-written ones: the wavefront's sort and glue, the facade's and the
optimizer's torch ops, copies."""
from benchmark.readers import glue_share as read  # noqa: F401
