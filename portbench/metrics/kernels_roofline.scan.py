"""The share of their roofline of the long-read cell's traced calls:
the function's least time by the frozen cost model over the device time of
all the calls' kernels, in %."""

from portbench.readers import kernels_roofline as read  # noqa: F401
