"""A primer panel screened against the resident reference: needles x
reference bytes of every call completed in the window, over its seconds,
in GB/s."""

from portbench.readers import scan_GB_per_s as read  # noqa: F401
