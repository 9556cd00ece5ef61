"""Mean time from the end of a traced call's last CUDA call on the host to
the call's end: the length replay and post-processing, in ms."""

from portbench.readers import host_tail_ms as read  # noqa: F401
