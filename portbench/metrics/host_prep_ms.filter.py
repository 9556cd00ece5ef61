"""Mean time from a traced call's start to the host's first launch or copy of
its device work: the entry point's host prep, in ms."""

from portbench.readers import host_prep_ms as read  # noqa: F401
