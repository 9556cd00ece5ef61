"""Seconds from the run's start to its window: the card, the kernels
(built only by a checkout's first run), the inputs, one call at the
cell's shapes."""


def read(run):
    return run["setup_s"]
