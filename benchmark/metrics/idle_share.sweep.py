"""The traced window's time with no device operation running, over the window, %."""
from benchmark.harness import readers


def read(facts):
    return readers.idle_share(facts)
