"""Device operations in the traced window per reverse step run (the Recorder's copies included)."""
from benchmark.harness import readers


def read(facts):
    return readers.device_ops_per(facts, readers.steps_run(facts))
