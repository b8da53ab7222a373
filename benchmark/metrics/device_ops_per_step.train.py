"""Device operations in the traced window per optimizer update."""
from benchmark.harness import readers


def read(facts):
    return readers.device_ops_per(facts, facts.get("updates", 0))
