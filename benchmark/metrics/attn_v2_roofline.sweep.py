"""The v2 attention kernel's share of its roofline over the sweep's calls, %."""
from benchmark.harness import readers


def read(facts):
    return readers.attention_roofline(facts)
