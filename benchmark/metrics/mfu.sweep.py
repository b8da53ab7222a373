"""The model's GEMM FLOPs at each backbone's own length over the window and the dense TF32 peak, %."""
from benchmark.harness import readers


def read(facts):
    return readers.mfu(facts)
