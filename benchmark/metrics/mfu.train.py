"""Three times the forward's GEMM FLOPs at each crop's own length over the window and the dense TF32 peak, %."""
from benchmark.harness import readers


def read(facts):
    return readers.mfu(facts)
