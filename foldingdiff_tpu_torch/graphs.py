"""
CUDA graphs of the port's steps: the counterpart of the JAX package's jit,
under which a sample() chunk's reverse chain is one device execution
(foldingdiff_tpu/diffusion/sampling.py:152-156) and fused_steps dispatches K
train steps as one (foldingdiff_tpu/training/trainer.py:595-634).

A StepGraph wraps a body: a function without arguments that reads and
writes only tensors that outlive it (static buffers), and returns tensors.
Its first call runs the body once, eagerly, on a side stream (the warm-up:
it builds the kernels, makes cuBLAS's handles and the optimizer's state, and
it is that call's real work), then captures the body into a
torch.cuda.CUDAGraph without running it. Every later call replays the graph,
one launch from the host, and returns the captured outputs, which the next
replay overwrites: a caller copies out what it keeps. The body's kernels are
the ones the eager step launches, in the same order, so a replay gives the
bits the eager body gives.

Random draws: the default CUDA generator is registered by PyTorch itself;
every other torch.Generator the body draws from must be given as
`generators`, and is registered with the graph
(CUDAGraph.register_generator_state), so that each replay draws at the
generator's current offset and advances it as the eager draws would.

Launch accounting: the kernel wrappers (ops/attention.CudaLibrary.launch)
count on the host, so under capture they count once, for launches that do
not happen then. CapturedLaunches takes the capture's counts back and adds
them on every replay, so `REL_ATTENTION.launches` still counts the kernels
that ran on the card.

A StepGraph raises for a CPU device and when no card is present: there is no
fallback. The callers run their eager loops on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Sequence, Tuple

import torch

from foldingdiff_tpu_torch.ops import attention


class CapturedLaunches:
    """The launches counted during a capture, per library (an object with
    integer `launches` and `rel_off_launches`): taken back when the capture
    ends, since a capture runs nothing, and added on every replay."""

    def __init__(self, libraries: Sequence[Any] = attention.LIBRARIES):
        self.libraries = tuple(libraries)
        self.per_replay: List[Tuple[int, int]] = [(0, 0)] * len(self.libraries)

    def _counts(self) -> List[Tuple[int, int]]:
        return [(lib.launches, lib.rel_off_launches) for lib in self.libraries]

    def _add(self, times: int) -> None:
        for lib, (n, rel_off) in zip(self.libraries, self.per_replay):
            lib.launches += times * n
            lib.rel_off_launches += times * rel_off

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        before = self._counts()
        try:
            yield
        finally:
            self.per_replay = [(n - n0, r - r0) for (n, r), (n0, r0) in zip(self._counts(), before)]
            self._add(-1)

    def replayed(self) -> None:
        self._add(1)


class StepGraph:
    """
    body() eagerly on its first call, then as one captured CUDA graph (see
    the module docstring). `generators`: the non-default torch.Generators
    the body draws from. `pool`: a memory pool (torch.cuda.graph_pool_handle())
    shared by the graphs of one sampler or trainer, which replay one at a
    time on one stream.
    """

    def __init__(self, body: Callable[[], Any], device: torch.device | str,
                 generators: Sequence[torch.Generator] = (), pool=None,
                 libraries: Sequence[Any] = attention.LIBRARIES):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"StepGraph captures CUDA work, got device {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("StepGraph: no CUDA device is available")
        self.body = body
        self.device = device
        self.generators = tuple(generators)
        self.pool = pool
        self.launches = CapturedLaunches(libraries)
        self.graph = None
        self.outputs = None

    def __call__(self) -> Any:
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        self.launches.replayed()
        return self.outputs

    def _warm_up_and_capture(self) -> Any:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self.body()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        with self.launches.capturing(), torch.cuda.graph(graph, pool=self.pool):
            self.outputs = self.body()
        self.graph = graph
        return first
