"""
Data parallelism over a torch.distributed process group (counterpart of
foldingdiff_tpu/parallel/mesh.py).

The reference trains with Lightning DDP, one process per GPU (reference
bin/train.py:469-476); the JAX package shards the batch axis of a 1-D device
mesh and lets GSPMD insert the gradient psum. Here a `Mesh` is one process
group: every rank holds the same parameters, a batch is split by rows, and
the trainers sum the gradients over the group themselves (training/
trainer.py: optimizer_step). What GSPMD gave the JAX package for free is
built here and held by the tests: a run over N ranks computes what a run on
one device computes.

- `shard_batch` zero-pads dim 0 to a multiple of the group's size and returns
  this rank's rows. As in JAX, the padding is loss-exact: a padded row has
  attn_mask 0 and length 0, so every masked loss (whose denominator the
  trainers sum over the group) and the sampler's output rows, which the
  callers trim, are unchanged.
- `replicate` broadcasts a module's parameters and buffers (or tensors) from
  the group's rank 0.
- `gather_to_primary` gathers picklable host objects (sampled arrays) to
  rank 0, on the host: gloo has no CUDA gather. `all_gather_rows` assembles
  a batch split by rows on every rank through an all-reduce, the one
  collective besides broadcast that gloo runs on CUDA tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

NamedParams = Sequence[Tuple[str, torch.nn.Parameter]]


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data axis: a process group (None: the default group), this
    process's rank in it, its size, and the group's rank 0 as a global rank.
    make_mesh() makes one from the group that is up; one made by hand with
    no group is a rank's view for splitting batches, without collectives."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    root: int = 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n rows zero-padded to a multiple of the size."""
        per = pad_to_multiple(n, self.size) // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in place; returns the tensor."""
        if self.size > 1:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def reduce_gradients(self, named: NamedParams) -> None:
        """Each gradient summed over the group, in one all-reduce. Each rank's
        loss is its share of the global batch's loss (the trainers divide by
        the global counts), so the sum is the global batch's gradient."""
        _all_reduce_coalesced([p.grad for _, p in named], self)

    def sum_over_shards(self, values: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        """The sum of per-parameter values (squared norms, L1 sums) over the
        whole model: every parameter is replicated on a data axis, so this
        rank's sum."""
        return values.sum()


def _all_reduce_coalesced(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the mesh's group in place, through one flat buffer."""
    if mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def make_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The 1-D data-parallel mesh over `group` (default: every rank). Raises
    when no process group is up."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: call parallel.multihost.initialize() first")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                dist.get_global_rank(group, 0) if group is not None else 0)


def _rows(mesh: Mesh, a):
    n = a.shape[0]
    target = pad_to_multiple(n, mesh.size)
    if target != n:
        if torch.is_tensor(a):
            a = torch.cat([a, a.new_zeros((target - n, *a.shape[1:]))])
        else:
            a = np.concatenate([np.asarray(a), np.zeros((target - n,) + a.shape[1:], dtype=np.asarray(a).dtype)])
    return a[mesh.rows(n)]


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each array (numpy or torch), dim 0 zero-padded to
    a multiple of the mesh's size first. All arrays share dim 0. Returns one
    array, or a tuple of them."""
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays):
        raise ValueError(f"batch dims differ: {[a.shape[0] for a in arrays]}")
    out = tuple(_rows(mesh, a) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, module_or_tensors):
    """Broadcast from the group's rank 0, in place: every parameter and
    buffer of a module, or each tensor of a sequence. Returns its argument."""
    if mesh.size == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=mesh.root, group=mesh.group)
    return module_or_tensors


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """The group's rank 0's picklable object, on every rank (CPU tensors inside)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.root, group=mesh.group)
    return box[0]


def gather_to_primary(mesh: Mesh, obj: Any) -> Optional[List[Any]]:
    """Every rank's picklable object, in rank order, on the group's rank 0;
    None on the others."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=mesh.root, group=mesh.group)
    return out


def all_gather_rows(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of the batch whose shard_batch rows each rank holds
    as `local`, on every rank."""
    if mesh.size == 1:
        return local[:n]
    full = local.new_zeros((local.shape[0] * mesh.size, *local.shape[1:]))
    full[mesh.rows(n)] = local
    return mesh.all_reduce(full)[:n]
