"""
Megatron tensor parallelism over a 2-D (data, model) set of process groups
(counterpart of foldingdiff_tpu/parallel/tp.py).

Layout, as the JAX package's spec rules (tp.py:34-52) give it:
- column parallel (each model rank holds a slice of the OUTPUT features):
  attention.self.{query,key,value} and intermediate.dense, weights and
  biases; so each model rank runs its H / n_model local heads (the v2
  kernel launches over those);
- row parallel (a slice of the INPUT features): attention.output.dense and
  output.dense; the partial products are summed over the model axis and the
  bias, replicated, is added once after the sum;
- everything else is replicated.

The JAX package let GSPMD insert the collectives. Here they are written out
as two autograd Functions (Megatron's f and g), on plain process groups:
f is the identity forward and sums the gradient over the model axis
backward, in front of each column-parallel layer; g sums over the model axis
forward and is the identity backward, after each row-parallel layer. What
GSPMD also hid is done by the mesh that the trainer holds
(Mesh2D.reduce_gradients, sum_over_shards): the distance table is replicated
but read by the local heads only, so its gradient is summed over the model
axis; the global-norm clip and the L1 penalty sum the sharded tensors' parts
over the model axis and count the replicated ones once; the Adam moments
shard with their parameters (shard_train_state).

Ranks form the (n_data, n_model) grid row by row, as JAX's make_mesh_2d
reshapes its devices: rank = d * n_model + m.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from foldingdiff_tpu_torch import precision
from foldingdiff_tpu_torch.parallel.mesh import (
    Mesh, NamedParams, _all_reduce_coalesced, all_gather_rows, make_mesh, replicate, shard_batch,
)

_COLUMN = re.compile(r"(attention\.self\.(query|key|value)|intermediate\.dense)\.(weight|bias)$")
_ROW = re.compile(r"(attention\.output|layer\.\d+\.output)\.dense\.weight$")
_PARTIAL = re.compile(r"attention\.self\.distance_embedding\.weight$")


def spec_for(name: str) -> Tuple:
    """The sharding of a state-dict entry over the model axis, as a
    PartitionSpec-like tuple over torch's layout (a Linear weight is
    (out, in), the transpose of a flax kernel): ("model", None) for a
    column-parallel weight, ("model",) for its bias, (None, "model") for a
    row-parallel weight, () for a replicated tensor."""
    if _COLUMN.search(name):
        return ("model", None) if name.endswith("weight") else ("model",)
    if _ROW.search(name):
        return (None, "model")
    return ()


def shard_tensor(full: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a full tensor under `spec`."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            if full.shape[dim] % mesh.size:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over a model axis of {mesh.size}")
            return full.chunk(mesh.size, dim)[mesh.rank]
    return full


def unshard(local: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    """The full tensor of which each model rank holds its shard_tensor slice."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            shape = list(local.shape)
            shape[dim] *= mesh.size
            full = local.new_zeros(shape)
            full.narrow(dim, mesh.rank * local.shape[dim], local.shape[dim]).copy_(local)
            return mesh.all_reduce(full)
    return local


class Mesh2D:
    """The (data, model) axes over every rank: `data` and `model` are the 1-D
    meshes through this rank. It splits batches over the data axis as a 1-D
    Mesh does, so a trainer takes it in place of one."""

    def __init__(self, n_data: int, n_model: int) -> None:
        if not dist.is_initialized():
            raise RuntimeError("no process group is up: call parallel.multihost.initialize() first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data * n_model != world:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, the group has {world}")
        self.shape = (n_data, n_model)
        # every rank makes every group, in the same order
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                self.model = make_mesh(group)
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                self.data = make_mesh(group)
        self.size, self.rank = self.data.size, self.data.rank

    def rows(self, n: int) -> slice:
        return self.data.rows(n)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the data axis (the loss's counts and terms)."""
        return self.data.all_reduce(tensor)

    def reduce_gradients(self, named: NamedParams) -> None:
        """Every gradient summed over the data axis; the distance table's,
        which each model rank's local heads fill in part, also over the
        model axis."""
        self.data.reduce_gradients(named)
        _all_reduce_coalesced([p.grad for n, p in named if _PARTIAL.search(n)], self.model)

    def sum_over_shards(self, values: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        """The sum of per-parameter values over the whole model: the sharded
        tensors' parts summed over the model axis, the replicated ones once."""
        sharded = torch.tensor([bool(spec_for(n)) for n in names], device=values.device)
        return values[~sharded].sum() + self.model.all_reduce(values[sharded].sum())


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    return Mesh2D(n_data, n_model)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model axis forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelLinear(nn.Module):
    """This model rank's output features of a Linear, behind f."""

    def __init__(self, full: precision.Linear, mesh: Mesh) -> None:
        super().__init__()
        self.mesh = mesh
        self.mode = full.mode
        self.weight = nn.Parameter(shard_tensor(full.weight.detach(), ("model", None), mesh).clone())
        self.bias = nn.Parameter(shard_tensor(full.bias.detach(), ("model",), mesh).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.linear(_CopyToModel.apply(x, self.mesh), self.weight, self.bias, self.mode)


class RowParallelLinear(nn.Module):
    """This model rank's input features of a Linear: its partial product
    summed over the model axis by g, then rounded once as the mode rounds a
    product's output (f16 or bf16 under "f16f16" and "bf16bf16"), so that
    the sum is read as one device reads it, then the full bias, added once."""

    def __init__(self, full: precision.Linear, mesh: Mesh) -> None:
        super().__init__()
        self.mesh = mesh
        self.mode = full.mode
        self.weight = nn.Parameter(shard_tensor(full.weight.detach(), (None, "model"), mesh).clone())
        self.bias = nn.Parameter(full.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = precision.linear(x, self.weight, None, self.mode, rounded=False)
        return precision.round_output(_ReduceFromModel.apply(partial, self.mesh), self.mode) + self.bias


def shard_params(model: nn.Module, mesh: Mesh2D) -> nn.Module:
    """Turn a denoiser (or the AR model) into this rank's tensor-parallel
    part, in place, and return it: the full weights are first broadcast from
    rank 0, then each layer's dense layers are cut by spec_for and each
    attention keeps its local heads. Raises, before changing anything, when
    the model axis does not divide the head count or the FFN width."""
    n = mesh.model.size
    config = model.config
    if config.num_attention_heads % n or config.intermediate_size % n:
        raise ValueError(f"{config.num_attention_heads} attention heads and an FFN of {config.intermediate_size} "
                         f"must both split over a model axis of {n}")
    replicate(make_mesh(), model)
    for layer in model.encoder.layer:
        attention = layer.attention.self
        for name in ("query", "key", "value"):
            setattr(attention, name, ColumnParallelLinear(getattr(attention, name), mesh.model))
        attention.n_heads //= n
        layer.intermediate.dense = ColumnParallelLinear(layer.intermediate.dense, mesh.model)
        layer.attention.output.dense = RowParallelLinear(layer.attention.output.dense, mesh.model)
        layer.output.dense = RowParallelLinear(layer.output.dense, mesh.model)
    return model


def full_state_dict(model: nn.Module, mesh: Mesh2D) -> Dict[str, torch.Tensor]:
    """The unsharded state dict of a shard_params model, on every rank."""
    return {name: unshard(t.detach(), spec_for(name), mesh.model) for name, t in model.state_dict().items()}


class TPRunner:
    """A tensor-parallel forward in eval mode: the model is sharded once,
    here; each call splits the batch over the data axis and returns the
    whole batch's output on every rank."""

    def __init__(self, model: nn.Module, mesh: Mesh2D) -> None:
        self.mesh = mesh
        self.model = shard_params(model, mesh).eval()

    def __call__(self, inputs: torch.Tensor, timestep: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        n = inputs.shape[0]
        with torch.inference_mode():
            out = self.model(*shard_batch(self.mesh.data, inputs, timestep, attention_mask))
            return all_gather_rows(self.mesh.data, out, n)


def shard_train_state(trainer, mesh: Mesh2D):
    """Shard a Trainer's model and Adam moments (those it has) over the mesh,
    in place, and hand it the mesh; returns the trainer. Every rank must hold
    the same trainer. The trainer then steps on the tensor-parallel model
    (tp_train_step); fit, checkpoints and model directories take a 1-D mesh."""
    from foldingdiff_tpu_torch.training.trainer import build_optimizer

    old = trainer.optimizer
    moments = {name: old.state[p] for name, p in trainer.model.named_parameters() if p in old.state}
    shard_params(trainer.model, mesh)
    trainer.optimizer = build_optimizer(trainer.cfg, trainer.model.parameters())
    for name, p in trainer.model.named_parameters():
        if name in moments:
            spec = spec_for(name)
            trainer.optimizer.state[p] = {k: shard_tensor(v, spec, mesh.model).clone() if v.dim() else v.clone()
                                          for k, v in moments[name].items()}
    trainer.mesh = mesh
    return trainer


def tp_train_step(trainer, batch, t=None, noise=None):
    """One tensor-parallel train step of a shard_train_state trainer: the
    global device batch split over the data axis, forward and backward over
    the model axis, the clipped AdamW update of each rank's shards. Returns
    train_step's (loss, per-feature terms) of the global batch."""
    if not isinstance(trainer.mesh, Mesh2D):
        raise ValueError("the trainer holds no (data, model) mesh: call shard_train_state first")
    return trainer.train_step(batch, t, noise)
