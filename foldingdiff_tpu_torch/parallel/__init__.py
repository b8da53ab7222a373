"""Data and tensor parallelism on torch.distributed (counterpart of foldingdiff_tpu/parallel/)."""
from foldingdiff_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_to_primary,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
