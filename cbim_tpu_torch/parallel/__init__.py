"""Data parallelism (counterpart of ``cbim_tpu/parallel``): one process per
GPU under ``torchrun``, the global batch's loss and BatchNorm statistics
summed across the ranks."""

from .collectives import all_gather_rows, all_reduce_sum  # noqa: F401
from .mesh import (Mesh, batch_rows, initialize_distributed,  # noqa: F401
                   make_mesh, shard_batch)
