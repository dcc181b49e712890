"""Data and graph parallelism over `torch.distributed`: one process per
rank of a ('data', 'graph') mesh (counterparts of `matten_tpu/parallel/`)."""

from matten_tpu_torch.parallel.sharding import Mesh, make_mesh, shard_batch

__all__ = ["Mesh", "make_mesh", "shard_batch"]
