"""Data, tensor and sample parallelism over ``torch.distributed``.  Port of
``vaeunet_tpu/parallel`` (one process per device; ``launch`` starts them)."""

from vaeunet_tpu_torch.parallel.dp import make_dp_train_step, train_model_dp
from vaeunet_tpu_torch.parallel.mesh import ParallelContext, launch, make_mesh, shard_batch

__all__ = ["make_mesh", "shard_batch", "make_dp_train_step", "train_model_dp",
           "ParallelContext", "launch"]
