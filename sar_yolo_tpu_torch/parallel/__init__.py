"""Data parallelism over several devices, one process each (port of `sar_yolo_tpu/parallel/`)."""

from sar_yolo_tpu_torch.parallel.mesh import (get_mesh, host_local_batch_to_global, init_distributed,
                                              model_mesh, process_shard, rank_and_world, replicate,
                                              shard_batch, spawn, sync_flag)

__all__ = ["get_mesh", "host_local_batch_to_global", "init_distributed", "model_mesh",
           "process_shard", "rank_and_world", "replicate", "shard_batch", "spawn", "sync_flag"]
