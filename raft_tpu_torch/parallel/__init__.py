"""Read sharding over several devices (``mesh``) and multi-host runs
(``distributed``, which imports ``torch.distributed`` only when a run
starts)."""

from raft_tpu_torch.parallel.distributed import run_distributed
from raft_tpu_torch.parallel.mesh import (make_devices, shard_bucket,
                                          sharded_device_step)

__all__ = ["make_devices", "run_distributed", "shard_bucket",
           "sharded_device_step"]
