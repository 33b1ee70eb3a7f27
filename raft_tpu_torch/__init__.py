"""raft_tpu_torch — the RAFT read fragmenter on PyTorch and CUDA.

The port of ``raft_tpu`` from JAX on a TPU to PyTorch on an NVIDIA H100.
The device engine (``engine_torch``), the Hopper pileup kernel
(``ops/pileup_cuda.py``, ``csrc/pileup.cu``), the whole-file pipeline and
the CLI live here; the framework-free host layer (native I/O, bucketing,
emitters, parameters, the numpy oracle, the synthetic dataset generator)
is imported from ``raft_tpu``. Nothing here imports jax.
"""

from raft_tpu.params import AlgoParams
from raft_tpu.tools.benchgen import gen_dataset
from raft_tpu_torch.pipeline import run_pipeline

__all__ = ["AlgoParams", "gen_dataset", "run_pipeline"]
