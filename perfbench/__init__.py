"""The benchmark of raft_tpu_torch: harness, traffic generator, plain
reference, metric readers. See ``perfbench/run.py``."""
