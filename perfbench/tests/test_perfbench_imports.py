"""Nothing the benchmark or its reference loads has ``jax``, ``jaxlib``,
``flax`` or ``raft_tpu`` as its top-level name (``raft_tpu_torch`` is
another name), and the reference loads nothing of the program."""

import os
import subprocess
import sys

from perfbench import harness

CODE = """
import sys, glob, os
{imports}
for p in sorted(glob.glob(os.path.join({root!r}, "perfbench", "metrics",
                                       "*.py"))):
    harness.metric_reader(os.path.basename(p)[:-3])
top = {{m.split(".")[0] for m in sys.modules}}
print(" ".join(sorted(top)))
"""


def top_level(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(imports=imports,
                                           root=harness.ROOT)],
        cwd=harness.ROOT, capture_output=True, text=True, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return set(out.stdout.split())


def test_benchmark_loads_no_jax():
    top = top_level("from perfbench import harness, run, control, devtrace\n"
                    "from raft_tpu_torch import pipeline\n"
                    "harness.program_pass('cpu')")
    assert "raft_tpu_torch" in top and "torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = top_level("from perfbench import harness, reference, gen")
    assert not top & (set(harness.FORBIDDEN) | {"raft_tpu_torch", "torch"})
