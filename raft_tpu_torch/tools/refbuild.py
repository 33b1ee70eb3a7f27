"""Mirrors raft_tpu/tools/refbuild.py: the single shared recipe for
compiling the reference oracle binary (framework-free, copied unchanged
apart from this paragraph and ``REF_DIR``, which names the reference
source tree as ``~/reference``: the original's path for a root user).

The g++ invocation used to live in three places (bench.py,
tools/bench_scale.py, tests/conftest.py); a flag drift between them
would make one harness compare against a differently-built reference.
Everything now calls this.
"""

from __future__ import annotations

import os
import shutil
import subprocess

REF_DIR = os.path.join(os.path.expanduser("~"), "reference")


def build_reference(out_dir: str, name: str = "raft_ref") -> str | None:
    """Compile the reference into ``out_dir/name`` (cached: returns the
    existing binary if present). None when g++ or the source tree is
    unavailable."""
    out = os.path.join(out_dir, name)
    if os.path.exists(out):
        return out
    if not shutil.which("g++") or not os.path.exists(REF_DIR):
        return None
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run(
        ["g++", "-O3", "-std=c++14", "-I", REF_DIR,
         os.path.join(REF_DIR, "main.cpp"), "-lz", "-o", out],
        capture_output=True)
    return out if res.returncode == 0 else None
