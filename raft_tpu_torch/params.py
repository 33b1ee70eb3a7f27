"""Algorithm parameters for the RAFT-TPU pipeline.

raft_tpu_torch's copy of ``raft_tpu/params.py``, unchanged apart from
its import paths.

Mirrors the reference parameter block (``/root/reference/param.hpp:4-44``)
including all defaults. The dataclass is frozen and hashable so it can be
used as a static argument to ``jax.jit``.

Reference quirks that are part of the public surface (see
``/root/reference/main.cpp:28-59``):

* ``-p`` sets BOTH ``repeat_length`` and ``interval_length``.
* ``-v`` falls through into ``-o`` in the reference getopt loop (missing
  ``break``), so ``-v 500`` also sets the output prefix to ``"500"`` unless a
  later ``-o`` overrides it. The CLI reproduces this in ``--compat-getopt``
  mode (the default, for drop-in parity) — see ``raft_tpu/cli.py``.
* ``-i`` is accepted by the getopt string but has no case → help + exit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgoParams:
    """Static algorithm configuration (reference: ``param.hpp:4-31``)."""

    reso: int = 50                  # coverage window resolution (bp)
    est_cov: int = 0                # estimated coverage (-e, required > 0)
    cov_mul: float = 1.5            # high-coverage multiplier (-m)
    repeat_length: int = 10000      # min repeat run length to preserve (-p)
    interval_length: int = 10000    # cut-marker spacing (-p couples both)
    read_length: int = 20000        # target fragment length (-l)
    overlap_length: int = 500       # overlap between consecutive frags (-v)
    flanking_length: int = 1000     # repeat flank expansion (-f)
    outputfilename: str = "raft"    # output prefix (-o)
    real_reads: bool = True         # auto-detected from header regex
    symmetric_overlaps: bool = False  # auto-detected from PAF record-0 mirror

    @property
    def high_cov(self) -> int:
        """Coverage threshold, with the reference's int truncation
        (``repeat.hpp:90``: ``int high_cov = cov_est * param.cov_mul``)."""
        return int(self.est_cov * self.cov_mul)

    @property
    def div(self) -> int:
        """Markers consumed per fragment (``chop.hpp:248``)."""
        return self.read_length // self.interval_length

    def validate(self) -> None:
        if self.est_cov <= 0:
            raise ValueError(
                "estimated coverage (-e) must be set and > 0 "
                f"(got {self.est_cov})")
        if self.reso <= 0:
            raise ValueError(f"resolution (-r) must be > 0 (got {self.reso})")
        if self.interval_length <= 0:
            raise ValueError(
                f"interval length (-p) must be > 0 (got {self.interval_length})")
        if self.div < 1:
            # The reference divides by `div` (chop.hpp:270) — div==0 is UB
            # (read_length < interval_length). We reject it up front.
            raise ValueError(
                "read_length (-l) must be >= interval_length (-p): "
                f"got -l {self.read_length} < -p {self.interval_length}")
        if self.overlap_length < 0 or self.flanking_length < 0:
            raise ValueError("overlap (-v) and flanking (-f) must be >= 0")
        if self.overlap_length > self.interval_length:
            # Reference UB: fragment j>=2 starts at marker - overlap
            # (chop.hpp:318 ``read_seq.substr(final_stars[pos] -
            # overlap_length, ...)``); markers are multiples of
            # interval_length, so overlap > interval underflows size_t
            # and the reference dies with std::out_of_range on any
            # fragmented read (found by differential fuzzing, seed 105).
            # We reject the parameter combination up front instead.
            raise ValueError(
                "overlap_length (-v) must be <= interval_length (-p): "
                f"got -v {self.overlap_length} > -p {self.interval_length} "
                "(the reference crashes on any read that fragments under "
                "these parameters)")

    def replace(self, **kw) -> "AlgoParams":
        return dataclasses.replace(self, **kw)

    def info_lines(self) -> list[str]:
        """The INFO lines the reference prints (``param.hpp:33-43``)."""
        cm = f"{self.cov_mul:g}"
        return [
            f"INFO, printParams(), reso = {self.reso}",
            f"INFO, printParams(), est_cov = {self.est_cov}",
            f"INFO, printParams(), cov_mul = {cm}",
            f"INFO, printParams(), repeat_length = {self.repeat_length}",
            f"INFO, printParams(), interval_length = {self.interval_length}",
            f"INFO, printParams(), read_length = {self.read_length}",
            f"INFO, printParams(), overlap_length = {self.overlap_length}",
            f"INFO, printParams(), flanking_length = {self.flanking_length}",
        ]
