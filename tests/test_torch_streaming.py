"""The port's chunked streaming schedule and PAF spill against raft_tpu's
(JAX on the CPU) on the tests/datagen.py fixtures of
tests/test_streaming.py, with the same flags: the four output files must
be byte-equal, so the tolerance is exact equality."""

from __future__ import annotations

import os
import time

import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import emit  # noqa: E402
from raft_tpu import pipeline as tpu_pipeline  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu_torch import pipeline as port_pipeline  # noqa: E402

OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]


def _params(tmp, name):
    return AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                      interval_length=2000, read_length=4000,
                      flanking_length=300, overlap_length=200,
                      outputfilename=f"{tmp}/{name}")


def _port(reads, paf, tmp, name, **kw):
    return port_pipeline.run_pipeline(reads, paf, _params(tmp, name),
                                      device="cpu", verbose=False, **kw)


def _tpu(reads, paf, tmp, name, **kw):
    return tpu_pipeline.run_pipeline(reads, paf, _params(tmp, name),
                                     engine="jax", verbose=False, **kw)


def _assert_same_files(tmp_path, *names):
    for ext in OUTS:
        want = (tmp_path / f"{names[0]}{ext}").read_bytes()
        for nm in names[1:]:
            assert (tmp_path / f"{nm}{ext}").read_bytes() == want, (nm, ext)


@pytest.mark.parametrize("chunk", [1, 7, 29, 1000])
@pytest.mark.parametrize("simulated", [False, True])
def test_chunked_equals_whole(tmp_path, chunk, simulated):
    """Port chunked == port whole-file == raft_tpu chunked, and the stats
    say which schedule ran in how many chunks."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=888, tmpdir=tmp, n_reads=29,
                                       simulated=simulated)
    whole = _port(reads, paf, tmp, "whole")
    st = _port(reads, paf, tmp, "chunked", chunk_reads=chunk)
    _tpu(reads, paf, tmp, "tpu", chunk_reads=chunk)
    assert (whole.schedule, whole.n_chunks) == ("whole", 1)
    assert (st.schedule, st.n_chunks) == ("chunked", -(-29 // chunk))
    assert st.n_reads == 29 and st.n_fragments == whole.n_fragments
    assert len(st.buckets) >= st.n_chunks
    _assert_same_files(tmp_path, "tpu", "chunked", "whole")


@pytest.mark.parametrize("chunk", [1, 7, 1000])
@pytest.mark.parametrize("mode", ["real", "simulated", "symmetric"])
def test_spill_paf_equals_whole(tmp_path, chunk, mode):
    """--spill-paf streaming (native binned event spill): port spill ==
    port whole-file == raft_tpu spill."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=890, tmpdir=tmp, n_reads=29,
                                       simulated=mode == "simulated",
                                       symmetric=mode == "symmetric")
    _port(reads, paf, tmp, "whole")
    st = _port(reads, paf, tmp, "spill", chunk_reads=chunk, spill_paf=True)
    _tpu(reads, paf, tmp, "tpu", chunk_reads=chunk, spill_paf=True)
    assert st.n_reads == 29 and st.schedule == "chunked"
    _assert_same_files(tmp_path, "tpu", "spill", "whole")


def test_spill_strict_unknown_name_errors(tmp_path):
    """A PAF row naming a read absent from the FASTA raises in strict
    spill mode and is dropped with strict=False, as in raft_tpu."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=892, tmpdir=tmp, n_reads=6)
    with open(paf, "a") as f:
        f.write("ghost\t900\t10\t200\t+\tghost2\t900\t10\t200\t190\n")
    with pytest.raises(ValueError, match="absent from the input FASTA"):
        _port(reads, paf, tmp, "strictfail", chunk_reads=3, spill_paf=True)
    st = _port(reads, paf, tmp, "lax", chunk_reads=3, spill_paf=True,
               strict=False)
    _tpu(reads, paf, tmp, "tpu", chunk_reads=3, spill_paf=True, strict=False)
    assert st.n_reads == 6
    _assert_same_files(tmp_path, "tpu", "lax")


@pytest.mark.parametrize("chunk", [3, 1000])
@pytest.mark.parametrize("kind", ["gz", "fastq", "fastq_gz"])
def test_chunked_streams_gz_and_fastq(tmp_path, chunk, kind):
    """gz and FASTQ inputs stream (no whole-file fallback), byte-equal to
    the port's whole-file run and to raft_tpu's chunked run."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=889, tmpdir=tmp, n_reads=17,
                                       gz=kind.endswith("gz"),
                                       fastq=kind.startswith("fastq"))
    _port(reads, paf, tmp, "whole")
    st = _port(reads, paf, tmp, "chunked", chunk_reads=chunk)
    _tpu(reads, paf, tmp, "tpu", chunk_reads=chunk)
    assert st.n_reads == 17 and st.schedule == "chunked"
    _assert_same_files(tmp_path, "tpu", "chunked", "whole")


@pytest.mark.parametrize("cov_out", ["diff8", "cov"])
def test_chunked_cov_out_modes(tmp_path, cov_out):
    """In diff8/cov mode no coverage events reach the pipeline, so each
    chunk's .coverage.txt renders from its result."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=893, tmpdir=tmp, n_reads=23)
    _port(reads, paf, tmp, "port", chunk_reads=5, cov_out=cov_out)
    _tpu(reads, paf, tmp, "tpu", chunk_reads=5, cov_out=cov_out)
    _port(reads, paf, tmp, "host", chunk_reads=5)
    _assert_same_files(tmp_path, "tpu", "port", "host")


def test_auto_chunk_at_scale(tmp_path, monkeypatch):
    """chunk_reads=None streams when an input is over
    RAFT_AUTO_CHUNK_BYTES; chunk_reads=0 opts out; both byte-equal to
    raft_tpu's auto-streamed run."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=901, tmpdir=tmp, n_reads=29)
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")  # everything is big
    st = _port(reads, paf, tmp, "auto")
    assert (st.schedule, st.n_chunks) == ("chunked", 1)  # 29 < 32768
    st0 = _port(reads, paf, tmp, "forced", chunk_reads=0)
    assert st0.schedule == "whole"
    _tpu(reads, paf, tmp, "tpu")
    _assert_same_files(tmp_path, "tpu", "auto", "forced")
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "0")  # gate off
    assert _port(reads, paf, tmp, "off").schedule == "whole"


def test_auto_chunk_respects_engine_and_io_choice(tmp_path, monkeypatch):
    """Under a gate every input passes, --engine oracle and
    --pure-python-io runs stay whole-file; a torch run with native I/O
    streams. An explicit chunk size with the oracle engine is refused."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=903, tmpdir=tmp, n_reads=17)
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    called = []
    orig = port_pipeline._run_pipeline_chunked

    def spy(*a, **kw):
        called.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(port_pipeline, "_run_pipeline_chunked", spy)
    st = _port(reads, paf, tmp, "orc", engine="oracle")
    assert not called and st.schedule == "whole"
    st = _port(reads, paf, tmp, "pp", use_native=False)
    assert not called and st.schedule == "whole" and not st.native_io
    st = _port(reads, paf, tmp, "tc")
    assert called and st.schedule == "chunked"
    _assert_same_files(tmp_path, "tc", "orc", "pp")
    with pytest.raises(ValueError, match="torch engine"):
        _port(reads, paf, tmp, "x", engine="oracle", chunk_reads=5)


@pytest.mark.parametrize("kw", [{"chunk_reads": 0}, {"chunk_reads": 7},
                                {"chunk_reads": 7, "spill_paf": True}],
                         ids=["whole", "chunked", "spill"])
def test_on_bucket_sees_every_bucket(tmp_path, kw):
    """run_pipeline's on_bucket sees the device inputs of every bucket the
    stats record, in run order across chunks, and changes no output."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=904, tmpdir=tmp, n_reads=23)
    seen = []
    st = _port(reads, paf, tmp, "hooked", **kw,
               on_bucket=lambda cfg, lens, off, pk: seen.append(
                   (cfg.B, cfg.W, cfg.E, len(lens), len(off))))
    assert [s[:3] for s in seen] == st.buckets and seen
    assert all(nl == cfg_b and no == cfg_b + 1
               for cfg_b, _, _, nl, no in seen)
    _port(reads, paf, tmp, "plain", **kw)
    _assert_same_files(tmp_path, "plain", "hooked")


def test_chunk_trace_records(tmp_path, monkeypatch):
    """RAFT_CHUNK_TRACE: one record per chunk with the fields of
    raft_tpu's tracer plus a summary line; the traced run's outputs equal
    an untraced one's."""
    import json
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=5, tmpdir=tmp, n_reads=23)
    trace = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("RAFT_CHUNK_TRACE", trace)
    st = _port(reads, paf, tmp, "tr", chunk_reads=7)
    monkeypatch.delenv("RAFT_CHUNK_TRACE")
    _port(reads, paf, tmp, "un", chunk_reads=7)
    _assert_same_files(tmp_path, "un", "tr")
    recs = [json.loads(line) for line in open(trace)]
    tail = recs.pop()
    assert tail["n_chunks"] == len(recs) == st.n_chunks == 4
    assert tail["chunk_reads"] == 7 and tail["spill_paf"] is False
    assert set(tail["stage_seconds"]) == set(st.stage_seconds)
    for r in recs:
        for k in ("ci", "lo", "hi", "wait_load_s", "drain_s",
                  "compute_s", "compute_span", "engine", "n_events",
                  "load_read_s", "load_events_s", "load_span",
                  "emit_fasta_s", "emit_lr_s", "emit_bed_s", "emit_cov_s"):
            assert k in r, (k, r)
        assert {"bucket_prep", "h2d", "step", "integrate"} <= set(r["engine"])


def test_chunked_mid_emit_failure_tears_down(tmp_path, monkeypatch, capsys):
    """A mid-run emit failure in the streaming schedule raises, shuts the
    worker pools down promptly and names the partial outputs on stderr."""
    tmp = str(tmp_path)
    datagen.standard_case(seed=52, tmpdir=tmp, n_reads=41)
    params = AlgoParams(est_cov=5, repeat_length=2000,
                        interval_length=2000, read_length=4000,
                        overlap_length=200, flanking_length=300,
                        outputfilename=os.path.join(tmp, "out"))
    calls = {"n": 0}
    real = emit.write_long_repeats

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:  # second chunk: simulate an I/O failure
            raise OSError(28, "No space left on device")
        return real(*a, **k)

    monkeypatch.setattr(emit, "write_long_repeats", boom)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        port_pipeline.run_pipeline(f"{tmp}/reads.fasta",
                                   f"{tmp}/overlaps.paf", params,
                                   chunk_reads=7, verbose=False,
                                   device="cpu")
    assert time.monotonic() - t0 < 60  # pools drained, no hang
    err = capsys.readouterr().err
    assert "PARTIAL" in err
    assert "out.long_repeats.txt" in err
