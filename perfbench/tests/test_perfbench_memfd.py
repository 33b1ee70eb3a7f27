"""The program parses inputs handed over as memfd paths, and emits to
memfd sinks behind symlinks, with the same bytes as with plain files."""

import os

from perfbench import gen, harness, reference


def test_memfd_inputs_and_sinks_equal_plain_files(tmp_path):
    from raft_tpu_torch import pipeline
    cell = harness.find_cell("hifi30x.whole")
    ds = gen.make_dataset(cell.config, {"n_reads": 400}, 31)
    fds = [gen.memfd("reads.fasta"), gen.memfd("overlaps.paf")]
    try:
        gen.render_fasta(ds, fds[0])
        gen.render_paf(ds, fds[1])
        plain = []
        for fd, name in zip(fds, ("reads.fasta", "overlaps.paf")):
            with open(gen.fd_path(fd), "rb") as f:
                data = f.read()
            plain.append(str(tmp_path / name))
            with open(plain[-1], "wb") as f:
                f.write(data)
        prefix = str(tmp_path / "plain")
        pipeline.run_pipeline(*plain,
                              harness.algo_params(cell.config, ds.est_cov,
                                                  prefix),
                              device="cpu", verbose=False)
        os.mkdir(tmp_path / "sinks")
        sinks = harness.Sinks(str(tmp_path / "sinks"), 0)
        try:
            for _ in range(2):  # the second run truncates and rewrites
                st = pipeline.run_pipeline(
                    gen.fd_path(fds[0]), gen.fd_path(fds[1]),
                    harness.algo_params(cell.config, ds.est_cov,
                                        sinks.prefix),
                    device="cpu", verbose=False)
            assert st.native_io and st.schedule == "whole"
            for sfx in reference.SUFFIXES:
                with open(prefix + sfx, "rb") as f:
                    want = f.read()
                assert sinks.mismatch(sfx, want) is None, sfx
                assert os.path.islink(sinks.prefix + sfx)
            assert len(want) == 0  # real reads: the BED stays empty
        finally:
            sinks.close()
    finally:
        for fd in fds:
            os.close(fd)


def test_mismatch_reports_the_first_differing_byte(tmp_path):
    os.mkdir(tmp_path / "s")
    sinks = harness.Sinks(str(tmp_path / "s"), 0)
    try:
        data = bytes(range(256)) * 40
        with open(sinks.prefix + ".coverage.txt", "wb") as f:
            f.write(data)
        assert sinks.mismatch(".coverage.txt", data) is None
        bad = bytearray(data)
        bad[5000] ^= 1
        assert sinks.mismatch(".coverage.txt", bytes(bad)) == 5000
        assert sinks.mismatch(".coverage.txt", data + b"x") == len(data)
        assert sinks.mismatch(".coverage.txt", data[:-3]) == len(data) - 3
        assert sinks.mismatch(".reads.fasta", b"") is None
        assert sinks.mismatch(".reads.fasta", b">") == 0
    finally:
        sinks.close()
