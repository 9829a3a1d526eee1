"""Driver CLIs that previously had no test executing them: test_vector
(requirement-vector writer) and phrap (phase-resolved folding)."""

import json
import os

import numpy as np
import pytest

from ska_pst_dsp.cli import phrap, test_vector
from ska_pst_dsp.io import dada


class TestTestVector:
    def test_temporal_low(self, tmp_path):
        rc = test_vector.run([
            "--cbf", "low", "--domain", "temporal", "--nstate", "3",
            "--output_dir", str(tmp_path),
        ])
        assert rc == 0
        path = tmp_path / "test_vector.low.temporal.dada"
        data, header = dada.load(str(path))
        with open(str(path) + ".expect.json") as f:
            expect = json.load(f)
        assert data.shape[-1] == expect["Ttotal"]
        # each state's impulse sits exactly where the geometry math says
        for st in expect["states"]:
            pos = st["file_offset"] + st["offset"]
            assert data[0, 0, pos] == 1j
            # nothing else in that state's block
            blk = data[0, 0, st["file_offset"]: st["file_offset"] + 100]
            assert np.count_nonzero(blk) <= 1 or pos >= st["file_offset"] + 100
        # derived inversion geometry is self-consistent (test_vector.m:94-127)
        assert expect["Tifft"] == expect["Ncritical"] * expect["Tkeep"] * 32 // 27

    def test_spectral_low(self, tmp_path):
        rc = test_vector.run([
            "--cbf", "low", "--domain", "spectral", "--nstate", "2",
            "--output_dir", str(tmp_path),
        ])
        assert rc == 0
        data, _ = dada.load(str(tmp_path / "test_vector.low.spectral.dada"))
        with open(str(tmp_path / "test_vector.low.spectral.dada.expect.json")) as f:
            expect = json.load(f)
        # each state's tone occupies its block at the derived frequency
        st = expect["states"][0]
        seg = data[0, 0, st["file_offset"]: st["file_offset"] + expect["Tifft"]]
        spec = np.abs(np.fft.fft(seg))
        assert int(spec.argmax()) == st["Freq"]

    def test_mid_geometry(self, tmp_path):
        rc = test_vector.run([
            "--cbf", "mid", "--domain", "temporal", "--nstate", "2",
            "--output_dir", str(tmp_path),
        ])
        assert rc == 0
        with open(str(tmp_path / "test_vector.mid.temporal.dada.expect.json")) as f:
            expect = json.load(f)
        # mid requirement geometry (test_vector.m:66-92): Nfft=2048, R=8/7
        assert expect["Tkeep"] == 2048 * 7 // 8
        assert expect["Ncritical"] == 4096 * 3 // 4

    def test_quantized_output(self, tmp_path):
        rc = test_vector.run([
            "--cbf", "low", "--domain", "temporal", "--nstate", "2",
            "--nbit", "16", "--output_dir", str(tmp_path),
        ])
        assert rc == 0
        _, header = dada.read_header(
            str(tmp_path / "test_vector.low.temporal.dada")
        ), None
        header = dada.read_header(
            str(tmp_path / "test_vector.low.temporal.dada")
        )
        assert header["NBIT"] == "16"


class TestPhrap:
    def test_square_wave_profile(self, tmp_path):
        out = str(tmp_path / "profile.npz")
        rc = phrap.run([
            "--signal", "square_wave", "--blocks", "8",
            "--blocksz", "65536", "--output", out,
        ])
        assert rc == 0
        z = np.load(out)
        profile = z["profile"][0, 0]
        assert z["hits"].sum() == 8 * 65536
        # the 50% duty cycle must be visible: on-pulse power ~ 3x off-pulse
        # (amplitude-modulated noise: on = 2x variance + continuum)
        hi = np.sort(profile)[-profile.size // 4:].mean()
        lo = np.sort(profile)[: profile.size // 4].mean()
        assert hi > 1.5 * lo and hi > 0  # off-pulse may be exactly zero

    def test_fold_dada_file(self, tmp_path):
        # write a square wave then fold the file
        from ska_pst_dsp.cli import sgcht

        rc = sgcht.run([
            "--signal", "square_wave", "--blocks", "4",
            "--blocksz", "65536", "--output_dir", str(tmp_path),
        ])
        assert rc == 0
        out = str(tmp_path / "profile_file.npz")
        rc = phrap.run([
            "--input", str(tmp_path / "square_wave.dada"),
            "--blocks", "4", "--blocksz", "65536", "--output", out,
        ])
        assert rc == 0
        assert os.path.exists(out)


class TestParamSearch:
    """overlap_parameter_search port (overlap_parameter_search.m:1-216):
    the 2-D fft_length x overlap grid with the reference's six measures."""

    def test_search_grid_and_measures(self):
        from ska_pst_dsp.analysis.param_opt import (
            overlap_parameter_search,
        )

        recs = overlap_parameter_search(
            n_chan=64, fft_lengths=(256, 512), overlaps=(64, 128),
            npoints=4,
        )
        combos = {(r["fft_length"], r["overlap"]) for r in recs}
        # L/ov <= 2 combos are skipped (:68-70): (256,128) must be absent
        assert combos == {(256, 64), (512, 64), (512, 128)}
        for r in recs:
            for key in ("diff_max", "diff_sum", "diff_mean",
                        "max_spurious", "total_spurious", "mean_spurious"):
                assert key in r
            # a pure tone through the round trip must stay pure
            assert r["max_spurious"] < -55.0
