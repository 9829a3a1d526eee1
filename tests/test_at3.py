"""AT3 quantization campaign (at3_565_round_pfb_io.m equivalent) — a
reduced run of the sgcht sps+lowpsi critical chain with rounding variants,
checking the campaign driver plumbing and that the scored quantization SNRs
are sane. The full campaign's committed product is
products/report.at3_565.json."""

import json
import os

import pytest

from ska_pst_dsp.cli import at3


class TestAt3_565:
    @pytest.fixture(scope="class")
    def report(self, tmp_path_factory):
        out = tmp_path_factory.mktemp("at3")
        rpt = str(out / "report.json")
        rc = at3.run_565([
            "--blocks", "1", "--blocksz", str(2 * 1024 * 1024),
            "--output_dir", str(out), "--subset", "4",
            "--report", rpt,
        ])
        assert rc == 0
        with open(rpt) as f:
            return json.load(f)

    def test_variants_scored(self, report):
        v = report["variants"]
        assert "baseline" in v and "rndInput" in v and "rndOutput" in v
        assert "snr_db" not in v["baseline"]
        # unscaled input rounding destroys the unit-variance signal;
        # output rounding of the large-amplitude chain is benign
        assert v["rndInput"]["snr_db"] < v["rndOutput"]["snr_db"]
        # the optimal 8-bit input scaling recovers most of the SNR
        assert v["rmsInput_8bit"]["snr_db"] > v["rndInput"]["snr_db"] + 10

    def test_constants_recorded(self, report):
        assert report["optimal_rms"] == {"8": 33.8, "12": 462.6,
                                         "16": 3538.5} or (
            report["optimal_rms"] == {8: 33.8, 12: 462.6, 16: 3538.5}
        )
