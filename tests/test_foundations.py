"""Unit tests for the foundation layers: rational arithmetic, geometry,
windows, DADA I/O, config."""

import numpy as np
import pytest

from ska_pst_dsp.utils.rational import Rational
from ska_pst_dsp.utils import geometry, windows
from ska_pst_dsp.io import dada
from ska_pst_dsp.io.lowcbf import (
    reshape_low_cbf_stream,
    flatten_low_cbf_stream,
)
from ska_pst_dsp.utils.config import load_config, available_configs


class TestRational:
    def test_parse_and_arith(self):
        r = Rational.from_str("8/7")
        assert r.normalize(32) == 28
        assert r.multiply(28) == 32
        assert float(Rational(4, 3)) == pytest.approx(4 / 3)

    def test_exactness_enforced(self):
        with pytest.raises(ValueError):
            Rational(4, 3).normalize(10)

    def test_floor(self):
        assert Rational(4, 3).normalize_floor(256) == 192
        assert Rational(8, 7).normalize_floor(4096) == 3584

    def test_coerce(self):
        assert Rational.coerce("4/3") == Rational(4, 3)
        assert Rational.coerce({"nu": 4, "de": 3}) == Rational(4, 3)
        assert Rational.coerce((8, 7)) == Rational(8, 7)


class TestGeometry:
    def test_low_config_numbers(self):
        os43 = Rational(4, 3)
        assert geometry.analysis_step(256, os43) == 192
        assert geometry.padded_filter_length(3073, 256) == 3328
        g = geometry.SynthesisGeometry(256, 256, 48, os43)
        assert g.input_keep == 160
        assert g.fn_width == 192
        assert g.discard == 32
        assert g.output_fft_length == 192 * 256
        assert g.output_overlap == 36 * 256
        assert g.output_keep == 192 * 256 - 2 * 36 * 256

    def test_mid_config_numbers(self):
        os87 = Rational(8, 7)
        assert geometry.analysis_step(4096, os87) == 3584
        g = geometry.SynthesisGeometry(4096, 512, 128, os87)
        assert g.fn_width == 448
        assert g.discard == 32

    def test_calc_output_nbins(self):
        os43 = Rational(4, 3)
        n = geometry.calc_output_nbins(2**20, 256, os43, 3073, 256, 48)
        # forward: nblocks=(2^20-3073)//192=5444, output_pfb=5444*192//256=4083
        # inversion: nblocks=(4083-96)//160=24, keep=192*256-2*36*256
        assert n == 24 * (192 * 256 - 72 * 256)


class TestWindows:
    def test_tukey_edges(self):
        w = windows.tukey_window(256, 48)
        assert w.shape == (256,)
        assert w[0] == pytest.approx(0.0)
        assert np.all(w[48:208] == 1.0)
        # symmetric edges
        np.testing.assert_allclose(w[:48], w[:-49:-1], atol=1e-6)

    def test_top_hat(self):
        w = windows.top_hat_window(64, 8)
        assert np.all(w[:8] == 0) and np.all(w[-8:] == 0) and np.all(w[8:56] == 1)

    def test_hann_peak_at_zero(self):
        w = windows.hann_window(128, 0)
        # symmetric hann peaks between samples; after the half-roll the
        # largest values sit at the start of the vector
        assert w[0] == pytest.approx(1.0, abs=2e-4)
        assert w.argmax() in (0, 127)

    def test_registry(self):
        for name in ("no_window", "tukey", "hann", "top_hat", "fedora", "blackman"):
            assert windows.build(name, 64, 8).shape == (64,)


class TestDADA:
    def test_roundtrip_complex(self, tmp_path):
        rng = np.random.default_rng(0)
        data = (
            rng.standard_normal((2, 4, 100)) + 1j * rng.standard_normal((2, 4, 100))
        ).astype(np.complex64)
        hdr = {"TSAMP": "0.025", "UTC_START": "2025-01-01-00:00:00"}
        path = str(tmp_path / "x.dada")
        dada.save(path, data, hdr)
        loaded, header = dada.load(path)
        np.testing.assert_array_equal(loaded, data)
        assert header["NPOL"] == "2"
        assert header["NCHAN"] == "4"
        assert header["NBIT"] == "32"
        assert header["NDIM"] == "2"
        assert header["TSAMP"] == "0.025"

    def test_roundtrip_real_int8(self, tmp_path):
        data = np.arange(2 * 3 * 10, dtype=np.int8).reshape(2, 3, 10)
        path = str(tmp_path / "x.dada")
        dada.save(path, data, {})
        loaded, header = dada.load(path)
        np.testing.assert_array_equal(loaded, data)
        assert header["NBIT"] == "8"
        assert header["NDIM"] == "1"

    def test_header_growth(self, tmp_path):
        hdr = {f"KEY_{i}": "v" * 50 for i in range(200)}
        raw = dada.serialize_header(hdr)
        parsed = dada.parse_header(raw)
        assert int(parsed["HDR_SIZE"]) > dada.DEFAULT_HDR_SIZE
        assert len(raw) == int(parsed["HDR_SIZE"])

    def test_partial_read(self, tmp_path):
        data = (np.arange(2 * 1 * 50) + 0j).astype(np.complex64).reshape(2, 1, 50, order="F")
        data = np.ascontiguousarray(data)
        path = str(tmp_path / "x.dada")
        dada.save(path, data, {})
        part, _ = dada.load(path, count=10, offset_samples=5)
        np.testing.assert_array_equal(part, data[:, :, 5:15])

    def test_fir_in_header_roundtrip(self):
        from ska_pst_dsp.utils.rational import Rational

        coeff = np.array([0.1, -0.2, 0.3])
        hdr = dada.add_fir_filter_to_header({}, coeff, Rational(4, 3))
        assert hdr["NSTAGE"] == "1"
        assert hdr["NTAP_0"] == "3"
        out = dada.get_fir_filters_from_header(hdr)
        np.testing.assert_allclose(out[0][0], coeff, rtol=1e-5)
        assert out[0][1] == Rational(4, 3)

    def test_dadafile_api(self, tmp_path):
        f = dada.DADAFile(str(tmp_path / "y.dada"))
        tfp = (np.ones((30, 2, 2)) * np.arange(30)[:, None, None]).astype(np.complex64)
        f.data = tfp
        f.header = {"TSAMP": "1"}
        f.dump_data()
        g = dada.DADAFile(f.file_path).load_data()
        np.testing.assert_array_equal(g.data, tfp)
        assert g.ndat == 30 and g.nchan == 2 and g.npol == 2

    def test_lowcbf_heap_roundtrip(self):
        rng = np.random.default_rng(1)
        data = (
            rng.standard_normal((2, 4, 96)) + 1j * rng.standard_normal((2, 4, 96))
        ).astype(np.complex64)
        flat = flatten_low_cbf_stream(data)
        back = reshape_low_cbf_stream(flat, 2, 4)
        np.testing.assert_array_equal(back, data)


class TestConfig:
    def test_named_configs_exist(self):
        names = available_configs()
        for expected in ("low", "mid", "sps", "lowpsi", "low_alt",
                         "low_external", "mid_external"):
            assert expected in names

    def test_low(self):
        cfg = load_config("low")
        assert cfg.channels == 256
        assert cfg.os_factor == Rational(4, 3)
        assert cfg.input_fft_length == 256
        assert cfg.input_overlap == 48
        assert cfg.fir_filter_taps == 3073
        assert cfg.analysis_function == "polyphase_analysis"
        assert cfg.temporal_taper == "tukey"
        assert cfg.deripple

    def test_mid(self):
        cfg = load_config("mid")
        assert cfg.channels == 4096
        assert cfg.os_factor == Rational(8, 7)
        assert cfg.analysis_function == "polyphase_analysis_padded"

    def test_header_template(self):
        cfg = load_config("low")
        hdr = cfg.load_header()
        assert "TSAMP" in hdr and "UTC_START" in hdr


class TestTestbench:
    def test_hex_roundtrip(self, tmp_path):
        from ska_pst_dsp.io.testbench import load_fb_tb_data, fb_tb_to_dada
        from ska_pst_dsp.io import dada
        import numpy as np

        rng = np.random.default_rng(0)
        n_chan, n_pol, n_t = 4, 2, 16
        re = rng.integers(-3000, 3000, (n_t, n_chan, n_pol))
        im = rng.integers(-3000, 3000, (n_t, n_chan, n_pol))
        lines = []
        for t in range(n_t):
            for f in range(n_chan):
                for p in range(n_pol):
                    word = ((int(im[t, f, p]) & 0xFFFF) << 16) | (
                        int(re[t, f, p]) & 0xFFFF)
                    lines.append(f"{word:08x}")
        hexfile = tmp_path / "tb.hex"
        hexfile.write_text("\n".join(lines) + "\n")
        arr = load_fb_tb_data(str(hexfile), n_chan, n_pol)
        assert arr.shape == (n_pol, n_chan, n_t)
        np.testing.assert_array_equal(arr[1, 2].real, re[:, 2, 1])
        np.testing.assert_array_equal(arr[0, 3].imag, im[:, 3, 0])
        out = fb_tb_to_dada(str(hexfile), str(tmp_path / "tb.dada"),
                            n_chan=n_chan)
        loaded, hdr = dada.load(out)
        np.testing.assert_array_equal(loaded, arr)
        assert hdr["PFB_NCHAN"] == "4"


class TestRecenter:
    def test_recenter_extracts_peak_window(self):
        from ska_pst_dsp.design.fir import recenter_coefficients
        import numpy as np

        h = np.zeros(100)
        h[60] = 1.0
        h[55:66] = np.hamming(11)
        out = recenter_coefficients(h, 21)
        assert out.size == 21
        assert np.argmax(np.abs(out)) == 10
