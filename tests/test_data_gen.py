"""Tests for the orchestration layer (reference python/test/test_data_gen.py
role): generator/channelizer/synthesizer invocation for both backends,
output naming, pipeline composition, dispose, dspsr_util parsers."""

import os

import numpy as np
import pytest

from ska_pst_dsp import data_gen
from ska_pst_dsp.data_gen import util as dg_util
from ska_pst_dsp.data_gen import dspsr_util
from ska_pst_dsp.io import dada


class TestGenerateTestVector:
    def test_complex_sinusoid_function(self):
        sig = data_gen.complex_sinusoid(1000, [0.1], [np.pi / 4])
        assert sig.shape == (1000,)
        spec = np.abs(np.fft.fft(sig))
        assert spec.argmax() == 100  # fractional freq -> bin index

    def test_time_domain_impulse_function(self):
        sig = data_gen.time_domain_impulse(1000, [0.25], [3])
        assert np.flatnonzero(sig).tolist() == [250, 251, 252]

    @pytest.mark.parametrize("backend", ["jax", "numpy"])
    def test_writes_dada(self, tmp_path, backend):
        generator = data_gen.generate_test_vector(
            backend=backend, domain_name="freq", n_bins=1024
        )
        f = generator([0.25], [0.0], output_dir=str(tmp_path), n_pol=2)
        assert os.path.exists(f.file_path)
        assert "complex_sinusoid.1024.0.250-0.000.2.single" in f.file_path
        loaded = dada.DADAFile(f.file_path).load_data()
        assert loaded.data.shape == (1024, 1, 2)

    def test_partialize_deferred(self):
        gen = data_gen.generate_test_vector(backend="numpy", domain_name="time")
        assert callable(gen)


class TestChannelizeSynthesize:
    @pytest.fixture(scope="class")
    def tone_file(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("dg")
        generator = data_gen.generate_test_vector(
            backend="numpy", domain_name="freq", n_bins=3 * 192 * 64
        )
        return generator([0.26], [0.0], output_dir=str(d), n_pol=1)

    @pytest.mark.parametrize("backend", ["jax", "numpy"])
    def test_channelize_roundtrip_headers(self, tone_file, tmp_path, backend):
        out = data_gen.channelize(
            tone_file.file_path,
            channels=64,
            os_factor_str="4/3",
            backend=backend,
            output_dir=str(tmp_path),
        )
        assert out.nchan == 64
        hdr = dada.read_header(out.file_path)
        assert hdr["OS_FACTOR"] == "4/3"
        assert hdr["NSTAGE"] == "1"
        assert int(hdr["NTAP_0"]) > 0

    def test_synthesize_recovers_fir_from_header(self, tone_file, tmp_path):
        chan = data_gen.channelize(
            tone_file.file_path, channels=64, os_factor_str="4/3",
            backend="jax", output_dir=str(tmp_path),
        )
        inv = data_gen.synthesize(
            chan.file_path, input_fft_length=128, input_overlap=24,
            backend="jax", output_dir=str(tmp_path),
        )
        assert inv.nchan == 1
        assert inv.ndat > 0

    def test_backend_equivalence(self, tone_file, tmp_path):
        """jax and numpy channelizers must agree (reference
        test_backends.py threshold 1e-4; ours is tighter)."""
        a = data_gen.channelize(
            tone_file.file_path, channels=64, os_factor_str="4/3",
            backend="jax", output_dir=str(tmp_path),
            output_file_name="a.dump",
        )
        b = data_gen.channelize(
            tone_file.file_path, channels=64, os_factor_str="4/3",
            backend="numpy", output_dir=str(tmp_path),
            output_file_name="b.dump",
        )
        da, db = a.data, b.data
        # fp32 kernel vs fp64 oracle: absolute error floor is set by the
        # unit-amplitude input through the fold (heavy cancellation for an
        # off-center tone), not by the small channel outputs
        assert np.abs(da - db).max() < 2e-6
        frac = np.isclose(da, db, atol=2e-6, rtol=1e-4).mean()
        assert frac == 1.0


class TestPipelineCompose:
    def test_three_stages(self, tmp_path):
        pipe = data_gen.pipeline(
            data_gen.generate_test_vector(
                backend="numpy", domain_name="time", n_bins=3 * 192 * 64
            ),
            data_gen.channelize(backend="jax", channels=64, os_factor_str="4/3"),
            data_gen.synthesize(backend="jax", input_fft_length=128,
                                input_overlap=24),
            output_dir=str(tmp_path),
        )
        inp, chan, synth = pipe([0.5], [1])
        assert os.path.basename(chan.file_path).startswith("channelized.")
        assert os.path.basename(synth.file_path).startswith("synthesized.")
        assert synth.ndat > 0


class TestDispose:
    def test_removes_files(self, tmp_path):
        p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
        for p in (p1, p2):
            open(p, "w").write("x")
        with data_gen.dispose(p1, p2, dispose_all=True):
            pass
        assert not os.path.exists(p1) and not os.path.exists(p2)

    def test_keeps_first_by_default(self, tmp_path):
        p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
        for p in (p1, p2):
            open(p, "w").write("x")
        with data_gen.dispose(p1, p2):
            pass
        assert os.path.exists(p1) and not os.path.exists(p2)


class TestDspsrUtil:
    def test_tool_unavailable(self):
        runner = dspsr_util.DspsrRunner()
        if __import__("shutil").which("dspsr") is None:
            with pytest.raises(dspsr_util.ToolUnavailable):
                runner("nonexistent.dump")

    def test_find_in_log(self, tmp_path):
        p = str(tmp_path / "x.log")
        open(p, "w").write("blah\noutput_fft_length = 1024\nother stuff\n")
        assert dspsr_util.find_in_log(p, "output_fft_length") == "1024"

    def test_load_psrtxt_data(self, tmp_path):
        p = str(tmp_path / "x.txt")
        open(p, "w").write("1 2 3\n4 5 6\n")
        d = dspsr_util.load_psrtxt_data(p)
        assert d.shape == (3, 2)

    def test_numpy_encoder(self):
        import json

        s = json.dumps(
            {"a": np.float32(1.5), "b": np.arange(3), "c": np.complex64(1 + 2j)},
            cls=dg_util.NumpyEncoder,
        )
        assert "1.5" in s
