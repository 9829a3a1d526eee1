"""Native C++ DADA engine vs the NumPy reference path."""

import numpy as np
import pytest

from ska_pst_dsp.io import dada, native
from ska_pst_dsp.io.lowcbf import flatten_low_cbf_stream

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine not built"
)


def _data(n_pol=2, n_chan=4, n_dat=640, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n_pol, n_chan, n_dat))
        + 1j * rng.standard_normal((n_pol, n_chan, n_dat))
    ).astype(np.complex64)


class TestNativeRead:
    def test_matches_numpy_float32(self, tmp_path):
        data = _data()
        path = str(tmp_path / "x.dada")
        dada.save(path, data, {"TSAMP": "1"})
        re, im, hdr = dada.load_split(path)
        np.testing.assert_array_equal(re + 1j * im, data)
        assert hdr["NPOL"] == "2"

    def test_window(self, tmp_path):
        data = _data()
        path = str(tmp_path / "x.dada")
        dada.save(path, data, {})
        re, im, _ = dada.load_split(path, count=100, offset_samples=50)
        np.testing.assert_array_equal(re + 1j * im, data[:, :, 50:150])

    def test_int16(self, tmp_path):
        data = (_data() * 100).astype(np.complex64)
        path = str(tmp_path / "x16.dada")
        dada.save(path, data, {}, nbit=16)
        re, im, _ = dada.load_split(path)
        ref, _ = dada.load(path)
        np.testing.assert_array_equal(re + 1j * im, ref)

    def test_int8(self, tmp_path):
        data = (_data() * 10).astype(np.complex64)
        path = str(tmp_path / "x8.dada")
        dada.save(path, data, {}, nbit=8)
        re, im, _ = dada.load_split(path)
        ref, _ = dada.load(path)
        np.testing.assert_array_equal(re + 1j * im, ref)

    def test_lowcbf(self, tmp_path):
        data = _data(n_dat=320)
        flat = flatten_low_cbf_stream(data)
        path = str(tmp_path / "lc.dada")
        # write flat heap stream with LowCBF instrument header
        hdr = {"INSTRUMENT": "LowCBF", "NPOL": "2", "NCHAN": "4",
               "NBIT": "32", "NDIM": "2"}
        with open(path, "wb") as f:
            f.write(dada.serialize_header({**hdr, "HDR_SIZE": "4096"}))
            out = np.empty(flat.size * 2, np.float32)
            out[0::2] = flat.real
            out[1::2] = flat.imag
            out.tofile(f)
        re, im, _ = dada.load_split(path)
        np.testing.assert_array_equal(re + 1j * im, data)


class TestNativeWrite:
    def test_roundtrip_float32(self, tmp_path):
        data = _data()
        path = str(tmp_path / "w.dada")
        # header via python, payload via native append
        dada.save(path, data[:, :, :0], {"TSAMP": "1"})
        native.append_split(
            path, np.ascontiguousarray(data.real),
            np.ascontiguousarray(data.imag),
        )
        loaded, _ = dada.load(path)
        np.testing.assert_array_equal(loaded, data)

    def test_quantized_int8(self, tmp_path):
        data = _data() * 10
        path = str(tmp_path / "w8.dada")
        dada.save(path, (data[:, :, :0]).astype(np.complex64), {}, nbit=8)
        native.append_split(
            path, np.ascontiguousarray(data.real.astype(np.float32)),
            np.ascontiguousarray(data.imag.astype(np.float32)), nbit=8,
        )
        loaded, hdr = dada.load(path)
        assert hdr["NBIT"] == "8"
        expect = np.round(np.clip(data.real, -128, 127)) + 1j * np.round(
            np.clip(data.imag, -128, 127)
        )
        np.testing.assert_array_equal(loaded, expect.astype(np.complex64))

    def test_header_size_probe(self, tmp_path):
        path = str(tmp_path / "h.dada")
        dada.save(path, _data(), {})
        assert native.header_size(path) == 4096
