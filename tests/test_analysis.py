"""Differential tests: JAX analysis kernels vs the NumPy oracle."""

import numpy as np
import pytest

from ska_pst_dsp import oracle
from ska_pst_dsp.ops import (
    polyphase_analysis,
    polyphase_analysis_padded,
    polyphase_analysis_lowcbf,
)
from ska_pst_dsp.utils.rational import Rational


def _noise(n_pol, n_dat, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pol, 1, n_dat)) + 1j * rng.standard_normal(
        (n_pol, 1, n_dat)
    )
    return x.astype(dtype)


def _tone(n_pol, n_dat, freq, dtype=np.complex64):
    t = np.arange(n_dat)
    x = np.exp(2j * np.pi * freq * t)[None, None, :]
    return np.broadcast_to(x, (n_pol, 1, n_dat)).astype(dtype)


def _filt(taps, block, seed=3):
    # a realistic lowpass-ish prototype: sinc windowed
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / block) * np.hamming(taps)
    return (h / h.sum()).astype(np.float64)


REL_TOL = 2e-6  # fp32 kernels vs fp64 oracle, relative to peak


def _check(jax_out, ref_out, tol=REL_TOL):
    jax_out = np.asarray(jax_out)
    scale = np.abs(ref_out).max()
    assert jax_out.shape == ref_out.shape
    np.testing.assert_allclose(jax_out, ref_out, atol=tol * scale, rtol=0)


class TestPolyphaseAnalysis:
    @pytest.mark.parametrize("os", ["4/3", "32/27", "1/1"])
    def test_matches_oracle_noise(self, os):
        os_f = Rational.from_str(os)
        block, tpc = 32, 8
        x = _noise(2, 5000)
        filt = _filt(block * tpc + 1, block)
        ref = oracle.polyphase_analysis(
            x.astype(np.complex128), filt, block, os_f
        )
        out = polyphase_analysis(x, filt, block, os_f)
        _check(out, ref)

    def test_matches_oracle_tone(self):
        os_f = Rational(4, 3)
        block = 64
        x = _tone(1, 9000, 5.5 / 64)
        filt = _filt(block * 12 + 1, block)
        ref = oracle.polyphase_analysis(x.astype(np.complex128), filt, block, os_f)
        out = polyphase_analysis(x, filt, block, os_f)
        _check(out, ref)

    def test_tone_lands_in_right_channel(self):
        """A tone at channel-c center must concentrate power in channel c."""
        os_f = Rational(4, 3)
        block = 32
        filt = _filt(block * 12 + 1, block)
        for chan in (0, 3, 17, 31):
            x = _tone(1, 20000, chan / block)
            out = np.asarray(polyphase_analysis(x, filt, block, os_f))
            power = np.abs(out[0]).sum(axis=1)
            assert power.argmax() == chan

    def test_block0_offset_continuation(self):
        """A chunk starting mid-stream with block0 set must reproduce the
        corresponding slice of the one-shot result (streamed == one-shot)."""
        os_f = Rational(4, 3)
        block, tpc = 32, 8
        step = 24
        filt = _filt(block * tpc + 1, block)
        x = _noise(1, 8000)
        full = np.asarray(polyphase_analysis(x, filt, block, os_f))
        k1 = 100
        out2 = np.asarray(
            polyphase_analysis(x[:, :, k1 * step:], filt, block, os_f, block0=k1)
        )
        n2 = out2.shape[2]
        _check(out2, full[:, :, k1: k1 + n2], tol=3e-6)


class TestPolyphaseAnalysisPadded:
    @pytest.mark.parametrize("os", ["8/7", "4/3"])
    def test_matches_oracle_noise(self, os):
        os_f = Rational.from_str(os)
        block, tpc = 32, 8
        x = _noise(2, 4000, seed=5)
        filt = _filt(block * tpc + 1, block)
        ref = oracle.polyphase_analysis_padded(
            x.astype(np.complex128), filt, block, os_f
        )
        out = polyphase_analysis_padded(x, filt, block, os_f)
        _check(out, ref)

    def test_matches_oracle_tone(self):
        os_f = Rational(8, 7)
        block = 56
        x = _tone(1, 6000, 3.0 / block)
        filt = _filt(block * 8 + 1, block)
        ref = oracle.polyphase_analysis_padded(
            x.astype(np.complex128), filt, block, os_f
        )
        out = polyphase_analysis_padded(x, filt, block, os_f)
        _check(out, ref)


class TestLowCBF:
    def test_matches_oracle(self):
        rng = np.random.default_rng(7)
        taps = rng.standard_normal(3072)
        x = _noise(2, 10000, seed=8)
        ref = oracle.polyphase_analysis_lowcbf(
            x.astype(np.complex128), taps, 256, Rational(4, 3), first_call=True
        )
        out = polyphase_analysis_lowcbf(x, taps, first_call=True)
        _check(out, ref)

    def test_no_padding_second_call(self):
        rng = np.random.default_rng(9)
        taps = rng.standard_normal(3072)
        x = _noise(1, 8000, seed=10)
        ref = oracle.polyphase_analysis_lowcbf(
            x.astype(np.complex128), taps, 256, Rational(4, 3), first_call=False
        )
        out = polyphase_analysis_lowcbf(x, taps, first_call=False)
        _check(out, ref)

    def test_output_shape(self):
        taps = np.ones(3072)
        x = _noise(2, 3072 + 192 * 10, seed=11)
        out = np.asarray(polyphase_analysis_lowcbf(x, taps, first_call=False))
        assert out.shape == (2, 216, 10)


class TestProductionWidthsVsOracle:
    """The plain analysis path against the fp64 oracle at the production
    channel counts: SKA-Low (256 ch, OS 4/3, 3073 taps), and the padded
    fold at 512 ch OS 4/3 and 1024 ch OS 8/7 (the mid structure: step
    3584/4096 = 7/8 of the block, 25+ phases)."""

    @pytest.mark.parametrize("n_pol, tuple_api", [
        (2, False), (1, False), (3, True),
    ], ids=["two_pol", "odd_pol", "odd_pol_tuple_api"])
    def test_low(self, n_pol, tuple_api):
        from ska_pst_dsp.design import fir

        os_f = Rational(4, 3)
        filt = fir.design_pfb_fir_filter(256, os_f, 12)
        x = _noise(n_pol, 60000, seed=n_pol)
        ref = oracle.polyphase_analysis(
            x.astype(np.complex128), filt, 256, os_f
        )
        if tuple_api:
            rr, ri = polyphase_analysis(
                (np.ascontiguousarray(x.real[:, 0]),
                 np.ascontiguousarray(x.imag[:, 0])), filt, 256, os_f,
            )
            out = np.asarray(rr) + 1j * np.asarray(ri)
        else:
            out = polyphase_analysis(x, filt, 256, os_f)
        _check(out, ref)

    @pytest.mark.parametrize("block, os, n_pol", [
        (512, "4/3", 2), (512, "4/3", 3), (1024, "8/7", 2),
    ], ids=["512_os4_3", "512_os4_3_odd_pol", "1024_os8_7"])
    def test_padded(self, block, os, n_pol):
        from ska_pst_dsp.design import fir

        os_f = Rational.from_str(os)
        filt = np.asarray(fir.design_pfb_fir_filter(block, os_f, 4))
        x = _noise(n_pol, 60 * block, seed=block + n_pol)
        ref = oracle.polyphase_analysis_padded(
            x.astype(np.complex128), filt, block, os_f
        )
        out = polyphase_analysis_padded(x, filt, block, os_f)
        _check(out, ref)

    @pytest.mark.parametrize("block, os, k1", [
        (512, "4/3", 8), (1024, "8/7", 5),
    ])
    def test_padded_block0_streaming_ramp(self, block, os, k1):
        """A chunk starting at spectrum k1 with block0=k1 must reproduce the
        one-shot spectra once its own filter history is full."""
        from ska_pst_dsp.design import fir
        from ska_pst_dsp.utils import geometry

        os_f = Rational.from_str(os)
        filt = np.asarray(fir.design_pfb_fir_filter(block, os_f, 4))
        step = geometry.analysis_step(block, os_f)
        phases = geometry.padded_filter_length(filt.size, block) // step + 1
        x = _noise(2, 60 * block, seed=k1)
        full = np.asarray(polyphase_analysis_padded(
            x, filt, block, os_f, apply_delay=False
        ))
        part = np.asarray(polyphase_analysis_padded(
            x[:, :, k1 * step:], filt, block, os_f, block0=k1,
            apply_delay=False,
        ))
        n2 = part.shape[2]
        _check(part[..., phases:], full[..., k1 + phases: k1 + n2], tol=3e-6)
