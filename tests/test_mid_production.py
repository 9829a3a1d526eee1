"""SKA-Mid PRODUCTION geometry, end-to-end.

Runs the full mid configuration — 4096 channels, OS 8/7, the 100353-tap
two-stage FIR, zero-padded analysis, L=512/overlap=128 Golden inversion —
through the real kernels (config/test.config.json "mid";
polyphase_analysis_padded.m:61-156, design_PFB_FIR_filter_two_stage.m:44-78,
polyphase_synthesis.m:112-316). Nothing here is a reduced stand-in: these are
the production sizes, including the 1,835,008-point backward FFT per
inversion block.

Alignment note: the padded analysis indexes its newest input sample at
``idx*step - 1`` (polyphase_analysis_padded.m:121-126), one sample earlier
than the non-padded kernel, and its group delay ceil((taps-1)/2/step)*step =
50176 = (taps-1)/2 cancels exactly at this geometry — so the inverted stream
satisfies out[t] = x[t - 1] after the output_overlap discard, i.e. the total
input→output shift is output_overlap - 1 = 458751 samples.
"""

import numpy as np
import pytest

from ska_pst_dsp import oracle
from ska_pst_dsp.ops import polyphase_analysis_padded, polyphase_synthesis
from ska_pst_dsp.utils import geometry, windows
from ska_pst_dsp.utils.config import load_config
from ska_pst_dsp.utils.rational import Rational

N_CHAN, L, OVERLAP = 4096, 512, 128
OS = Rational(8, 7)
STEP = 3584  # analysis_step(4096, 8/7)
GEOM = geometry.SynthesisGeometry(N_CHAN, L, OVERLAP, OS)


@pytest.fixture(scope="module")
def mid_filter():
    """The production 100353-tap two-stage FIR, loaded through the config
    layer (designs + caches on first use, as a reference user would)."""
    cfg = load_config("mid")
    filt = cfg.load_fir_filter_coeff()
    assert filt.size == 100353
    assert cfg.channels == N_CHAN
    assert cfg.input_fft_length == L and cfg.input_overlap == OVERLAP
    assert cfg.os_factor == OS
    return filt


def _invert(chan, filt):
    return np.asarray(
        polyphase_synthesis(
            chan, L, OS, input_overlap=OVERLAP, deripple_coeff=filt,
            temporal_taper="tukey",
        )
    )[0, 0]


class TestMidProduction:
    def test_geometry(self, mid_filter):
        assert geometry.analysis_step(N_CHAN, OS) == STEP
        assert GEOM.fn_width == 448
        assert GEOM.output_fft_length == 1_835_008  # the mid big IFFT
        assert GEOM.output_overlap == 458_752
        # group delay is an exact multiple of step at this geometry
        delay = geometry.padded_sample_delay_shift(mid_filter.size, N_CHAN, OS)
        assert delay * STEP == (mid_filter.size - 1) // 2 == 50_176

    def test_tone_purity(self, mid_filter):
        """SKAO CSP_Mid_PST_REQ-385: spurious response of a pure tone after
        inversion ≤ -60 dB (TestPureTone.m:20). Tone at channel edge 33.5 —
        the worst case for deripple/overlap leakage."""
        nfine = 2 * OVERLAP + GEOM.input_keep  # one inversion block
        n_dat = nfine * STEP
        freq = 4288 / 2**19  # = 33.5/4096: channel-boundary tone, exact bin
        x = np.exp(2j * np.pi * freq * np.arange(n_dat)).astype(np.complex64)

        chan = polyphase_analysis_padded(x[None, None], mid_filter, N_CHAN, OS)
        inv = _invert(chan, mid_filter)
        assert inv.size == GEOM.output_keep == 917_504

        nfft = 2**19
        S = np.abs(np.fft.fft(inv[:nfft])) ** 2
        pk = int(S.argmax())
        assert pk == 4288  # tone lands in its exact bin
        sp = S.copy()
        sp[pk - 1: pk + 2] = 0.0
        db = 10 * np.log10(sp.max() / S[pk])
        assert db < -60.0, f"mid tone spurious {db:.1f} dB exceeds -60 dB"
        # measured: ~ -85.8 dB

    def test_impulse_at_block_boundary(self, mid_filter):
        """SKAO CSP_Mid_PST_REQ-386: temporal leakage of an impulse ≤ -60 dB
        (TestImpulse.m:26). The impulse is placed exactly at an inversion
        block boundary — the adversarial placement current_performance.m:60-74
        sweeps — and must land at offset - (output_overlap - 1)."""
        nfine = 2 * OVERLAP + 2 * GEOM.input_keep  # two inversion blocks
        n_dat = nfine * STEP
        shift = GEOM.output_overlap - 1
        offset = shift + GEOM.output_keep  # peak lands ON the block seam
        x = np.zeros(n_dat, dtype=np.complex64)
        x[offset] = 1.0

        chan = polyphase_analysis_padded(x[None, None], mid_filter, N_CHAN, OS)
        inv = _invert(chan, mid_filter)

        pk = int(np.abs(inv).argmax())
        assert pk == offset - shift
        assert abs(abs(inv[pk]) - 1.0) < 1e-3  # unit amplitude preserved
        p = np.abs(inv) ** 2
        m = p.copy()
        m[pk - 1: pk + 2] = 0.0
        db = 10 * np.log10(m.max() / p[pk])
        assert db < -60.0, f"mid impulse leakage {db:.1f} dB exceeds -60 dB"
        # measured: ~ -75 dB with the peak on the seam

    def test_chain_matches_fp64_oracle(self, mid_filter):
        """The jitted fp32 chain must agree with the loop-faithful fp64
        NumPy oracle at production geometry to ~1e-6 relative (the
        reference's cross-implementation bar,
        test_matlab_dspsr_pfb_inversion.py:35)."""
        nfine = 2 * OVERLAP + GEOM.input_keep
        n_dat = nfine * STEP
        rng = np.random.default_rng(7)
        x = (
            rng.standard_normal(n_dat) + 1j * rng.standard_normal(n_dat)
        ).astype(np.complex64)[None, None]

        chan_j = np.asarray(
            polyphase_analysis_padded(x, mid_filter, N_CHAN, OS)
        )
        chan_o = oracle.polyphase_analysis_padded(
            x.astype(np.complex128), mid_filter, N_CHAN, OS
        )
        delay = geometry.padded_sample_delay_shift(mid_filter.size, N_CHAN, OS)
        scale = np.abs(chan_o).max()
        d = np.abs(chan_j[..., :-delay] - chan_o[..., :-delay])
        assert d.max() / scale < 1e-6  # measured ~1.8e-7

        inv_j = _invert(chan_j, mid_filter)
        inv_o = oracle.polyphase_synthesis(
            chan_o, L, OS, input_overlap=OVERLAP, deripple_coeff=mid_filter,
            temporal_taper=windows.tukey_window(L, OVERLAP).astype(np.float64),
        )[0, 0]
        scale = np.abs(inv_o).max()
        d = np.abs(inv_j - inv_o)
        assert d.max() / scale < 1e-6  # measured ~3.1e-7
        assert d.mean() / scale < 2e-7
