"""Transliteration-independent anchors: the JAX kernels against closed-form
mathematics, not the NumPy oracle.

The oracle (ska_pst_dsp/oracle.py) and the kernels share one author and
one reading of the reference Matlab, so oracle-differential tests cannot
catch a shared misreading (the reference's own
strongest gate is two unrelated codebases agreeing,
test_matlab_dspsr_pfb_inversion.py:35). These tests derive the expected
outputs from first principles only:

* single-tone closed form — out[k, q] = N * e^{i w k S} * ramp[k, q]
  * sum_tau f[tau] e^{i (w - 2 pi q / N) tau}, i.e. the channelizer response
  is the prototype-FIR DTFT evaluated at the offset from each channel
  center (derived from the fold+DFT definition in one line: the DFT phase
  e^{-2 pi i q (tau mod N)/N} is N-periodic in tau);
* impulse closed form — each output spectrum is a single filter tap value
  times a unit-modulus twiddle (ties the kernel to exact FIR indexing);
* shift theorem — delaying the input by nu*step spectra shifts the output
  spectra by nu blocks exactly (the ramp schedule has period nu);
* Parseval — per-spectrum output energy equals N^3 * ||fold||^2 (DFT
  unitarity through the kernel, with the fold written directly from its
  windowed-sum definition).
"""

import numpy as np
import pytest

from ska_pst_dsp.design import fir
from ska_pst_dsp.ops import polyphase_analysis
from ska_pst_dsp.utils import geometry
from ska_pst_dsp.utils.rational import Rational

N_CHAN = 256
OS = Rational(4, 3)
STEP = 192
N_DAT = 2**16


@pytest.fixture(scope="module")
def filt():
    return np.asarray(fir.design_pfb_fir_filter(N_CHAN, OS, 12),
                      dtype=np.float64)


def _f_pad(filt):
    fl = geometry.padded_filter_length(filt.size, N_CHAN)
    f = np.zeros(fl)
    f[: filt.size] = filt
    return f


def _ramp(nblocks):
    k = np.arange(nblocks)
    q = np.arange(N_CHAN)
    shift = (STEP * k) % N_CHAN
    return np.exp(-2j * np.pi * q[None, :] * shift[:, None] / N_CHAN)


class TestClosedForms:
    def test_single_tone_dtft(self, filt):
        """out[k, q] = N e^{i w k S} ramp[k,q] F(w - w_q), F the FIR DTFT."""
        w = 2 * np.pi * (37.0 + 0.3) / N_CHAN  # off-bin tone
        x = np.exp(1j * w * np.arange(N_DAT)).astype(np.complex64)
        out = np.asarray(polyphase_analysis(x[None, None], filt, N_CHAN, OS))
        n_k = out.shape[2]

        f = _f_pad(filt)
        tau = np.arange(f.size)
        q = np.arange(N_CHAN)
        # F_q = sum_tau f[tau] e^{i(w - 2 pi q/N) tau}
        Fq = (f[None, :] * np.exp(
            1j * (w - 2 * np.pi * q[:, None] / N_CHAN) * tau[None, :]
        )).sum(axis=1)
        k = np.arange(n_k)
        expect = (
            N_CHAN
            * np.exp(1j * w * STEP * k)[ :, None]
            * _ramp(n_k)
            * Fq[None, :]
        ).T  # (q, k)
        scale = np.abs(expect).max()
        assert np.abs(out[0] - expect).max() / scale < 2e-5

    def test_impulse_taps(self, filt):
        """An impulse at p makes spectrum k a single tap value f[p - k*S]
        times a unit twiddle — exact FIR indexing, no oracle."""
        p = 10_000
        x = np.zeros(N_DAT, dtype=np.complex64)
        x[p] = 1.0
        out = np.asarray(polyphase_analysis(x[None, None], filt, N_CHAN, OS))
        n_k = out.shape[2]

        f = _f_pad(filt)
        q = np.arange(N_CHAN)
        ramp = _ramp(n_k)
        expect = np.zeros((N_CHAN, n_k), dtype=np.complex128)
        for k in range(n_k):
            tau = p - k * STEP
            if 0 <= tau < f.size:
                expect[:, k] = (
                    N_CHAN * f[tau]
                    * np.exp(-2j * np.pi * q * (tau % N_CHAN) / N_CHAN)
                    * ramp[k]
                )
        scale = np.abs(expect).max()
        assert scale > 0
        assert np.abs(out[0] - expect).max() / scale < 2e-5

    def test_shift_theorem(self, filt):
        """Delaying the input by nu*STEP samples shifts the output by
        exactly nu spectra (the ramp schedule has period nu = 4)."""
        rng = np.random.default_rng(11)
        x = (rng.standard_normal(N_DAT) + 1j * rng.standard_normal(N_DAT)
             ).astype(np.complex64)
        nu = OS.nu
        xd = np.concatenate([np.zeros(nu * STEP, np.complex64), x])
        a = np.asarray(polyphase_analysis(x[None, None], filt, N_CHAN, OS))
        b = np.asarray(polyphase_analysis(xd[None, None], filt, N_CHAN, OS))
        n = a.shape[2]
        np.testing.assert_allclose(
            b[..., nu: n + nu], a[..., :n], atol=2e-4, rtol=0
        )

    def test_parseval_per_spectrum(self, filt):
        """sum_q |out[k,q]|^2 == N^3 ||fold_k||^2 for arbitrary input:
        DFT unitarity + ramp unimodularity through the kernel, with the
        fold written straight from its definition."""
        rng = np.random.default_rng(7)
        x = (rng.standard_normal(N_DAT) + 1j * rng.standard_normal(N_DAT)
             ).astype(np.complex64)
        out = np.asarray(polyphase_analysis(x[None, None], filt, N_CHAN, OS))
        n_k = out.shape[2]

        f = _f_pad(filt)
        lhs = (np.abs(out[0]) ** 2).sum(axis=0)  # (k,)
        rhs = np.empty(n_k)
        for k in range(n_k):
            win = x[k * STEP: k * STEP + f.size].astype(np.complex128) * f
            fold = win.reshape(-1, N_CHAN).sum(axis=0)
            rhs[k] = N_CHAN ** 3 * (np.abs(fold) ** 2).sum()
        np.testing.assert_allclose(lhs, rhs, rtol=2e-4)
