"""The split-complex FFT wrappers must match numpy's FFT at fp32 accuracy
for every transform size the framework's geometries use."""

import jax
import numpy as np
import pytest

from ska_pst_dsp.ops import cfft

# sizes: analysis FFTs (256, 512, 192...), lowcbf (256), synthesis forward
# (256, 512), big inverse FFTs: low 192*256=49152, mid 448*4096=1835008,
# odd composites
SIZES = [8, 12, 56, 192, 256, 448, 512, 1024, 3584, 49152]


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ).astype(np.complex64)


@pytest.mark.parametrize("n", SIZES)
def test_fft_matches_numpy(n):
    x = _rand((3, n), seed=n)
    xr, xi = cfft.split(x)
    yr, yi = jax.jit(cfft.fft)(xr, xi)
    got = cfft.combine(yr, yi)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-6 * scale, rtol=0)


@pytest.mark.parametrize("n", SIZES)
def test_ifft_matches_numpy(n):
    x = _rand((2, n), seed=n + 1)
    xr, xi = cfft.split(x)
    yr, yi = jax.jit(cfft.ifft)(xr, xi)
    got = cfft.combine(yr, yi)
    want = np.fft.ifft(x.astype(np.complex128), axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-6 * scale, rtol=0)


def test_huge_mid_ifft():
    """The SKA-Mid full-band inverse FFT: 4096 channels * 448 bins."""
    n = 448 * 4096
    x = _rand((1, n), seed=7)
    xr, xi = cfft.split(x)
    yr, yi = jax.jit(cfft.ifft)(xr, xi)
    got = cfft.combine(yr, yi)
    want = np.fft.ifft(x.astype(np.complex128), axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_axis_argument():
    x = _rand((5, 64, 3), seed=9)
    xr, xi = cfft.split(x)
    yr, yi = cfft.fft(xr, xi, axis=1)
    got = cfft.combine(yr, yi)
    want = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_roundtrip():
    x = _rand((4, 3584), seed=11)
    xr, xi = cfft.split(x)
    fr, fi = cfft.fft(xr, xi)
    br, bi = cfft.ifft(fr, fi)
    got = cfft.combine(br, bi)
    np.testing.assert_allclose(got, x, atol=2e-5 * np.abs(x).max(), rtol=0)


def test_fftshift():
    x = np.arange(8.0)
    got = np.asarray(cfft.fftshift(np.asarray(x)))
    np.testing.assert_array_equal(got, np.fft.fftshift(x))


def test_tone_purity_through_native_fft():
    """A pure tone's FFT through the complex64 wrapper must keep spurious
    bins below -120 dB — well under the -60 dB budget."""
    n = 49152
    k0 = 1234
    t = np.arange(n)
    x = np.exp(2j * np.pi * k0 * t / n).astype(np.complex64)
    xr, xi = cfft.split(x)
    yr, yi = cfft.fft(xr, xi)
    mag2 = np.asarray(yr) ** 2 + np.asarray(yi) ** 2
    peak = mag2[k0]
    mag2[k0] = 0
    assert 10 * np.log10(mag2.max() / peak) < -120
