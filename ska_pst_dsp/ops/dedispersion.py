"""Coherent dedispersion.

The reference delegates dedispersion to the external C++ ``dspsr``
(python/verify/test_dedispersion.py drives ``dspsr -D DM`` before/after PFB
inversion); this module provides the native device capability so the
dedispersion-invariance verification runs without external binaries.

Physics: the interstellar medium delays frequency f by
t(f) = k_DM * DM * (f_ref^-2 - f^-2), k_DM = 4.149377593e3 s MHz^2 pc^-1 cm^3.
Coherent dedispersion removes the equivalent phase rotation exactly with the
frequency-domain chirp

    H(f0 + df) = exp(+2j*pi * k_DM * DM * df^2 / (f0^2 * (f0 + df)))

(the dspsr/PSRCHIVE convention). Applied as FFT → chirp multiply → IFFT on
split-complex data (matmul DFTs from :mod:`.cfft`), whole-block; a streaming
overlap-save wrapper lives in the verify harness.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cfft

#: dispersion constant, s MHz^2 / (pc cm^-3) (Manchester & Taylor)
KDM = 4.149377593e3


def dispersion_delay(dm: float, freq_mhz: float, ref_freq_mhz: float) -> float:
    """Time delay (seconds) of freq relative to ref."""
    return KDM * dm * (freq_mhz**-2 - ref_freq_mhz**-2)


def chirp_phase(
    n: int, dm: float, center_freq_mhz: float, bw_mhz: float
) -> np.ndarray:
    """Phase (radians, fp64) of the coherent-dedispersion chirp at the n FFT
    bin frequencies of a complex baseband channel centered at
    ``center_freq_mhz`` spanning ``bw_mhz``."""
    # FFT bin -> baseband offset in [-bw/2, bw/2)
    k = np.arange(n)
    df = (np.where(k < n - n // 2, k, k - n) / n) * bw_mhz
    f0 = center_freq_mhz
    return (
        2.0 * np.pi * KDM * 1e6 * dm * df**2 / (f0**2 * (f0 + df))
    )  # 1e6: k_DM in s -> phase at MHz frequencies


def chirp_filter(
    n: int, dm: float, center_freq_mhz: float, bw_mhz: float,
    inverse: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) float32 of the chirp; ``inverse=True`` disperses instead of
    dedispersing."""
    phase = chirp_phase(n, dm, center_freq_mhz, bw_mhz)
    if inverse:
        phase = -phase
    return (
        np.cos(phase).astype(np.float32),
        np.sin(phase).astype(np.float32),
    )


@functools.partial(jax.jit, static_argnames=())
def _apply_chirp(xr, xi, hr, hi):
    sr, si = cfft.fft(xr, xi)
    yr = sr * hr - si * hi
    yi = sr * hi + si * hr
    return cfft.ifft(yr, yi)


def dedisperse(
    x,
    dm: float,
    center_freq_mhz: float,
    bw_mhz: float,
    *,
    inverse: bool = False,
):
    """Coherently (de)disperse a complex baseband stream.

    x: (..., n) complex array or (re, im) tuple; the transform runs over the
    last axis as one whole-block convolution. Returns the same kind.
    """
    pair_in = isinstance(x, tuple)
    xr, xi = x if pair_in else cfft.split(x)
    n = xr.shape[-1]
    hr, hi = chirp_filter(n, dm, center_freq_mhz, bw_mhz, inverse=inverse)
    rr, ri = _apply_chirp(xr, xi, jnp.asarray(hr), jnp.asarray(hi))
    return (rr, ri) if pair_in else cfft.combine(rr, ri)
