"""Oversampled polyphase analysis filterbanks — JAX kernels.

Mathematical equivalents of the reference's analysis kernels
(polyphase_analysis.m:88-120, polyphase_analysis_padded.m:113-153),
re-derived for XLA rather than translated:

* The reference's per-block ``circshift`` of the windowed samples commutes
  with phase-folding and becomes a per-bin phase ramp under the DFT, so the
  whole per-block loop collapses to

      out[k, q] = block * FFT(folded_k)[q] * exp(-2j*pi*q*(step*k % block)/block)

  (upper-sideband; polyphase_analysis.m:102-120). The padded variant's
  sliding time-flipped mask + barrel-rotator reduces to a time-reversed
  filter correlation with ``block^2 * IFFT`` and the *same*
  ``step*k mod block`` ramp schedule (the equivalence the reference itself
  notes at polyphase_analysis_padded.m:138-142).

* Each kernel is one batched multiply-fold + one batched DFT + one
  elementwise complex ramp: no per-block control flow, no gathers (framing
  is static slices, :mod:`.framing`), fully fused by XLA, shape-static.

* Data are carried **split-complex** (separate re/im float32) between the
  kernels; the DFTs are native complex64 FFTs (:mod:`.cfft`). Public
  wrappers accept/return complex arrays for API convenience, or (re, im)
  tuples to stay on device.

* The fold contraction is pinned to ``Precision.HIGHEST``: a float32 dot
  may otherwise run in TF32 on a GPU (~1e-3 relative error), which breaks
  the -60 dB purity requirement.

Both kernels take ``block0``, the absolute index of the first output
spectrum: the ramp schedule depends on absolute position, which is what lets
streamed and sharded execution stay bit-identical with one-shot execution.

Verified against the NumPy oracle (:mod:`ska_pst_dsp.oracle`) in
tests/test_analysis.py.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import geometry
from ..utils.rational import Rational
from . import cfft
from .framing import frame

HIGHEST = jax.lax.Precision.HIGHEST


def _phase_ramp(block: int, step: int, nblocks: int, k0: int) -> Tuple[np.ndarray, np.ndarray]:
    """ramp[k, q] = exp(-2j*pi * q * (step*(k+k0) mod block) / block) as
    (re, im) float32."""
    k = np.arange(nblocks) + k0
    shift = (step * k) % block
    q = np.arange(block)
    ang = -2.0 * np.pi * q[None, :] * shift[:, None] / block
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _prep_filter(filt, block: int, reverse: bool = False) -> np.ndarray:
    """Zero-pad taps to a multiple of block (pad_filter.m:9-13) and reshape
    to (phases, block) with f2d[m, j] = f[m*block + j]."""
    filt = np.asarray(filt, dtype=np.float64).ravel()
    fl = geometry.padded_filter_length(filt.size, block)
    f = np.zeros(fl, dtype=np.float64)
    f[: filt.size] = filt
    if reverse:
        f = f[::-1]
    return f.reshape(fl // block, block).astype(np.float32)


def _fold(xr, xi, f2d, step: int):
    """Frame both components with hop ``step`` and fold against the
    (phases, block) filter: (P, n) -> 2 x (P, nblocks, block)."""
    n_pol, n_dat = xr.shape
    phases, block = f2d.shape
    fl = phases * block
    nblocks = (n_dat - fl) // step
    xs = jnp.stack([xr, xi])  # (2, P, n)
    frames = frame(xs, fl, step, nblocks).reshape(2, n_pol, nblocks, phases, block)
    folded = jnp.einsum("spkmj,mj->spkj", frames, f2d, precision=HIGHEST)
    return folded[0], folded[1]


@functools.partial(jax.jit, static_argnames=("block", "step", "k0"))
def _analysis_core(xr, xi, f2d, *, block: int, step: int, k0: int):
    """(n_pol, n_dat) -> 2 x (n_pol, block, nblocks); upper-sideband."""
    with jax.named_scope("fold"):
        fr, fi = _fold(xr, xi, f2d, step)
    with jax.named_scope("channel_fft"):
        sr, si = cfft.fft(fr, fi)
        nblocks = sr.shape[1]
        rr, ri = _phase_ramp(block, step, nblocks, k0)
        outr = (sr * rr - si * ri) * block
        outi = (sr * ri + si * rr) * block
        return jnp.transpose(outr, (0, 2, 1)), jnp.transpose(outi, (0, 2, 1))


@functools.partial(jax.jit, static_argnames=("block", "step", "k0", "delay"))
def _analysis_padded_core(xr, xi, f2d_rev, *, block: int, step: int, k0: int,
                          delay: int):
    """(n_pol, n_dat) -> 2 x (n_pol, block, n_dat//step); lower-sideband."""
    n_pol, n_dat = xr.shape
    phases, _ = f2d_rev.shape
    fl = phases * block
    nblocks = n_dat // step
    # y_i[j] = sum_{tau=j+m*block} f[tau] * x[i*step - 1 - tau]
    #        = reverse_j( fold( f_reversed * x[i*step - fl : i*step] ) )
    with jax.named_scope("fold"):
        xs = jnp.stack([xr, xi])
        xs = jnp.pad(xs, [(0, 0), (0, 0), (fl, 0)])
        frames = frame(xs, fl, step, nblocks).reshape(
            2, n_pol, nblocks, phases, block
        )
        g = jnp.einsum("spkmj,mj->spkj", frames, f2d_rev, precision=HIGHEST)
    with jax.named_scope("channel_fft"):
        yr, yi = g[0, ..., ::-1], g[1, ..., ::-1]
        sr, si = cfft.ifft(yr, yi)
        scale = np.float32(block * block)
        sr, si = sr * scale, si * scale
        rr, ri = _phase_ramp(block, step, nblocks, k0)
        outr = sr * rr - si * ri
        outi = sr * ri + si * rr
        outr = jnp.transpose(outr, (0, 2, 1))
        outi = jnp.transpose(outi, (0, 2, 1))
        if delay:
            outr = jnp.roll(outr, -delay, axis=2)
            outi = jnp.roll(outi, -delay, axis=2)
        return outr, outi


def _wrap_io(fn):
    """Public-API adapter: complex (numpy/jax) in -> complex numpy out;
    (re, im) tuple in -> tuple out (stays on device, traceable)."""

    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        pair_in = isinstance(x, tuple)
        if pair_in:
            xr, xi = x
        else:
            if hasattr(x, "ndim") and x.ndim == 3:
                x = x[:, 0, :]
            xr, xi = cfft.split(x)
        if xr.ndim == 3:
            xr, xi = xr[:, 0, :], xi[:, 0, :]
        rr, ri = fn((jnp.asarray(xr), jnp.asarray(xi)), *args, **kwargs)
        return (rr, ri) if pair_in else cfft.combine(rr, ri)

    return wrapped


@_wrap_io
def polyphase_analysis(x, filt, block: int, os_factor: Union[Rational, str],
                       *, block0: int = 0):
    """Single-stage oversampled analysis PFB (SKA-Low / "Bunton" style).

    Args:
      x: (n_pol, 1, n_dat) or (n_pol, n_dat) complex stream, or an
        (re, im) float32 tuple.
      filt: prototype lowpass FIR coefficients.
      block: number of output channels (= FFT length).
      os_factor: oversampling ratio nu/de.
      block0: absolute index of the first output spectrum (for streamed /
        sharded calls; 0 for one-shot).

    Returns (n_pol, block, nblocks), nblocks = (n_dat - padded_taps)//step;
    complex numpy for complex input, (re, im) tuple for tuple input.
    """
    xr, xi = x
    os_factor = Rational.coerce(os_factor)
    return _analysis_core(
        xr, xi, jnp.asarray(_prep_filter(filt, block)),
        block=block,
        step=geometry.analysis_step(block, os_factor),
        k0=block0,
    )


@_wrap_io
def polyphase_analysis_padded(x, filt, block: int,
                              os_factor: Union[Rational, str], *,
                              block0: int = 0, apply_delay: bool = True):
    """Zero-padded oversampled analysis PFB (SKA-Mid / "Gunaratne" style).

    Output block k is computed from samples x[k*step - padded_taps : k*step]
    (zero-padded before the stream start), then the whole stream is advanced
    by ceil((taps-1)/2/step) spectra to cancel the filter group delay
    (polyphase_analysis_padded.m:89, :156). ``apply_delay=False`` leaves the
    raw timeline for streamed callers that shift globally.

    Returns (n_pol, block, n_dat//step); same in/out typing as
    :func:`polyphase_analysis`.
    """
    xr, xi = x
    os_factor = Rational.coerce(os_factor)
    n_taps = int(np.asarray(filt).size)
    delay = (
        geometry.padded_sample_delay_shift(n_taps, block, os_factor)
        if apply_delay
        else 0
    )
    return _analysis_padded_core(
        xr, xi, jnp.asarray(_prep_filter(filt, block, reverse=True)),
        block=block,
        step=geometry.analysis_step(block, os_factor),
        k0=block0,
        delay=delay,
    )
