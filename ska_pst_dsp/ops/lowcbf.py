"""SKA-Low CBF firmware-model PST filterbank — JAX kernel.

Equivalent of the reference's PSTFilterbank.m:7-45 and its wrapper
polyphase_analysis_lowcbf.m:16-48: the 3072-tap / 256-channel / 12-tap FIR
filterbank with hop 192 that models the SKA-Low CBF FPGA firmware, keeping
the 216 = 256*27/32 critically sampled fine channels.

XLA re-derivation notes:
* The per-output-sample 256x12 MAC loop is the same multiply-fold as the
  analysis PFB — one batched einsum over framed input, pinned to
  ``Precision.HIGHEST`` so a GPU does not run it in TF32; the FFT is a
  native complex64 FFT on split-complex data (:mod:`.cfft`).
* The firmware's per-sample pi/2 phase de-rotation
  exp(2j*pi*mod(s*(-128:127),4)/4) is periodic in s with period 4, so the
  whole de-rotation is a constant (4, 256) table of exact quarter-turn
  factors {1, i, -1, -i} indexed by s mod 4 — no transcendentals at runtime.
* Firmware scalings (2^9 FIR, /128 FFT) and the wrapper's compensating
  2^9*2048*256 rescale are folded into a single constant.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cfft
from .framing import frame

NFILT = 3072
BLOCK = 256
STEP = 192
TAPS = 12
KEPT_LO = 20       # 0-based first kept channel (Matlab 21)
KEPT = 216
FIRST_CALL_PAD = 1536  # half the FIR length (PSTFilterbank.m:4-9)


def _rotation_table() -> Tuple[np.ndarray, np.ndarray]:
    """rot[s % 4, shifted_bin] = exp(2j*pi*((s * -(bin-128)) mod 4)/4) as
    (re, im) — exact quarter turns."""
    quarter = np.array([1, 1j, -1, -1j], dtype=np.complex64)
    bins = np.arange(-128, 128)
    s = np.arange(4)[:, None]
    rot = quarter[(s * (-bins)) % 4]
    return rot.real.astype(np.float32), rot.imag.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("scale",))
def _lowcbf_core(xr, xi, taps2d, *, scale: float):
    """(n_pol, n_dat) already padded -> 2 x (n_pol, KEPT, n_out)."""
    n_pol, n_dat = xr.shape
    n_out = (n_dat - NFILT) // STEP
    xs = jnp.stack([xr, xi])
    frames = frame(xs, NFILT, STEP, n_out).reshape(2, n_pol, n_out, TAPS, BLOCK)
    fft_in = jnp.einsum(
        "cpktj,tj->cpkj", frames, taps2d, precision=jax.lax.Precision.HIGHEST
    )
    sr, si = cfft.fft(fft_in[0], fft_in[1])
    sr = cfft.fftshift(sr, axis=-1)
    si = cfft.fftshift(si, axis=-1)
    rotr, roti = _rotation_table()
    s_idx = np.arange(n_out) % 4
    rr = jnp.asarray(rotr[s_idx])  # (n_out, 256)
    ri = jnp.asarray(roti[s_idx])
    outr = (sr * rr - si * ri)[..., KEPT_LO: KEPT_LO + KEPT] * np.float32(scale)
    outi = (sr * ri + si * rr)[..., KEPT_LO: KEPT_LO + KEPT] * np.float32(scale)
    return jnp.transpose(outr, (0, 2, 1)), jnp.transpose(outi, (0, 2, 1))


def polyphase_analysis_lowcbf(
    x,
    filt,
    block: int = BLOCK,
    os_factor=None,
    *,
    first_call: bool = True,
):
    """LowCBF firmware-model analysis (polyphase_analysis_lowcbf.m).

    The firmware divides by 2^9 (FIR) and 128 (FFT+phase scaling); the
    wrapper multiplies by 2^9*2048*256 (polyphase_analysis_lowcbf.m:25); net
    scale applied once. The reference zero-pads 1536 samples only on the
    first call via Matlab ``persistent`` state; that state is explicit here
    (``first_call``).

    x: (n_pol, 1, n_dat), (n_pol, n_dat) complex, or (re, im) tuple.
    Returns (n_pol, 216, n_out); typing follows the input kind.
    """
    pair_in = isinstance(x, tuple)
    if pair_in:
        xr, xi = x
    else:
        if hasattr(x, "ndim") and x.ndim == 3:
            x = x[:, 0, :]
        xr, xi = cfft.split(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    xr, xi = jnp.asarray(xr), jnp.asarray(xi)
    if first_call:
        xr = jnp.pad(xr, [(0, 0), (FIRST_CALL_PAD, 0)])
        xi = jnp.pad(xi, [(0, 0), (FIRST_CALL_PAD, 0)])
    taps2d = np.asarray(filt, dtype=np.float64).ravel()[: NFILT].reshape(TAPS, BLOCK)
    # firmware: /2^9 (FIR) then /128 (FFT scaling); wrapper: *2^9*2048*256
    scale = (2.0**9 * 2048 * 256) / (2.0**9 * 128.0)
    rr, ri = _lowcbf_core(
        xr, xi, jnp.asarray(taps2d.astype(np.float32)), scale=scale
    )
    return (rr, ri) if pair_in else cfft.combine(rr, ri)
