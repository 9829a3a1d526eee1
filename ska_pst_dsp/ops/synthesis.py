"""Golden FFT-based PFB inversion — JAX kernel.

Equivalent of the reference's ``polyphase_synthesis``
(polyphase_synthesis.m:112-316), the implementation against which dspsr's
InverseFilterbank is validated, re-architected for XLA:

* Overlap-save framing (hop ``input_keep``) is static slicing, all blocks
  processed as one batch — the reference's per-block/per-pol/per-channel
  loops become array axes.
* The per-channel forward FFTs are one batched complex64 FFT
  (:mod:`.cfft`); fftshift + passband selection is a static slice; deripple
  and tapers are constant real vectors fused into the surrounding
  elementwise ops by XLA.
* The reference's DC-centered split of channel 0 across both spectrum ends
  when the input spans the full Nyquist zone (polyphase_synthesis.m:265-278)
  is exactly a cyclic roll of the channel-concatenated spectrum by
  -FN_width/2 — implemented as such.
* The ``combine`` coarse-channel reordering (:198-238) is a precomputed
  static channel permutation.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import geometry, windows
from ..utils.rational import Rational
from . import cfft
from .framing import frame


def combine_channel_permutation(n_chan: int, combine: int) -> np.ndarray:
    """Input-channel index feeding each output slot when the n_chan fine
    channels span ``combine`` coarse channels (polyphase_synthesis.m:198-238):
    half-coarse-channel shift, DSB-monotonic reorder, and half-band swaps
    within the output and coarse channels."""
    chan = np.arange(n_chan)
    if combine <= 1:
        return chan
    fcpc = n_chan // combine  # fine channels per coarse channel
    fine = (chan + fcpc // 2) % n_chan
    coarse = fine // fcpc
    fine = fine - coarse * fcpc
    coarse = (coarse + combine // 2) % combine
    fine = (fine + fcpc // 2) % fcpc
    return coarse * fcpc + fine


@functools.partial(
    jax.jit, static_argnames=("geom_key", "spans_nyquist", "has_sf")
)
def _synthesis_core(
    xr: jnp.ndarray,         # (n_pol, n_chan, n_dat) float32
    xi: jnp.ndarray,
    t_taper: jnp.ndarray,    # (L,) float32
    s_taper: jnp.ndarray,    # (n_chan*FN_width,) float32
    dr: jnp.ndarray,         # (FN_width,) float32 deripple (ones if disabled)
    perm: jnp.ndarray,       # (n_chan,) int32 combine permutation
    sf_r: jnp.ndarray = None,  # (n_chan*FN_width,) complex spectral filter
    sf_i: jnp.ndarray = None,  #   (None when has_sf is False)
    *,
    geom_key,                # (n_chan, L, overlap, nu, de) — static
    spans_nyquist: bool,
    has_sf: bool = False,
):
    n_chan_g, L, overlap, nu, de = geom_key
    os_factor = Rational(nu, de)
    geom = geometry.SynthesisGeometry(n_chan_g, L, overlap, os_factor)
    n_pol, n_chan, n_dat = xr.shape
    n_blocks = geom.n_blocks(n_dat)
    fnw = geom.fn_width

    with jax.named_scope("frame_taper"):
        xs = jnp.stack([xr, xi])  # (2, P, C, T)
        xs = jnp.take(xs, perm, axis=2)
        frames = frame(xs, L, geom.input_keep, n_blocks)  # (2, P, C, B, L)
        frames = frames * t_taper[None, None, None, None, :]
    with jax.named_scope("forward_fft"):
        sr, si = cfft.fft(frames[0], frames[1])
    with jax.named_scope("assemble"):
        sr = cfft.fftshift(sr, axis=-1)
        si = cfft.fftshift(si, axis=-1)
        fnr = sr[..., geom.discard: geom.discard + fnw] * dr  # (P, C, B, fnw)
        fni = si[..., geom.discard: geom.discard + fnw] * dr

        def assemble(fn):
            flat = jnp.transpose(fn, (0, 2, 1, 3)).reshape(
                n_pol, n_blocks, n_chan * fnw
            )
            if spans_nyquist:
                flat = jnp.roll(flat, -(fnw // 2), axis=-1)
            return flat * s_taper[None, None, :]

        flatr, flati = assemble(fnr), assemble(fni)
        if has_sf:
            # complex spectral filter in the assembled baseband spectrum —
            # the native analog of dspsr's convolution-during-inversion
            # (`-IF ... D`): e.g. a coherent-dedispersion chirp, valid as
            # overlap-save as long as its impulse response fits inside
            # 2*output_overlap.
            flatr, flati = (
                flatr * sf_r - flati * sf_i,
                flatr * sf_i + flati * sf_r,
            )
    with jax.named_scope("backward_fft"):
        br, bi = cfft.ifft(flatr, flati)
    with jax.named_scope("discard"):
        scale = np.float32(de / nu)
        lo, hi = geom.output_overlap, geom.output_fft_length - geom.output_overlap
        keptr = br[..., lo:hi] * scale
        kepti = bi[..., lo:hi] * scale
        out_shape = (n_pol, 1, n_blocks * geom.output_keep)
        return keptr.reshape(out_shape), kepti.reshape(out_shape)


def polyphase_synthesis(
    x,
    input_fft_length: int,
    os_factor: Union[Rational, str],
    *,
    spans_nyquist: bool = True,
    input_overlap: Optional[int] = None,
    deripple_coeff: Optional[np.ndarray] = None,
    sample_offset: int = 0,
    temporal_taper: Union[str, np.ndarray, None] = "no_window",
    spectral_taper: Union[str, np.ndarray, None] = "no_window",
    combine: int = 1,
    monotonic: bool = False,
    spectral_filter=None,
):
    """Invert an oversampled PFB: fine channels → original baseband stream.

    Args:
      x: (n_pol, n_chan, n_dat) complex fine-channel spectra, or an
        (re, im) float32 tuple of that shape.
      input_fft_length: forward FFT length per fine channel.
      os_factor: oversampling ratio of the analysis PFB.
      spans_nyquist: input channels span the full Nyquist zone (channel 0 is
        DC-centered and split across the band edges).
      input_overlap: overlap-save discard per side (default L/8, matching
        polyphase_synthesis.m:78).
      deripple_coeff: prototype FIR coefficients; when given, passband ripple
        is equalized with the reciprocal filter response
        (polyphase_synthesis.m:138-150).
      sample_offset: fine-channel samples dropped before processing.
      temporal_taper / spectral_taper: window name from
        :mod:`ska_pst_dsp.utils.windows` or an explicit vector.
      combine: number of coarse channels the input fine channels span.
      monotonic: input fine channels are already in monotonic frequency
        order (fftshifted, e.g. chomped LowCBF cascades — ops/lowcbf.py):
        the DSB combine reordering does not apply, the channels assemble
        in given order (perm = identity).
      spectral_filter: optional COMPLEX per-bin multiplier, length
        n_chan*FN_width in assembled-spectrum (standard FFT) bin order —
        applied per overlap-save block before the backward FFT. This is the
        native slot for dspsr's convolution-during-inversion (e.g. a
        coherent-dedispersion chirp from
        :func:`ska_pst_dsp.ops.dedispersion.chirp_filter`). The kept
        region of each backward-FFT block is [output_overlap,
        output_fft_length - output_overlap], so the filter's circular-
        convolution wraparound must stay inside one side's discard: a causal
        (delay-type) impulse response must fit within output_overlap samples
        (one-sided; an anti-causal response likewise within the trailing
        output_overlap). Complex array or (re, im) float32 tuple.

    Returns (n_pol, 1, n_blocks*output_keep); complex numpy for complex
    input, (re, im) tuple for tuple input.
    """
    os_factor = Rational.coerce(os_factor)
    pair_in = isinstance(x, tuple)
    if pair_in:
        xr, xi = x
    else:
        xr, xi = cfft.split(x)
    if sample_offset:
        xr = xr[:, :, sample_offset:]
        xi = xi[:, :, sample_offset:]
    n_pol, n_chan, n_dat = xr.shape
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    fnw = geom.fn_width

    if isinstance(temporal_taper, str) or temporal_taper is None:
        t_vec = windows.build(temporal_taper or "no_window", L, input_overlap)
    else:
        t_vec = np.asarray(temporal_taper, dtype=np.float32)
    if isinstance(spectral_taper, str) or spectral_taper is None:
        s_vec = windows.build(
            spectral_taper or "no_window", n_chan * fnw, input_overlap
        )
    else:
        s_vec = np.asarray(spectral_taper, dtype=np.float32)

    if deripple_coeff is not None:
        from ..design.fir import deripple_response

        dr = deripple_response(deripple_coeff, n_chan, fnw // 2).astype(np.float32)
    else:
        dr = np.ones(fnw, dtype=np.float32)

    perm = (
        np.arange(n_chan) if monotonic
        else combine_channel_permutation(n_chan, combine)
    ).astype(np.int32)

    if spectral_filter is not None:
        if isinstance(spectral_filter, tuple):
            sf_r, sf_i = spectral_filter
        else:
            sf = np.asarray(spectral_filter)
            sf_r, sf_i = sf.real, sf.imag
        sf_r = np.asarray(sf_r, dtype=np.float32)
        sf_i = np.asarray(sf_i, dtype=np.float32)
        if sf_r.shape != (n_chan * fnw,) or sf_i.shape != (n_chan * fnw,):
            raise ValueError(
                f"spectral_filter must have shape ({n_chan * fnw},), "
                f"got re {sf_r.shape} / im {sf_i.shape}"
            )
    else:
        sf_r = sf_i = None

    rr, ri = _synthesis_core(
        jnp.asarray(xr),
        jnp.asarray(xi),
        jnp.asarray(t_vec),
        jnp.asarray(s_vec),
        jnp.asarray(dr),
        jnp.asarray(perm),
        None if sf_r is None else jnp.asarray(sf_r),
        None if sf_i is None else jnp.asarray(sf_i),
        geom_key=(n_chan, L, input_overlap, os_factor.nu, os_factor.de),
        spans_nyquist=spans_nyquist,
        has_sf=spectral_filter is not None,
    )
    return (rr, ri) if pair_in else cfft.combine(rr, ri)
