"""Sliding-window framing built from static slices.

Overlap-save framing is the backbone of both PFB analysis (hop ``step``,
window = padded filter length) and inversion (hop ``input_keep``, window =
``input_fft_length``). A naive gather of (n_frames, window) indices lowers to
a generic gather; instead we reshape the stream into hop-sized rows and
stack ceil(window/hop) *static slices* of that row matrix — pure
reshape/slice/concat ops that XLA fuses into efficient copies.
"""

from __future__ import annotations

import jax.numpy as jnp


def frame(x: jnp.ndarray, window: int, hop: int, n_frames: int) -> jnp.ndarray:
    """Return frames[..., k, :] = x[..., k*hop : k*hop + window] for
    k in [0, n_frames), built from static slices only.

    x: (..., n_dat) with n_dat >= (n_frames-1)*hop + window.
    Returns (..., n_frames, window).
    """
    if n_frames <= 0:
        raise ValueError(
            f"input stream too short: {x.shape[-1]} samples yield "
            f"{n_frames} windows of {window} at hop {hop}"
        )
    n_rows_needed = n_frames - 1 + -(-window // hop)  # k_max + ceil(window/hop)
    needed = n_rows_needed * hop
    batch = x.shape[:-1]
    n_dat = x.shape[-1]
    if n_dat < (n_frames - 1) * hop + window:
        raise ValueError(
            f"stream of {n_dat} too short for {n_frames} frames of "
            f"{window} at hop {hop}"
        )
    if n_dat < needed:
        pad = [(0, 0)] * len(batch) + [(0, needed - n_dat)]
        x = jnp.pad(x, pad)
    rows = x[..., :needed].reshape(*batch, n_rows_needed, hop)
    r = -(-window // hop)  # slices per frame
    parts = [rows[..., i: i + n_frames, :] for i in range(r)]
    stacked = jnp.concatenate(parts, axis=-1)  # (..., n_frames, r*hop)
    return stacked[..., :window]
