"""Split-complex FFT helpers.

The framework carries complex data as separate real/imag float32 arrays
("split complex") between its kernels. Transforms run as native complex64
FFTs (``jnp.fft``: cuFFT on the GPU, DUCC on the CPU); the split pair is
joined for the transform and split again after it, which XLA fuses into the
surrounding elementwise work.

The one dense DFT left is :func:`_dft_block`, the (2n x 2n) real block
matrix whose column slices let the 2-D mesh analysis
(:mod:`ska_pst_dsp.parallel.corner_turn`) compute each device's
output-channel slice of the channel DFT without a collective.

Replaces: Matlab fft/ifft calls inside polyphase_analysis.m:116-120,
polyphase_synthesis.m:184-285, PSTFilterbank.m:35.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


@functools.lru_cache(maxsize=None)
def _dft_block(n: int, inverse: bool) -> np.ndarray:
    """(2n, 2n) real block matrix for right-multiplication:
    [Br Bi] = [Ar Ai] @ [[Dr, Di], [-Di, Dr]], D[j,k] = exp(∓2j*pi*jk/n)."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sign = 1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * ((j * k) % n) / n
    dr = np.cos(ang)
    di = np.sin(ang)
    top = np.concatenate([dr, di], axis=1)
    bot = np.concatenate([-di, dr], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.float32)


def fft(xr: Array, xi: Array, axis: int = -1) -> Tuple[Array, Array]:
    """Forward DFT of split-complex data along ``axis``."""
    y = jnp.fft.fft(jax.lax.complex(xr, xi), axis=axis)
    return jnp.real(y), jnp.imag(y)


def ifft(xr: Array, xi: Array, axis: int = -1) -> Tuple[Array, Array]:
    """Inverse DFT (1/N normalized) of split-complex data along ``axis``."""
    y = jnp.fft.ifft(jax.lax.complex(xr, xi), axis=axis)
    return jnp.real(y), jnp.imag(y)


def fftshift(x: Array, axis: int = -1) -> Array:
    """Swap spectrum halves (pure roll — no FFT op involved)."""
    return jnp.roll(x, x.shape[axis] // 2, axis=axis)


# ---------------------------------------------------------------------------
# host-boundary helpers
# ---------------------------------------------------------------------------

def split(x) -> Tuple[Array, Array]:
    """Complex (numpy or jax) → (re, im) float32 jax arrays. NumPy inputs
    are split on the host, so only float32 planes are transferred."""
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            return (
                jnp.asarray(np.ascontiguousarray(x.real).astype(np.float32)),
                jnp.asarray(np.ascontiguousarray(x.imag).astype(np.float32)),
            )
        xr = jnp.asarray(x.astype(np.float32))
        return xr, jnp.zeros_like(xr)
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
    return x.astype(jnp.float32), jnp.zeros_like(x, dtype=jnp.float32)


def combine(xr: Array, xi: Array) -> np.ndarray:
    """(re, im) → complex64 numpy, joined on the host."""
    return np.asarray(xr).astype(np.float32) + 1j * np.asarray(xi).astype(np.float32)
