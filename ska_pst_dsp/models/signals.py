"""Test-signal generators.

JAX equivalents of the reference's Generator classes (PureTone.m,
Impulse.m, SquareWave.m, FrequencyComb.m, FrequencyWedge.m, DADARead.m).

Design departure from the reference: generators here are *stateless pure
functions of absolute sample position* — ``generate(start, n)`` returns
samples [start, start+n) — instead of objects mutating a ``current``
counter. This makes any block split produce identical samples, which is the
property that lets generation be sharded over devices and replayed for
verification. A thin :class:`Stream` adapter provides the reference's
stateful ``generate(n)`` surface on top.

Noise determinism: random signals derive their values from
``jax.random.fold_in(key, tile_index)`` over fixed 16384-sample tiles aligned
to absolute position, so sample t has one value regardless of how the stream
is blocked or sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

TILE = 16384


def _noise_tile(key: jax.Array, ti: int) -> np.ndarray:
    """One deterministic complex-noise tile, computed on device as two real
    float32 planes and combined on host."""
    k = jax.random.fold_in(key, ti)
    r = np.asarray(jax.random.normal(k, (2, TILE), dtype=jnp.float32))
    return r[0] + 1j * r[1]


def _tiled_noise(key: jax.Array, start: int, n: int) -> np.ndarray:
    """Complex standard-normal noise (unit variance per complex sample,
    i.e. 0.5 per quadrature) for absolute positions [start, start+n),
    independent of blocking."""
    t0 = start // TILE
    t1 = (start + n - 1) // TILE + 1
    tiles = [_noise_tile(key, ti) for ti in range(t0, t1)]
    full = np.concatenate(tiles) if len(tiles) > 1 else tiles[0]
    off = start - t0 * TILE
    return full[off: off + n]


class SignalGenerator:
    """Protocol: generate(start, n) -> (1, 1, n) complex64 host samples
    (numpy; heavy generation happens on device as split real planes)."""

    n_pol = 1

    def generate(self, start: int, n: int) -> jnp.ndarray:
        raise NotImplementedError

    def stream(self) -> "Stream":
        return Stream(self)


@dataclasses.dataclass
class Stream:
    """Stateful adapter with the reference Generator surface
    (``[obj, x] = generate(obj, n)``)."""

    gen: SignalGenerator
    current: int = 0

    def generate(self, n: int) -> jnp.ndarray:
        x = self.gen.generate(self.current, n)
        self.current += n
        return x


@dataclasses.dataclass
class PureTone(SignalGenerator):
    """Phase-continuous complex sinusoid (PureTone.m:12-27)."""

    frequency: float = 1 / 26.5  # cycles per sample
    amplitude: float = 1.0

    def generate(self, start: int, n: int) -> np.ndarray:
        t = np.arange(start, start + n, dtype=np.float64)
        # phase computed in f64 on host: at sample ~1e9 f32 phase error
        # would swamp the -60 dB purity floor
        phase = 2.0 * np.pi * ((self.frequency * t) % 1.0)
        x = self.amplitude * np.exp(1j * phase)
        return x.astype(np.complex64)[None, None, :]


@dataclasses.dataclass
class Impulse(SignalGenerator):
    """Unit impulse at ``offset`` over a small complex noise floor
    (Impulse.m:13-40)."""

    offset: int = 0
    amplitude: float = 1.0
    noise: float = 1e-6
    seed: int = 0

    def generate(self, start: int, n: int) -> np.ndarray:
        if self.noise != 0:
            x = self.noise * _tiled_noise(jax.random.key(self.seed), start, n)
        else:
            x = np.zeros(n, dtype=np.complex64)
        if start <= self.offset < start + n:
            x = np.array(x)
            x[self.offset - start] = self.amplitude
        return x.astype(np.complex64)[None, None, :]


@dataclasses.dataclass
class SquareWave(SignalGenerator):
    """Amplitude-modulated complex noise: on-pulse std sqrt(on_amp/2) per
    quadrature for the first duty_cycle of each period (SquareWave.m:14-63)."""

    period: int = 26
    duty_cycle: float = 0.5
    on_amp: float = 1.0
    off_amp: float = 0.0
    seed: int = 0

    def generate(self, start: int, n: int) -> np.ndarray:
        t = np.arange(start, start + n, dtype=np.int64)
        ioff = int(np.floor(self.period * self.duty_cycle))
        on = (t % self.period) < ioff
        amp = np.where(on, np.sqrt(self.on_amp * 0.5), np.sqrt(self.off_amp * 0.5))
        noise = _tiled_noise(jax.random.key(self.seed), start, n)
        return (amp.astype(np.float32) * noise).astype(np.complex64)[None, None, :]


@dataclasses.dataclass
class FrequencyComb(SignalGenerator):
    """Sum of phase-continuous tones with an amplitude slope
    (FrequencyComb.m:11-48; sgcht.m:492-530 builds 32 harmonics with
    amplitudes linspace(1, sqrt(2)))."""

    amplitudes: Sequence[float] = ()
    frequencies: Sequence[float] = ()

    @classmethod
    def standard(cls, nharmonic: int = 32, fmin: Optional[float] = None,
                 fmax: Optional[float] = None) -> "FrequencyComb":
        amplitudes = np.linspace(1.0, np.sqrt(2.0), nharmonic)
        if fmin is None:
            fmin = -0.5 + 1.0 / (nharmonic * 4)
        if fmax is None:
            fmax = fmin + (nharmonic - 1.0) / nharmonic
        frequencies = np.linspace(fmin, fmax, nharmonic)
        return cls(tuple(amplitudes), tuple(frequencies))

    def generate(self, start: int, n: int) -> np.ndarray:
        t = np.arange(start, start + n, dtype=np.float64)
        x = np.zeros(n, dtype=np.complex128)
        for a, f in zip(self.amplitudes, self.frequencies):
            x += a * np.exp(2j * np.pi * ((f * t) % 1.0))
        return x.astype(np.complex64)[None, None, :]


@dataclasses.dataclass
class FrequencyWedge(SignalGenerator):
    """Broadband noise with a sqrt-linear spectral slope, generated per
    ``resolution``-sample segment through an IFFT of sloped complex-noise
    spectra (FrequencyWedge.m:13-61). Each segment's spectrum is keyed by its
    absolute segment index, so blocking doesn't change the stream."""

    resolution: int = 1024 * 1024
    seed: int = 0

    def _segment(self, seg_idx: int) -> np.ndarray:
        from ..ops import cfft

        k = jax.random.fold_in(jax.random.key(self.seed), seg_idx)
        r = jax.random.normal(k, (2, self.resolution), dtype=jnp.float32)
        slope = jnp.asarray(
            np.sqrt(np.fft.fftshift(np.linspace(0, 1, self.resolution))).astype(
                np.float32
            )
        )
        br, bi = cfft.ifft(slope * r[0], slope * r[1])
        return cfft.combine(br, bi)

    def generate(self, start: int, n: int) -> np.ndarray:
        out = []
        pos = start
        remaining = n
        while remaining > 0:
            seg = pos // self.resolution
            off = pos - seg * self.resolution
            take = min(remaining, self.resolution - off)
            out.append(self._segment(seg)[off: off + take])
            pos += take
            remaining -= take
        x = np.concatenate(out) if len(out) > 1 else out[0]
        return x.astype(np.complex64)[None, None, :]


@dataclasses.dataclass
class GaussianNoise(SignalGenerator):
    """Flat complex noise (the reference harness's ``generate_test_vector
    func='noise'`` backend, generate_test_vector.py)."""

    scale: float = 1.0
    seed: int = 0
    n_pol: int = 1

    def generate(self, start: int, n: int) -> np.ndarray:
        key = jax.random.key(self.seed)
        pols = [
            self.scale * _tiled_noise(jax.random.fold_in(key, 1000 + p), start, n)
            for p in range(self.n_pol)
        ]
        return np.stack(pols)[:, None, :].astype(np.complex64)


class DADAReadGenerator(SignalGenerator):
    """File-backed generator (DADARead.m): successive generate calls stream
    through a DADA file; honors the LowCBF heap format via the io layer."""

    def __init__(self, path: str):
        from ..io import dada

        self.path = path
        self.header = dada.read_header(path)
        self.n_pol = int(self.header.get("NPOL", 1))
        self.n_chan = int(self.header.get("NCHAN", 1))

    def generate(self, start: int, n: int) -> np.ndarray:
        from ..io import dada

        data, _ = dada.load(self.path, count=n, offset_samples=start)
        return data


def make_generator(name: str, header: dict, *, n_chan: int = 1,
                   tsamp: Optional[float] = None, **kwargs) -> SignalGenerator:
    """Construct a generator the way sgcht does from a signal name and header
    template (sgcht.m:360-477): square_wave period from CALFREQ, tone
    frequency from TONEFREQ, etc."""
    tsamp = float(header.get("TSAMP", 1.0)) if tsamp is None else tsamp
    if name == "square_wave":
        calfreq = float(header.get("CALFREQ", 1.0))  # Hz
        period = int(round(1e6 / (calfreq * tsamp)))
        return SquareWave(period=period, **kwargs)
    if name == "complex_sinusoid":
        tonefreq = float(header.get("TONEFREQ", 250000.0))  # kHz
        return PureTone(frequency=(tonefreq * tsamp) / 1e6, **kwargs)
    if name == "temporal_impulse":
        return Impulse(offset=kwargs.pop("offset", 20000), **kwargs)
    if name == "frequency_comb":
        return FrequencyComb.standard(**kwargs)
    if name == "frequency_wedge":
        return FrequencyWedge(**kwargs)
    if name == "noise":
        return GaussianNoise(**kwargs)
    raise ValueError(f"unrecognized signal: {name}")
