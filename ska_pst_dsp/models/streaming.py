"""Streaming channelizer / de-channelizer layer.

JAX equivalent of the reference's stateful block-streaming classes
(FilterBank.m:65-126, InverseFilterBank.m:92-150): arbitrarily long streams
are processed in blocks, with unconsumed samples carried between calls so
that streamed output is *identical* to one-shot kernel output.

Design: state is an explicit immutable dataclass (buffer + absolute
counters) returned alongside each output — the functional idiom that both
``jax.lax.scan`` and sharded pipelines require. The jitted kernels see only
fixed shapes; Python-level carry logic runs on the host between kernel
launches (negligible next to the FFTs).

Invariants preserved from the reference:
* analysis output is truncated to a multiple of os_factor.nu spectra so the
  phase-ramp / derotation schedules restart cleanly (FilterBank.m:93-104);
* consumed input = emitted_spectra * step; the remainder (containing the
  filter history) is buffered (FilterBank.m:119-126);
* inversion consumes n_blocks*input_keep fine-channel samples, buffering the
  2*overlap overlap-save history (InverseFilterBank.m:104-135).

Deliberate departures (correctness over quirk):
* the padded (SKA-Mid) kernel streams with an explicit history carry, so
  streamed output exactly equals one-shot output; the reference re-zero-pads
  at every block boundary, corrupting a filter-length of spectra per block.
* the LowCBF first-call zero pad is accounted for in the consumed-sample
  arithmetic; the reference's generic formula drops half a filter of
  history on the first block boundary (compensated downstream by
  ``kludge_offset``).

Optional input/output integer rounding with rms scaling reproduces the
reference's quantization-study hooks (FilterBank.m:75-113, sgcht
rndInput/rmsInput/rndOutput/rmsOutput).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..ops import (
    polyphase_analysis,
    polyphase_analysis_padded,
    polyphase_analysis_lowcbf,
    polyphase_synthesis,
)
from ..ops.lowcbf import FIRST_CALL_PAD
from ..utils import geometry
from ..utils.rational import Rational


def _round_rms(x: np.ndarray, rms: float) -> np.ndarray:
    """Round to integers, optionally pre-scaling to a target rms
    (FilterBank.m:75-83). Host-side: quantization studies run on the
    streaming glue path."""
    scale = 1.0
    if rms > 0:
        std = np.sqrt(np.var(np.stack([x.real, x.imag])) * 2.0)
        scale = rms / std
    return (np.round(x.real * scale) + 1j * np.round(x.imag * scale)).astype(x.dtype)


@dataclasses.dataclass
class FilterBankState:
    """Carry between FilterBank.execute calls.

    ``buffer`` holds input samples from absolute position ``base`` onward
    that have not been fully consumed; ``emitted`` counts output spectra
    already produced (in the delayed timeline for the padded kernel)."""

    buffer: Optional[np.ndarray] = None  # (n_pol, 1, nbuf)
    base: int = 0                        # absolute sample index of buffer[0]
    emitted: int = 0                     # output spectra emitted so far


class FilterBank:
    """Streaming analysis filterbank (the reference's Channelizer role)."""

    def __init__(self, config, *, rnd_input=False, rms_input=0.0,
                 rnd_output=False, rms_output=0.0, chunk_spectra=None):
        self.config = config
        self.analysis_function = config.analysis_function
        self.filt_coeff = config.load_fir_filter_coeff()
        self.n_chan = config.channels
        self.os_factor = Rational.coerce(config.os_factor)
        self.step = geometry.analysis_step(self.n_chan, self.os_factor)
        self.fl = geometry.padded_filter_length(self.filt_coeff.size, self.n_chan)
        self.rnd_input = rnd_input or rms_input > 0
        self.rms_input = rms_input
        self.rnd_output = rnd_output or rms_output > 0
        self.rms_output = rms_output
        # fixed spectra emitted per kernel launch: the kernel then compiles
        # for exactly one input shape regardless of how callers block the
        # stream (XLA is trace-once; varying shapes would recompile per call)
        self.chunk_spectra = chunk_spectra

    def init_state(self) -> FilterBankState:
        return FilterBankState()

    @property
    def n_chan_out(self) -> int:
        if self.analysis_function == "polyphase_analysis_lowcbf":
            return self.config.kept_channels or 216
        return self.n_chan

    def execute(
        self, state: FilterBankState, x: np.ndarray
    ) -> Tuple[FilterBankState, np.ndarray]:
        """Process one block: returns (new_state, (n_pol, n_chan_out, n_out))."""
        x = np.asarray(x)
        if x.ndim == 2:
            x = x[:, None, :]
        if self.rnd_input:
            x = _round_rms(x, self.rms_input)
        if state.buffer is not None and state.buffer.shape[-1] > 0:
            x = np.concatenate([state.buffer, x], axis=2)
        n_dat = int(x.shape[2])
        nu = self.os_factor.nu
        name = self.analysis_function

        if self.chunk_spectra is None:
            # adapt once to the caller's first block size
            if name == "polyphase_analysis_lowcbf":
                usable = (n_dat + FIRST_CALL_PAD - 3072) // 192
            elif name == "polyphase_analysis_padded":
                usable = n_dat // self.step
            else:
                usable = (n_dat - self.fl) // self.step
            self.chunk_spectra = max(nu, (usable // nu) * nu)

        if name == "polyphase_analysis":
            step_fn = self._execute_plain
        elif name == "polyphase_analysis_padded":
            step_fn = self._execute_padded
        elif name == "polyphase_analysis_lowcbf":
            step_fn = self._execute_lowcbf
        else:
            raise ValueError(f"unknown analysis function {name!r}")

        outs = []
        while True:
            state, out, x = step_fn(state, x, nu)
            if out.shape[2] == 0:
                break
            outs.append(out)
        state = dataclasses.replace(state, buffer=x)
        if not outs:
            return state, _empty_out(x, self.n_chan_out)
        return state, (outs[0] if len(outs) == 1 else np.concatenate(outs, axis=2))

    # -- single-stage (Bunton) ------------------------------------------
    def _execute_plain(self, state, x, nu):
        K = self.chunk_spectra
        need = self.fl + K * self.step
        if x.shape[2] < need:
            return state, _empty_out(x, self.n_chan), x
        chunk = x[:, :, :need]
        out = np.asarray(polyphase_analysis(
            chunk, self.filt_coeff, self.n_chan, self.os_factor,
            block0=state.emitted,
        ))[:, :, :K]
        if self.rnd_output:
            out = _round_rms(out, self.rms_output)
        consumed = K * self.step
        state = FilterBankState(
            buffer=None,
            base=state.base + consumed,
            emitted=state.emitted + K,
        )
        return state, out, x[:, :, consumed:]

    # -- zero-padded (Gunaratne / SKA-Mid) ------------------------------
    def _execute_padded(self, state, x, nu):
        step, fl = self.step, self.fl
        K = self.chunk_spectra
        base = state.base
        delay = geometry.padded_sample_delay_shift(
            self.filt_coeff.size, self.n_chan, self.os_factor
        )
        raw0 = base // step
        need = state.emitted + delay     # next absolute raw block to emit
        n_emit = K
        # required local stream length to produce blocks up to need+K
        need_local_blocks = (need + n_emit) - raw0
        if x.shape[2] < need_local_blocks * step:
            return state, _empty_out(x, self.n_chan), x
        chunk = x[:, :, : need_local_blocks * step]
        raw = np.asarray(polyphase_analysis_padded(
            chunk, self.filt_coeff, self.n_chan, self.os_factor,
            block0=raw0, apply_delay=False,
        ))
        out = raw[:, :, need - raw0: need - raw0 + n_emit]
        if self.rnd_output:
            out = _round_rms(out, self.rms_output)
        emitted = state.emitted + n_emit
        # carry history fl before raw block (emitted+delay)
        new_base = max(0, (emitted + delay) * step - fl)
        new_base -= new_base % step
        new_base = min(new_base, base + x.shape[2])
        return (
            FilterBankState(buffer=None, base=new_base, emitted=emitted),
            out,
            x[:, :, new_base - base:],
        )

    # -- LowCBF firmware model ------------------------------------------
    def _execute_lowcbf(self, state, x, nu):
        first = state.base == 0 and state.emitted == 0
        pad = FIRST_CALL_PAD if first else 0
        K = self.chunk_spectra
        need = 3072 + K * 192 - pad
        if x.shape[2] < need:
            return state, _empty_out(x, self.n_chan_out), x
        chunk = x[:, :, :need]
        out = np.asarray(polyphase_analysis_lowcbf(
            chunk, self.filt_coeff, self.n_chan, self.os_factor,
            first_call=first,
        ))[:, :, :K]
        if self.rnd_output:
            out = _round_rms(out, self.rms_output)
        consumed = K * 192 - pad
        return (
            FilterBankState(
                buffer=None,
                base=state.base + consumed,
                emitted=state.emitted + K,
            ),
            out,
            x[:, :, consumed:],
        )


def _empty_out(x, n_chan_out):
    return np.zeros((x.shape[0], n_chan_out, 0), dtype=np.complex64)


@dataclasses.dataclass
class InverseFilterBankState:
    buffer: Optional[np.ndarray] = None  # (n_pol, n_chan, nbuf)
    consumed: int = 0                    # absolute fine-channel samples consumed


class InverseFilterBank:
    """Streaming PFB inversion (DeChannelizer), wrapping the Golden
    synthesis kernel with the reference's buffered-carry semantics."""

    def __init__(self, config, *, critical: bool = False, combine: int = 1,
                 sample_offset: int = 0, spectral_taper: str = "no_window",
                 deripple: Optional[bool] = None,
                 chunk_blocks: Optional[int] = None,
                 monotonic: bool = False):
        self.config = config
        self.filt_coeff = config.load_fir_filter_coeff()
        self.n_fft = config.input_fft_length
        self.n_chan = config.channels
        self.os_factor = Rational.coerce(config.os_factor)
        self.overlap = config.input_overlap
        self.deripple = bool(config.deripple) if deripple is None else deripple
        self.temporal_taper = config.temporal_taper
        self.spectral_taper = spectral_taper
        self.critical = critical
        self.combine = combine
        #: fine channels arrive in monotonic (fftshifted) frequency order
        #: — chomped LowCBF cascades; the DSB combine reordering is skipped
        self.monotonic = monotonic
        self.sample_offset = sample_offset
        self._offset_pending = sample_offset
        # fixed overlap-save blocks per kernel launch (single compiled shape)
        self.chunk_blocks = chunk_blocks

    def frequency_taper(self, name: str) -> "InverseFilterBank":
        """Install a spectral taper (InverseFilterBank.m:48-61)."""
        self.spectral_taper = name
        return self

    def init_state(self) -> InverseFilterBankState:
        self._offset_pending = self.sample_offset
        return InverseFilterBankState()

    def execute(
        self, state: InverseFilterBankState, x: np.ndarray
    ) -> Tuple[InverseFilterBankState, np.ndarray]:
        x = np.asarray(x)
        if state.buffer is not None and state.buffer.shape[-1] > 0:
            x = np.concatenate([state.buffer, x], axis=2)
        n_pol, n_chan, n_dat = x.shape

        offset = self._offset_pending
        keep = self.n_fft - 2 * self.overlap
        if self.chunk_blocks is None:
            avail = (n_dat - offset - 2 * self.overlap) // keep
            self.chunk_blocks = max(1, avail)
        B = self.chunk_blocks
        need = offset + 2 * self.overlap + B * keep

        outs = []
        while x.shape[2] >= need:
            chunk = x[:, :, :need]
            out = np.asarray(polyphase_synthesis(
                chunk,
                self.n_fft,
                self.os_factor,
                spans_nyquist=not self.critical,
                input_overlap=self.overlap,
                deripple_coeff=self.filt_coeff if self.deripple else None,
                sample_offset=offset,
                temporal_taper=self.temporal_taper,
                spectral_taper=self.spectral_taper,
                combine=self.combine,
                monotonic=self.monotonic,
            ))
            outs.append(out)
            consumed = offset + B * keep
            x = x[:, :, consumed:]
            state = InverseFilterBankState(
                buffer=None, consumed=state.consumed + consumed
            )
            if offset:
                offset = 0
                self._offset_pending = 0
                need = 2 * self.overlap + B * keep
        state = InverseFilterBankState(buffer=x, consumed=state.consumed)
        if not outs:
            return state, np.zeros((n_pol, 1, 0), dtype=np.complex64)
        return state, (outs[0] if len(outs) == 1 else np.concatenate(outs, axis=2))


class StatefulPipeline:
    """Convenience wrapper chaining streaming stages with held state —
    mirrors the reference's ``[obj, x] = execute(obj, x)`` block loop."""

    def __init__(self, *stages):
        self.stages = list(stages)
        self.states = [s.init_state() for s in stages]

    def execute(self, x):
        for i, stage in enumerate(self.stages):
            self.states[i], x = stage.execute(self.states[i], x)
        return x
