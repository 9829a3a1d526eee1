"""Two-stage filterbank cascades.

JAX equivalent of TwoStageFilterBank.m:1-118 and
TwoStageInverseFilterBank.m:1-159: a first-stage coarse channelizer feeding
per-coarse-channel second-stage channelizers (and the inverse cascade).

Design departure: the reference instantiates an *array of stage-2 objects*
and loops over coarse channels; here all coarse channels run through one
batched kernel invocation (the channel axis is just another batch axis of
the analysis kernel), which is both the natural XLA formulation and the
axis the sharded pipeline partitions across devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .streaming import (
    FilterBank,
    FilterBankState,
    InverseFilterBank,
    InverseFilterBankState,
)
from ..utils.rational import Rational


@dataclasses.dataclass
class TwoStageFilterBankState:
    stage1: FilterBankState
    stage2: FilterBankState  # one batched state for all coarse channels


class TwoStageFilterBank:
    """Stage-1 coarse channelizer + batched stage-2 fine channelizers.

    critical: keep only the critically sampled subset of stage-2 channels,
    chomping the oversampled middle (TwoStageFilterBank.m:81-105).
    single: process/output only coarse channel 0 (:87-89).
    """

    def __init__(self, config, config2=None, *, critical=False, single=False,
                 **fb_kwargs):
        self.config1 = config
        self.config2 = config2 if config2 is not None else config
        self.stage1 = FilterBank(config, **fb_kwargs)
        self.stage2 = FilterBank(self.config2, **fb_kwargs)
        self.critical = critical
        self.single = single

    @property
    def stage2_monotonic(self) -> bool:
        """Stage-2 channels in fftshifted (monotonic-frequency) order —
        true for the LowCBF firmware model (ops/lowcbf.py)."""
        return (self.config2.analysis_function
                == "polyphase_analysis_lowcbf")

    def set_stage2_config(self, config2):
        self.config2 = config2
        self.stage2 = FilterBank(config2)

    def init_state(self) -> TwoStageFilterBankState:
        return TwoStageFilterBankState(
            self.stage1.init_state(), self.stage2.init_state()
        )

    def execute(
        self, state: TwoStageFilterBankState, x: np.ndarray
    ) -> Tuple[TwoStageFilterBankState, np.ndarray]:
        s1, out1 = self.stage1.execute(state.stage1, x)  # (n_pol, nch1, T)

        nch1 = 1 if self.single else out1.shape[1]
        os = Rational.coerce(self.stage1.os_factor)
        # channels the stage-2 kernel actually emits: the LowCBF firmware
        # model already outputs only its critically-sampled subset
        # (216 = 256*27/32, polyphase_analysis_lowcbf.m:16,43), in which
        # case the critical chomp below is a no-op
        nch2_orig = self.stage2.n_chan_out
        nch2 = (
            os.normalize(self.stage2.n_chan) if self.critical else nch2_orig
        )
        offset = nch2_orig - nch2

        # batched stage 2: coarse channels ride the batch (pol) axis of the
        # analysis kernel: (n_pol*nch1, T)
        n_pol = out1.shape[0]
        streams = out1[:, :nch1, :].reshape(n_pol * nch1, out1.shape[2])
        s2, out2 = self.stage2.execute(state.stage2, streams[:, None, :])
        # out2: (n_pol*nch1, nch2_orig, T2)
        t2 = out2.shape[2]
        out2 = out2.reshape(n_pol, nch1, nch2_orig, t2)

        if self.critical and offset > 0:
            if self.stage2_monotonic:
                # LowCBF stage 2 emits its KEPT channels fftshifted
                # (monotonic frequency order, DC at the middle —
                # ops/lowcbf.py): the oversampling-redundant channels are
                # the BAND EDGES, offset/2 each end. The reference's
                # generic middle-chomp (below) assumes DC-first order —
                # applied here it would discard the DC-adjacent fine
                # channels of every coarse channel (its own source notes
                # the fftshifted variant, TwoStageFilterBank.m:106-107,
                # commented out). See docs/src/divergences.rst.
                out2 = out2[:, :, offset // 2: offset // 2 + nch2, :]
            else:
                # chomp oversampled middle channels; stage-2 channel 0 is
                # DC and nch2/2 is Nyquist (TwoStageFilterBank.m:102-105).
                # The matlab 1-based overlapping assignment keeps tmp[j]
                # for j<nch2/2-1 and tmp[j+offset] for j>=nch2/2-1 (second
                # write wins at the seam).
                half = nch2 // 2
                low = out2[:, :, : half - 1, :]
                high = out2[:, :, half - 1 + offset: nch2 + offset, :]
                out2 = np.concatenate([low, high], axis=2)

        out = out2.reshape(n_pol, nch1 * out2.shape[2], t2)
        return TwoStageFilterBankState(s1, s2), out


@dataclasses.dataclass
class TwoStageInverseFilterBankState:
    stage2: InverseFilterBankState


class TwoStageInverseFilterBank:
    """Per-coarse-channel inverse cascade (TwoStageInverseFilterBank.m).

    Detects critical vs oversampled input from the per-coarse-channel count
    (:100-115) and feeds ``nch2*combine``-channel slabs through a batched
    Golden inversion.
    """

    def __init__(self, config, config2=None, *, single=False, combine=1,
                 nch2: Optional[int] = None):
        self.config1 = config
        self.config2 = config2 if config2 is not None else config
        self.single = single
        self.combine = combine
        self.nch2 = nch2 if nch2 is not None else self.config2.channels
        self.spectral_taper = "no_window"

    def frequency_taper(self, name: str) -> "TwoStageInverseFilterBank":
        self.spectral_taper = name
        return self

    def init_state(self) -> TwoStageInverseFilterBankState:
        os = Rational.coerce(self.config2.os_factor)
        critical_nchan = os.normalize(self.config2.channels)
        monotonic = (self.config2.analysis_function
                     == "polyphase_analysis_lowcbf")
        # a LowCBF stage 2 emits its KEPT (216) channel subset, fftshifted
        # (ops/lowcbf.py) — that count is its "oversampled" full set
        full_nchan = (
            (self.config2.kept_channels or self.config2.channels)
            if monotonic else self.config2.channels
        )
        if self.nch2 == critical_nchan:
            critical = True
        elif self.nch2 == full_nchan:
            critical = False
            if self.combine > 1:
                raise ValueError("cannot combine oversampled coarse channels")
        else:
            raise ValueError(
                f"invalid per-coarse channel count {self.nch2}: stage2 has "
                f"{full_nchan} ({critical_nchan} critical)"
            )
        self._critical = critical
        self._inv = InverseFilterBank(
            self.config2,
            critical=critical,
            combine=self.combine,
            spectral_taper=self.spectral_taper,
            monotonic=monotonic,
        )
        return TwoStageInverseFilterBankState(self._inv.init_state())

    def execute(
        self, state: TwoStageInverseFilterBankState, x: np.ndarray
    ) -> Tuple[TwoStageInverseFilterBankState, np.ndarray]:
        n_pol, nchan, n_dat = x.shape
        nch_in = self.nch2 * self.combine
        nch_out = nchan // nch_in
        if self.single:
            nch_out = 1
        # batch coarse channels: (n_pol*nch_out, nch_in, T)
        slabs = x[:, : nch_out * nch_in, :].reshape(n_pol * nch_out, nch_in, n_dat)
        s2, inv = self._inv.execute(state.stage2, slabs)
        # inv: (n_pol*nch_out, 1, T_out) → (n_pol, nch_out, T_out)
        out = inv.reshape(n_pol, nch_out, inv.shape[2])
        return TwoStageInverseFilterBankState(s2), out
