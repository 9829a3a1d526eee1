"""Two-stage filterbank cascade + combine inversion under time sharding.

Sharded equivalent of :mod:`ska_pst_dsp.models.two_stage`
(TwoStageFilterBank.m:92-110, TwoStageInverseFilterBank.m:124-151,
polyphase_synthesis.m:198-238 for combine): the stage-1 coarse channelizer
runs the existing halo-exchange sharded analysis; stage 2 batches every
coarse channel onto the kernel's batch axis (the same batching the models
use) and runs EITHER the sharded plain analysis or the sharded LowCBF
firmware-model filterbank; the critical chomp and the combined Golden
inversion mirror the models at the array level so one-shot model execution
and the sharded pipeline agree numerically (asserted by dryrun_multichip's
sps+lowpsi leg on the virtual mesh).

Sharding choices: all cross-shard dependencies are single right-halo
ppermute exchanges over the time axis (nearest-neighbour);
alignment padding feeds zeros to tail blocks that are sliced off, never
re-partitioning mid-chain except at the stage boundaries where XLA inserts
the resharding collective itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import lowcbf as _lowcbf
from ..utils import geometry
from ..utils.rational import Rational
from .sharded import (
    Pair,
    _as_pair,
    _right_halo,
    sharded_polyphase_analysis,
    sharded_polyphase_synthesis,
)


def sharded_lowcbf_analysis(
    x,
    filt,
    mesh: Mesh,
    *,
    first_call: bool = True,
    axis: str = "time",
) -> Pair:
    """Time-sharded LowCBF firmware-model filterbank
    (polyphase_analysis_lowcbf.m:16-48). The quarter-turn derotation
    schedule has period 4 in the absolute output index, so shards sized to
    a multiple of 4*STEP all share one derotation table; the first-call
    1536-sample zero pad and any alignment pad are applied globally before
    sharding (XLA reshards) and the tail garbage blocks are sliced off.

    x: (batch, n_dat) pair/complex. Returns (batch, 216, n_out) pair."""
    xr, xi = _as_pair(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    n_dev = mesh.devices.size
    if first_call:
        xr = jnp.pad(xr, [(0, 0), (_lowcbf.FIRST_CALL_PAD, 0)])
        xi = jnp.pad(xi, [(0, 0), (_lowcbf.FIRST_CALL_PAD, 0)])
    n_dat = xr.shape[1]
    n_out = (n_dat - _lowcbf.NFILT) // _lowcbf.STEP
    # shards must be 4*STEP-aligned AND at least NFILT long: the halo is a
    # single-neighbour ppermute, so it can deliver at most one shard
    unit = _lowcbf.STEP * 4
    per_dev = -(-n_dat // n_dev)
    shard = -(-per_dev // unit) * unit
    shard = max(shard, -(-_lowcbf.NFILT // unit) * unit)
    pad = shard * n_dev - n_dat
    if pad:
        xr = jnp.pad(xr, [(0, 0), (0, pad)])
        xi = jnp.pad(xi, [(0, 0), (0, pad)])

    taps2d = np.asarray(filt, dtype=np.float64).ravel()[: _lowcbf.NFILT]
    taps2d = jnp.asarray(
        taps2d.reshape(_lowcbf.TAPS, _lowcbf.BLOCK).astype(np.float32)
    )
    scale = (2.0 ** 9 * 2048 * 256) / (2.0 ** 9 * 128.0)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(None, axis), P(None, axis)), P(None, None)),
        out_specs=(P(None, None, axis), P(None, None, axis)),
    )
    def run(pair, taps_local):
        lr, li = pair
        hr = _right_halo(lr, _lowcbf.NFILT, axis)
        hi = _right_halo(li, _lowcbf.NFILT, axis)
        xer = jnp.concatenate([lr, hr], axis=-1)
        xei = jnp.concatenate([li, hi], axis=-1)
        # shard % 4*STEP == 0 ⇒ every shard's s % 4 schedule is identical
        return _lowcbf._lowcbf_core(xer, xei, taps_local, scale=scale)

    rr, ri = run((xr, xi), taps2d)
    return rr[:, :, :n_out], ri[:, :, :n_out]


def sharded_two_stage_round_trip(
    x,
    cfg1,
    cfg2,
    mesh: Mesh,
    *,
    critical: bool = True,
    combine: int = 1,
    invert: bool = True,
    axis: str = "time",
) -> Pair:
    """Stage-1 analysis → batched stage-2 (plain or LowCBF) → critical
    chomp → combined stage-2 Golden inversion, all time-sharded. Mirrors
    models.two_stage's array semantics; returns the (re, im) pair of
    (n_pol, n_coarse_out, T_out) — or the channelized
    (n_pol, c1*nch2, T2) pair when ``invert=False``."""
    os1 = Rational.coerce(cfg1.os_factor)
    os2 = Rational.coerce(cfg2.os_factor)
    filt1 = cfg1.load_fir_filter_coeff()
    filt2 = cfg2.load_fir_filter_coeff()
    c1 = cfg1.channels
    xr, xi = _as_pair(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    n_pol, n_dat = xr.shape

    # ---- stage 1: coarse channelizer (plain or LowCBF firmware) -----
    if cfg1.analysis_function == "polyphase_analysis_lowcbf":
        s1r, s1i = sharded_lowcbf_analysis(
            (xr, xi), filt1, mesh, first_call=True, axis=axis
        )
        c1 = _lowcbf.KEPT
    else:
        step1 = geometry.analysis_step(c1, os1)
        quantum1 = mesh.devices.size * step1 * os1.nu
        pad1 = (-n_dat) % quantum1
        if pad1:
            xr = jnp.pad(xr, [(0, 0), (0, pad1)])
            xi = jnp.pad(xi, [(0, 0), (0, pad1)])
        fl1 = geometry.padded_filter_length(int(np.asarray(filt1).size), c1)
        nb1 = (n_dat - fl1) // step1
        s1r, s1i = sharded_polyphase_analysis(
            (xr, xi), filt1, c1, os1, mesh, axis=axis
        )
        s1r, s1i = s1r[:, :, :nb1], s1i[:, :, :nb1]

    # ---- stage 2: batched fine channelizers -------------------------
    # coarse channels ride the batch axis (models/two_stage.py batching)
    t1 = s1r.shape[2]
    b = n_pol * c1
    s1r = s1r.reshape(b, t1)
    s1i = s1i.reshape(b, t1)
    use_lowcbf = cfg2.analysis_function == "polyphase_analysis_lowcbf"
    if use_lowcbf:
        s2r, s2i = sharded_lowcbf_analysis(
            (s1r, s1i), filt2, mesh, first_call=True, axis=axis
        )
        nch2_orig = _lowcbf.KEPT
    else:
        step2 = geometry.analysis_step(cfg2.channels, os2)
        quantum2 = mesh.devices.size * step2 * os2.nu
        pad2 = (-t1) % quantum2
        if pad2:
            s1r = jnp.pad(s1r, [(0, 0), (0, pad2)])
            s1i = jnp.pad(s1i, [(0, 0), (0, pad2)])
        fl2 = geometry.padded_filter_length(
            int(np.asarray(filt2).size), cfg2.channels
        )
        nb2 = (t1 - fl2) // step2
        s2r, s2i = sharded_polyphase_analysis(
            (s1r, s1i), filt2, cfg2.channels, os2, mesh, axis=axis
        )
        s2r, s2i = s2r[:, :, :nb2], s2i[:, :, :nb2]
        nch2_orig = cfg2.channels
    t2 = s2r.shape[2]
    s2r = s2r.reshape(n_pol, c1, nch2_orig, t2)
    s2i = s2i.reshape(n_pol, c1, nch2_orig, t2)

    # ---- critical chomp (TwoStageFilterBank.m:102-105; the target
    # count is STAGE 1's critical ratio, as in models/two_stage.py — for
    # the LowCBF stage 2 the firmware already emits exactly that subset
    # and the chomp is a no-op) ---------------------------------------
    nch2 = os1.normalize(cfg2.channels) if critical else nch2_orig
    offset = nch2_orig - nch2
    if critical and offset > 0:
        if use_lowcbf:
            # monotonic (fftshifted) KEPT stream: chomp the band EDGES,
            # offset/2 each end (models/two_stage.py, divergences.rst)
            s2r = s2r[:, :, offset // 2: offset // 2 + nch2, :]
            s2i = s2i[:, :, offset // 2: offset // 2 + nch2, :]
        else:
            half = nch2 // 2
            low = s2r[:, :, : half - 1, :], s2i[:, :, : half - 1, :]
            high = (
                s2r[:, :, half - 1 + offset: nch2 + offset, :],
                s2i[:, :, half - 1 + offset: nch2 + offset, :],
            )
            s2r = jnp.concatenate([low[0], high[0]], axis=2)
            s2i = jnp.concatenate([low[1], high[1]], axis=2)

    if not invert:
        return (
            s2r.reshape(n_pol, c1 * s2r.shape[2], t2),
            s2i.reshape(n_pol, c1 * s2i.shape[2], t2),
        )

    # ---- combined stage-2 inversion (critical/oversampled detection
    # as in models.two_stage.TwoStageInverseFilterBank) ---------------
    if nch2 == os2.normalize(cfg2.channels):
        inv_critical = True
    elif nch2 == cfg2.channels:
        inv_critical = False
        if combine > 1:
            raise ValueError("cannot combine oversampled coarse channels")
    else:
        raise ValueError(
            f"invalid per-coarse channel count {nch2} for inversion"
        )
    nch_in = nch2 * combine
    nch_out = (c1 * nch2) // nch_in
    # c1 need not divide into combine-slabs (lowpsi: 216 % 16 != 0) —
    # drop the tail coarse channels exactly as models/two_stage.py does
    s2r = s2r.reshape(n_pol, c1 * nch2, t2)[:, : nch_out * nch_in]
    s2i = s2i.reshape(n_pol, c1 * nch2, t2)[:, : nch_out * nch_in]
    slabs_r = s2r.reshape(n_pol * nch_out, nch_in, t2)
    slabs_i = s2i.reshape(n_pol * nch_out, nch_in, t2)
    geom2 = geometry.SynthesisGeometry(
        nch_in, cfg2.input_fft_length, cfg2.input_overlap, os2
    )
    quantum_s = mesh.devices.size * geom2.input_keep
    pad_s = (-t2) % quantum_s
    if pad_s:
        slabs_r = jnp.pad(slabs_r, [(0, 0), (0, 0), (0, pad_s)])
        slabs_i = jnp.pad(slabs_i, [(0, 0), (0, 0), (0, pad_s)])
    inv_r, inv_i = sharded_polyphase_synthesis(
        (slabs_r, slabs_i), cfg2.input_fft_length, os2, mesh,
        input_overlap=cfg2.input_overlap,
        deripple_coeff=filt2 if cfg2.deripple else None,
        temporal_taper=cfg2.temporal_taper,
        spans_nyquist=not inv_critical,
        combine=combine,
        monotonic=use_lowcbf,
        axis=axis,
    )
    valid = geom2.n_blocks(t2) * geom2.output_keep
    inv_r = inv_r[:, :, :valid].reshape(n_pol, nch_out, -1)
    inv_i = inv_i[:, :, :valid].reshape(n_pol, nch_out, -1)
    return inv_r, inv_i
