"""Sharded (multi-device) PFB pipeline.

The reference is single-threaded Matlab; its latent parallel axes (SURVEY
§2.9) become mesh axes here:

* **time blocks** — overlap-save processing is embarrassingly parallel given
  each shard a halo of neighbor samples: the analysis needs the next
  ``padded_taps`` samples (filter history), the padded variant the previous
  ``padded_taps``, the synthesis the next ``2*overlap`` fine-channel
  samples. Halos move over the device interconnect via ``jax.lax.ppermute`` inside
  ``shard_map`` — the sharded equivalent of the reference's serial buffered
  carry (FilterBank.m:85-126).
* **polarization / coarse channel** — pure batch axes (vmap/reshape).

Position-independence: the analysis phase-ramp schedule ``step*k mod block``
has period ``nu`` in k (because step*nu = block*de ≡ 0 mod block), so shards
whose block counts are multiples of ``nu`` all run the *identical* kernel
with block0=0 — no per-shard state, bit-identical to one-shot output. This
is the same invariant the streaming layer relies on (FilterBank.m:93-104).

Data are split-complex throughout (pairs of float32 arrays) — pairs are
ordinary pytrees to shard_map.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import analysis as _analysis
from ..ops import synthesis as _synthesis
from ..ops import cfft
from ..utils import geometry, windows
from ..utils.rational import Rational

Pair = Tuple[jax.Array, jax.Array]


def make_mesh(n_devices: Optional[int] = None, axis: str = "time") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _right_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Prefix of the *next* shard (zeros for the last shard)."""
    n = jax.lax.axis_size(axis_name)
    prefix = x[..., :halo]
    return jax.lax.ppermute(
        prefix, axis_name, perm=[(i, i - 1) for i in range(1, n)]
    )


def _left_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Suffix of the *previous* shard (zeros for the first shard)."""
    n = jax.lax.axis_size(axis_name)
    suffix = x[..., -halo:]
    return jax.lax.ppermute(
        suffix, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
    )


def _as_pair(x) -> Pair:
    if isinstance(x, tuple):
        return jnp.asarray(x[0]), jnp.asarray(x[1])
    if hasattr(x, "ndim") and np.iscomplexobj(x):
        return cfft.split(x)
    x = jnp.asarray(x)
    return x, jnp.zeros_like(x)


def sharded_polyphase_analysis(
    x,
    filt,
    block: int,
    os_factor,
    mesh: Mesh,
    *,
    axis: str = "time",
) -> Pair:
    """Time-sharded single-stage analysis PFB.

    x: (n_pol, n_dat) pair/complex with n_dat divisible by
    n_devices*step*nu. Returns an (re, im) pair of (n_pol, block,
    n_dat//step) spectra; entries past geometry.analysis_nblocks are tail
    garbage computed from the zero halo — callers slice.
    """
    os_factor = Rational.coerce(os_factor)
    xr, xi = _as_pair(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    step = geometry.analysis_step(block, os_factor)
    n_dev = mesh.devices.size
    n_pol, n_dat = xr.shape
    shard = n_dat // n_dev
    if shard % (step * os_factor.nu):
        raise ValueError(
            f"shard size {shard} must be a multiple of step*nu = "
            f"{step * os_factor.nu}"
        )
    f2d = jnp.asarray(_analysis._prep_filter(filt, block))
    fl = f2d.shape[0] * block
    halo = fl

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(None, axis), P(None, axis)), P(None, None)),
        out_specs=(P(None, None, axis), P(None, None, axis)),
    )
    def run(pair, f2d_local):
        lr, li = pair
        hr = _right_halo(lr, halo, axis)
        hi = _right_halo(li, halo, axis)
        xer = jnp.concatenate([lr, hr], axis=-1)
        xei = jnp.concatenate([li, hi], axis=-1)
        # every shard starts at a nu-aligned block ⇒ identical ramp (k0=0)
        return _analysis._analysis_core(
            xer, xei, f2d_local, block=block, step=step, k0=0
        )

    rr, ri = run((xr, xi), f2d)
    return rr[:, :, : n_dat // step], ri[:, :, : n_dat // step]


def sharded_polyphase_analysis_padded(
    x,
    filt,
    block: int,
    os_factor,
    mesh: Mesh,
    *,
    axis: str = "time",
    apply_delay: bool = True,
) -> Pair:
    """Time-sharded zero-padded analysis PFB: halo is the *previous* shard's
    filter history; the first shard's zero history is the kernel's own zero
    padding (true stream start)."""
    os_factor = Rational.coerce(os_factor)
    xr, xi = _as_pair(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    step = geometry.analysis_step(block, os_factor)
    n_dev = mesh.devices.size
    n_pol, n_dat = xr.shape
    shard = n_dat // n_dev
    if shard % (step * os_factor.nu):
        raise ValueError(
            f"shard size {shard} must be a multiple of step*nu = "
            f"{step * os_factor.nu}"
        )
    f2d_rev = jnp.asarray(_analysis._prep_filter(filt, block, reverse=True))
    fl = f2d_rev.shape[0] * block
    # history ≥ fl, in whole blocks, and a multiple of nu blocks so that
    # dropping the recomputed history blocks keeps the ramp schedule aligned
    halo_blocks = -(-fl // step)
    halo_blocks += (-halo_blocks) % os_factor.nu
    halo = halo_blocks * step

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(None, axis), P(None, axis)), P(None, None)),
        out_specs=(P(None, None, axis), P(None, None, axis)),
    )
    def run(pair, f2d_local):
        lr, li = pair
        hr = _left_halo(lr, halo, axis)
        hi = _left_halo(li, halo, axis)
        xer = jnp.concatenate([hr, lr], axis=-1)
        xei = jnp.concatenate([hi, li], axis=-1)
        raw_r, raw_i = _analysis._analysis_padded_core(
            xer, xei, f2d_local, block=block, step=step, k0=0, delay=0
        )
        # shard 0's true history is zeros — exactly what its halo received
        # (non-circular ppermute) — so dropping the recomputed history
        # blocks is correct for every shard.
        return raw_r[:, :, halo_blocks:], raw_i[:, :, halo_blocks:]

    rr, ri = run((xr, xi), f2d_rev)
    if apply_delay:
        delay = geometry.padded_sample_delay_shift(
            int(np.asarray(filt).size), block, os_factor
        )
        rr = jnp.roll(rr, -delay, axis=2)
        ri = jnp.roll(ri, -delay, axis=2)
    return rr, ri


def sharded_polyphase_synthesis(
    x,
    input_fft_length: int,
    os_factor,
    mesh: Mesh,
    *,
    input_overlap: Optional[int] = None,
    deripple_coeff=None,
    temporal_taper: str = "no_window",
    spectral_taper: str = "no_window",
    spans_nyquist: bool = True,
    combine: int = 1,
    monotonic: bool = False,
    axis: str = "time",
) -> Pair:
    """Time-sharded Golden inversion: each shard inverts its own overlap-save
    blocks after receiving a 2*overlap fine-channel halo from the next shard.
    ``combine`` applies the combined-inversion channel reordering
    (polyphase_synthesis.m:198-238) — the permutation is shard-local
    (channel axis is replicated), so nothing else changes under sharding.

    x: (n_pol, n_chan, n_dat) pair/complex with n_dat divisible by
    n_devices*input_keep. Returns the (re, im) pair of
    (n_pol, 1, n_blocks*output_keep) — identical to the one-shot kernel.
    """
    os_factor = Rational.coerce(os_factor)
    xr, xi = _as_pair(x)
    n_pol, n_chan, n_dat = xr.shape
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    keep = geom.input_keep
    n_dev = mesh.devices.size
    shard = n_dat // n_dev
    if shard % keep:
        raise ValueError(f"shard size {shard} must be a multiple of input_keep={keep}")

    t_vec = jnp.asarray(windows.build(temporal_taper, L, input_overlap))
    s_vec = jnp.asarray(
        windows.build(spectral_taper, n_chan * geom.fn_width, input_overlap)
    )
    if deripple_coeff is not None:
        from ..design.fir import deripple_response

        drip = deripple_response(deripple_coeff, n_chan, geom.fn_width // 2)
        drip = jnp.asarray(drip.astype(np.float32))
    else:
        drip = jnp.ones(geom.fn_width, dtype=jnp.float32)
    from ..ops.synthesis import combine_channel_permutation

    perm = jnp.asarray(
        (np.arange(n_chan) if monotonic
         else combine_channel_permutation(n_chan, combine)).astype(np.int32)
    )
    geom_key = (n_chan, L, input_overlap, os_factor.nu, os_factor.de)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            (P(None, None, axis), P(None, None, axis)),
            P(None), P(None), P(None), P(None),
        ),
        out_specs=(P(None, None, axis), P(None, None, axis)),
    )
    def run(pair, t_local, s_local, dr_local, perm_local):
        lr, li = pair
        hr = _right_halo(lr, 2 * input_overlap, axis)
        hi = _right_halo(li, 2 * input_overlap, axis)
        xer = jnp.concatenate([lr, hr], axis=-1)
        xei = jnp.concatenate([li, hi], axis=-1)
        return _synthesis._synthesis_core(
            xer, xei, t_local, s_local, dr_local, perm_local,
            geom_key=geom_key, spans_nyquist=spans_nyquist,
        )

    rr, ri = run((xr, xi), t_vec, s_vec, drip, perm)
    # the last shard's final block used zero halo — trim to one-shot count
    valid = geom.n_blocks(n_dat) * geom.output_keep
    return rr[:, :, :valid], ri[:, :, :valid]


def sharded_round_trip(
    x,
    filt,
    n_chan: int,
    os_factor,
    input_fft_length: int,
    input_overlap: int,
    mesh: Mesh,
    *,
    temporal_taper: str = "tukey",
    deripple: bool = True,
) -> Pair:
    """Full sharded pipeline: time-sharded analysis → time-sharded Golden
    inversion (the flagship 'one step' of this framework)."""
    os_factor = Rational.coerce(os_factor)
    cr, ci = sharded_polyphase_analysis(x, filt, n_chan, os_factor, mesh)
    n_dev = mesh.devices.size
    keep = input_fft_length - 2 * input_overlap
    xr, _ = _as_pair(x)
    n_dat = xr.shape[-1]
    # trim fine-channel stream so each shard gets whole inversion blocks
    t_valid = geometry.analysis_nblocks(
        n_dat, int(np.asarray(filt).size), n_chan, os_factor
    )
    t_shard = (t_valid // (n_dev * keep)) * keep
    spec = NamedSharding(mesh, P(None, None, "time"))
    cr = jax.lax.with_sharding_constraint(cr[:, :, : t_shard * n_dev], spec)
    ci = jax.lax.with_sharding_constraint(ci[:, :, : t_shard * n_dev], spec)
    return sharded_polyphase_synthesis(
        (cr, ci),
        input_fft_length,
        os_factor,
        mesh,
        input_overlap=input_overlap,
        deripple_coeff=filt if deripple else None,
        temporal_taper=temporal_taper,
    )


def sharded_round_trip_padded(
    x,
    filt,
    n_chan: int,
    os_factor,
    input_fft_length: int,
    input_overlap: int,
    mesh: Mesh,
    *,
    temporal_taper: str = "tukey",
    deripple: bool = True,
) -> Pair:
    """Full sharded SKA-Mid-style pipeline: time-sharded zero-padded
    analysis -> time-sharded Golden inversion. The mid chain's analog of
    :func:`sharded_round_trip`; the analysis output keeps the kernel's
    group-delay correction (``output_overlap - 1`` alignment downstream,
    tests/test_mid_production.py)."""
    os_factor = Rational.coerce(os_factor)
    cr, ci = sharded_polyphase_analysis_padded(
        x, filt, n_chan, os_factor, mesh
    )
    n_dev = mesh.devices.size
    keep = input_fft_length - 2 * input_overlap
    xr, _ = _as_pair(x)
    n_dat = xr.shape[-1]
    step = geometry.analysis_step(n_chan, os_factor)
    t_valid = n_dat // step
    t_shard = (t_valid // (n_dev * keep)) * keep
    spec = NamedSharding(mesh, P(None, None, "time"))
    cr = jax.lax.with_sharding_constraint(cr[:, :, : t_shard * n_dev], spec)
    ci = jax.lax.with_sharding_constraint(ci[:, :, : t_shard * n_dev], spec)
    return sharded_polyphase_synthesis(
        (cr, ci),
        input_fft_length,
        os_factor,
        mesh,
        input_overlap=input_overlap,
        deripple_coeff=filt if deripple else None,
        temporal_taper=temporal_taper,
    )
