"""2-D mesh (channel × time) synthesis with an all-to-all corner turn.

The Golden inversion has two phases with opposite natural layouts
(SURVEY §2.9):

* per-fine-channel forward FFTs + passband selection + deripple — channel
  parallel (256–4096-way);
* full-band assembly + the big backward FFT — needs *all* channels of each
  overlap-save block.

On a ('chan', 'time') device mesh this becomes: phase 1 runs
channel-sharded; then a ``jax.lax.all_to_all`` over the 'chan' axis
redistributes from channel-sharded/block-replicated to
block-sharded/channel-complete — the channel↔time corner turn the reference
performs as an in-memory transpose (polyphase_synthesis.m:171-184, 253-278),
here riding the device interconnect; phase 2 runs block-parallel on whole
spectra.

The column-sliced DFT einsums are pinned to ``Precision.HIGHEST``: a
float32 dot may otherwise run in TF32 on a GPU, which breaks the -60 dB
purity requirement.

Output blocks end up distributed over both mesh axes
(PartitionSpec (None, None, ('time', 'chan'))), time-major.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cfft
from ..ops.framing import frame
from ..utils import geometry, windows
from ..utils.rational import Rational

Pair = Tuple[jax.Array, jax.Array]
HIGHEST = jax.lax.Precision.HIGHEST


def make_mesh_2d(n_chan_devices: int, n_time_devices: int) -> Mesh:
    devices = np.array(jax.devices()[: n_chan_devices * n_time_devices])
    return Mesh(devices.reshape(n_chan_devices, n_time_devices),
                ("chan", "time"))


def sharded_polyphase_analysis_2d(
    x,
    filt,
    block: int,
    os_factor,
    mesh: Mesh,
) -> Pair:
    """Single-stage analysis PFB on a ('chan', 'time') mesh.

    The polyphase fold runs time-sharded (with the filter-history halo from
    the next time shard, as in the 1-D pipeline); the DFT — where the FLOPs
    are — is a matmul against the constant block matrix whose *columns* are
    output channels, so the 'chan' axis shards the matrix columns: each
    device computes its own output-channel slice for its time shard's
    spectra, with **no collective at all** (the fold is replicated across
    the chan axis — ~17% of the DFT's flops at the low geometry). Output is
    (n_pol, block, n_spectra) sharded P(None, 'chan', 'time') — exactly the
    input layout of :func:`sharded_polyphase_synthesis_2d`, whose
    all-to-all corner turn then re-gathers whole spectra per block.

    x: (n_pol, n_dat) pair/complex, n_dat divisible by
    time_devices*step*nu; block divisible by the chan axis.
    """
    os_factor = Rational.coerce(os_factor)
    if isinstance(x, tuple):
        xr, xi = jnp.asarray(x[0]), jnp.asarray(x[1])
    else:
        xr, xi = cfft.split(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    from ..ops import analysis as _analysis

    step = geometry.analysis_step(block, os_factor)
    dc = mesh.shape["chan"]
    dt = mesh.shape["time"]
    n_pol, n_dat = xr.shape
    if block % dc:
        raise ValueError(f"block={block} not divisible by chan axis {dc}")
    shard = n_dat // dt
    if shard % (step * os_factor.nu):
        raise ValueError(
            f"time shard {shard} must be a multiple of step*nu = "
            f"{step * os_factor.nu}"
        )
    cs = block // dc

    f2d = jnp.asarray(_analysis._prep_filter(filt, block))
    fl = f2d.shape[0] * block
    # DFT block matrix: [Br | Bi] columns are output channels
    dblk = jnp.asarray(cfft._dft_block(block, inverse=False))  # (2b, 2b)
    # ramp has period nu in the spectrum index (step*nu ≡ 0 mod block)
    rr_nu, ri_nu = _analysis._phase_ramp(block, step, os_factor.nu, 0)
    rr_nu = jnp.asarray(rr_nu)
    ri_nu = jnp.asarray(ri_nu)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            (P(None, "time"), P(None, "time")),
            P(None, None), P(None, None), P(None, None), P(None, None),
        ),
        out_specs=(P(None, "chan", "time"), P(None, "chan", "time")),
    )
    def run(pair, f2d_l, dblk_l, rr_l, ri_l):
        lr, li = pair
        n = jax.lax.axis_size("time")
        perm = [(i, i - 1) for i in range(1, n)]
        hr = jax.lax.ppermute(lr[..., :fl], "time", perm)
        hi_ = jax.lax.ppermute(li[..., :fl], "time", perm)
        xer = jnp.concatenate([lr, hr], axis=-1)
        xei = jnp.concatenate([li, hi_], axis=-1)

        fr, fi = _analysis._fold(xer, xei, f2d_l, step)  # (P, K, block)
        k_loc = fr.shape[1]
        cat = jnp.concatenate([fr, fi], axis=-1)  # (P, K, 2*block)

        # my output-channel slice of the DFT matrix columns
        c0 = jax.lax.axis_index("chan") * cs
        d_re = jax.lax.dynamic_slice_in_dim(dblk_l, c0, cs, axis=1)
        d_im = jax.lax.dynamic_slice_in_dim(dblk_l, block + c0, cs, axis=1)
        sr = jnp.einsum("pkt,tc->pkc", cat, d_re, precision=HIGHEST) * block
        si = jnp.einsum("pkt,tc->pkc", cat, d_im, precision=HIGHEST) * block

        # derotation ramp, same column slice, tiled over the nu-period
        r_re = jax.lax.dynamic_slice_in_dim(rr_l, c0, cs, axis=1)
        r_im = jax.lax.dynamic_slice_in_dim(ri_l, c0, cs, axis=1)
        reps = k_loc // r_re.shape[0]
        r_re = jnp.tile(r_re, (reps, 1))
        r_im = jnp.tile(r_im, (reps, 1))
        outr = sr * r_re - si * r_im
        outi = sr * r_im + si * r_re
        return (
            jnp.transpose(outr, (0, 2, 1)),
            jnp.transpose(outi, (0, 2, 1)),
        )

    rr, ri = run((xr, xi), f2d, dblk, rr_nu, ri_nu)
    return rr[:, :, : n_dat // step], ri[:, :, : n_dat // step]


def sharded_round_trip_2d(
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
    """Full 2-D pipeline: channel×time-sharded analysis → corner-turn
    synthesis. The fine-channel stream never leaves its
    P(None, 'chan', 'time') layout between the stages."""
    os_factor = Rational.coerce(os_factor)
    cr, ci = sharded_polyphase_analysis_2d(x, filt, n_chan, os_factor, mesh)
    dt = mesh.shape["time"]
    dc = mesh.shape["chan"]
    keep = input_fft_length - 2 * input_overlap
    n_dat = (x[0] if isinstance(x, tuple) else x).shape[-1]
    t_valid = geometry.analysis_nblocks(
        n_dat, int(np.asarray(filt).size), n_chan, os_factor
    )
    # whole inversion blocks per time shard, divisible by the chan axis
    t_shard = (t_valid // (dt * keep * dc)) * keep * dc
    spec = NamedSharding(mesh, P(None, "chan", "time"))
    cr = jax.lax.with_sharding_constraint(cr[:, :, : t_shard * dt], spec)
    ci = jax.lax.with_sharding_constraint(ci[:, :, : t_shard * dt], spec)
    return sharded_polyphase_synthesis_2d(
        (cr, ci),
        input_fft_length,
        os_factor,
        mesh,
        input_overlap=input_overlap,
        deripple_coeff=filt if deripple else None,
        temporal_taper=temporal_taper,
    )


def sharded_polyphase_synthesis_2d(
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
) -> Pair:
    """Golden inversion on a ('chan', 'time') mesh.

    x: (n_pol, n_chan, n_dat) complex or (re, im) pair; n_chan divisible by
    the chan axis, n_dat divisible by time_devices*input_keep, and blocks
    per time shard divisible by the chan axis. Returns the (re, im) pair of
    (n_pol, 1, n_blocks*output_keep), identical to the one-shot kernel.
    """
    os_factor = Rational.coerce(os_factor)
    if isinstance(x, tuple):
        xr, xi = jnp.asarray(x[0]), jnp.asarray(x[1])
    else:
        xr, xi = cfft.split(x)
    n_pol, n_chan, n_dat = xr.shape
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    keep = geom.input_keep
    fnw = geom.fn_width

    dc = mesh.shape["chan"]
    dt = mesh.shape["time"]
    if n_chan % dc:
        raise ValueError(f"n_chan={n_chan} not divisible by chan axis {dc}")
    if n_dat % (dt * keep):
        raise ValueError(
            f"n_dat={n_dat} must be divisible by time_devices*input_keep = "
            f"{dt * keep}"
        )
    blocks_per_t = n_dat // dt // keep
    if blocks_per_t % dc:
        raise ValueError(
            f"blocks per time shard ({blocks_per_t}) must be divisible by "
            f"the chan axis ({dc})"
        )

    t_vec = jnp.asarray(windows.build(temporal_taper, L, input_overlap))
    s_vec = jnp.asarray(
        windows.build(spectral_taper, n_chan * fnw, input_overlap)
    )
    if deripple_coeff is not None:
        from ..design.fir import deripple_response

        dr = jnp.asarray(
            deripple_response(deripple_coeff, n_chan, fnw // 2).astype(np.float32)
        )
    else:
        dr = jnp.ones(fnw, dtype=jnp.float32)

    nu, de = os_factor.nu, os_factor.de
    scale = np.float32(de / nu)
    lo, hi = geom.output_overlap, geom.output_fft_length - geom.output_overlap

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            (P(None, "chan", "time"), P(None, "chan", "time")),
            P(None), P(None), P(None),
        ),
        out_specs=(
            P(None, None, ("time", "chan")),
            P(None, None, ("time", "chan")),
        ),
    )
    def run(pair, t_local, s_local, dr_local):
        lr, li = pair  # (P, C/dc, T/dt)
        n = jax.lax.axis_size("time")
        # halo: next time-shard's first 2*overlap fine samples
        perm = [(i, i - 1) for i in range(1, n)]
        hr = jax.lax.ppermute(lr[..., : 2 * input_overlap], "time", perm)
        hi_ = jax.lax.ppermute(li[..., : 2 * input_overlap], "time", perm)
        xer = jnp.concatenate([lr, hr], axis=-1)
        xei = jnp.concatenate([li, hi_], axis=-1)

        # phase 1 — channel-local: frame, taper, FFT, shift, keep, deripple
        xs = jnp.stack([xer, xei])  # (2, P, C/dc, T')
        frames = frame(xs, L, keep, blocks_per_t) * t_local
        sr, si = cfft.fft(frames[0], frames[1])     # (P, C/dc, B, L)
        sr = cfft.fftshift(sr, axis=-1)[..., geom.discard: geom.discard + fnw]
        si = cfft.fftshift(si, axis=-1)[..., geom.discard: geom.discard + fnw]
        sr = sr * dr_local
        si = si * dr_local

        # corner turn — all-to-all over 'chan': split blocks, gather channels
        # (P, C/dc, B, fnw) -> (P, C, B/dc, fnw)
        def turn(v):
            return jax.lax.all_to_all(
                v, "chan", split_axis=2, concat_axis=1, tiled=True
            )

        sr = turn(sr)
        si = turn(si)

        # phase 2 — block-local: assemble full band, roll, taper, big IFFT
        b_loc = blocks_per_t // dc
        def assemble(v):
            flat = jnp.transpose(v, (0, 2, 1, 3)).reshape(
                n_pol, b_loc, n_chan * fnw
            )
            if spans_nyquist:
                flat = jnp.roll(flat, -(fnw // 2), axis=-1)
            return flat * s_local

        br, bi = cfft.ifft(assemble(sr), assemble(si))
        outr = (br[..., lo:hi] * scale).reshape(n_pol, 1, b_loc * geom.output_keep)
        outi = (bi[..., lo:hi] * scale).reshape(n_pol, 1, b_loc * geom.output_keep)
        return outr, outi

    rr, ri = run((xr, xi), t_vec, s_vec, dr)
    valid = geom.n_blocks(n_dat) * geom.output_keep
    return rr[:, :, :valid], ri[:, :, :valid]


def sharded_polyphase_analysis_padded_2d(
    x,
    filt,
    block: int,
    os_factor,
    mesh: Mesh,
    *,
    apply_delay: bool = True,
) -> Pair:
    """Zero-padded (SKA-Mid) analysis PFB on a ('chan', 'time') mesh.

    Same structure as :func:`sharded_polyphase_analysis_2d` — the fold runs
    time-sharded (halo = *previous* shard's filter history), the DFT's
    output-channel columns shard over 'chan' with no collective — with the
    padded kernel's mathematics: time-reversed-filter correlation, and
    reverse-then-IFFT*block^2 rewritten as block * e^{-2pi i q/block} * FFT
    (index identity IFFT(reverse(y))[q] = e^{-2pi i q/block} FFT(y)[q]/block),
    which merges with the derotation ramp into ONE per-channel elementwise
    constant — sliceable along the sharded channel axis.

    Output (n_pol, block, n_dat//step) sharded P(None, 'chan', 'time'), the
    corner-turn synthesis' input layout. Reference:
    polyphase_analysis_padded.m:113-153.
    """
    os_factor = Rational.coerce(os_factor)
    if isinstance(x, tuple):
        xr, xi = jnp.asarray(x[0]), jnp.asarray(x[1])
    else:
        xr, xi = cfft.split(x)
    if xr.ndim == 3:
        xr, xi = xr[:, 0, :], xi[:, 0, :]
    from ..ops import analysis as _analysis

    step = geometry.analysis_step(block, os_factor)
    nu = os_factor.nu
    dc = mesh.shape["chan"]
    dt = mesh.shape["time"]
    n_pol, n_dat = xr.shape
    if block % dc:
        raise ValueError(f"block={block} not divisible by chan axis {dc}")
    shard = n_dat // dt
    if shard % (step * nu):
        raise ValueError(
            f"time shard {shard} must be a multiple of step*nu = {step * nu}"
        )
    cs = block // dc

    f2d_rev = jnp.asarray(_analysis._prep_filter(filt, block, reverse=True))
    fl = f2d_rev.shape[0] * block
    halo_blocks = -(-fl // step)
    halo_blocks += (-halo_blocks) % nu
    halo = halo_blocks * step

    dblk = jnp.asarray(cfft._dft_block(block, inverse=False))
    # ramp * (block * e^{-2pi i q / block}) — the reverse+IFFT identity
    rr_nu, ri_nu = _analysis._phase_ramp(block, step, nu, 0)
    q = np.arange(block)
    pr = block * np.cos(-2.0 * np.pi * q / block)
    pi_ = block * np.sin(-2.0 * np.pi * q / block)
    c_re = jnp.asarray(
        (rr_nu.astype(np.float64) * pr - ri_nu.astype(np.float64) * pi_)
        .astype(np.float32)
    )
    c_im = jnp.asarray(
        (rr_nu.astype(np.float64) * pi_ + ri_nu.astype(np.float64) * pr)
        .astype(np.float32)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            (P(None, "time"), P(None, "time")),
            P(None, None), P(None, None), P(None, None), P(None, None),
        ),
        out_specs=(P(None, "chan", "time"), P(None, "chan", "time")),
    )
    def run(pair, f2d_l, dblk_l, cr_l, ci_l):
        lr, li = pair
        n = jax.lax.axis_size("time")
        perm = [(i, i + 1) for i in range(n - 1)]
        hr = jax.lax.ppermute(lr[..., -halo:], "time", perm)
        hi_ = jax.lax.ppermute(li[..., -halo:], "time", perm)
        # shard 0's true history is zeros — exactly its (non-circular)
        # ppermute fill — so dropping the recomputed history blocks below
        # is correct for every shard
        xer = jnp.concatenate([hr, lr], axis=-1)
        xei = jnp.concatenate([hi_, li], axis=-1)
        xs = jnp.stack([xer, xei])
        xs = jnp.pad(xs, [(0, 0), (0, 0), (fl, 0)])
        nblk = xer.shape[-1] // step
        phases = fl // block
        frames = frame(xs, fl, step, nblk).reshape(
            2, n_pol, nblk, phases, block
        )
        g = jnp.einsum("spkmj,mj->spkj", frames, f2d_l, precision=HIGHEST)
        gr, gi = g[0], g[1]
        cat = jnp.concatenate([gr, gi], axis=-1)  # (P, K, 2*block)

        c0 = jax.lax.axis_index("chan") * cs
        d_re = jax.lax.dynamic_slice_in_dim(dblk_l, c0, cs, axis=1)
        d_im = jax.lax.dynamic_slice_in_dim(dblk_l, block + c0, cs, axis=1)
        sr = jnp.einsum("pkt,tc->pkc", cat, d_re, precision=HIGHEST)
        si = jnp.einsum("pkt,tc->pkc", cat, d_im, precision=HIGHEST)

        r_re = jax.lax.dynamic_slice_in_dim(cr_l, c0, cs, axis=1)
        r_im = jax.lax.dynamic_slice_in_dim(ci_l, c0, cs, axis=1)
        reps = nblk // nu
        r_re = jnp.tile(r_re, (reps, 1))
        r_im = jnp.tile(r_im, (reps, 1))
        outr = sr * r_re - si * r_im
        outi = sr * r_im + si * r_re
        outr = outr[:, halo_blocks:, :]
        outi = outi[:, halo_blocks:, :]
        return (
            jnp.transpose(outr, (0, 2, 1)),
            jnp.transpose(outi, (0, 2, 1)),
        )

    rr, ri = run((xr, xi), f2d_rev, dblk, c_re, c_im)
    if apply_delay:
        delay = geometry.padded_sample_delay_shift(
            int(np.asarray(filt).size), block, os_factor
        )
        rr = jnp.roll(rr, -delay, axis=2)
        ri = jnp.roll(ri, -delay, axis=2)
    return rr, ri


def sharded_round_trip_2d_padded(
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
    """Full 2-D SKA-Mid-style pipeline: channel×time-sharded padded
    analysis -> corner-turn synthesis at the mid channel count."""
    os_factor = Rational.coerce(os_factor)
    cr, ci = sharded_polyphase_analysis_padded_2d(
        x, filt, n_chan, os_factor, mesh
    )
    dt = mesh.shape["time"]
    dc = mesh.shape["chan"]
    keep = input_fft_length - 2 * input_overlap
    step = geometry.analysis_step(n_chan, os_factor)
    n_dat = (x[0] if isinstance(x, tuple) else x).shape[-1]
    t_valid = n_dat // step
    t_shard = (t_valid // (dt * keep * dc)) * keep * dc
    spec = NamedSharding(mesh, P(None, "chan", "time"))
    cr = jax.lax.with_sharding_constraint(cr[:, :, : t_shard * dt], spec)
    ci = jax.lax.with_sharding_constraint(ci[:, :, : t_shard * dt], spec)
    return sharded_polyphase_synthesis_2d(
        (cr, ci),
        input_fft_length,
        os_factor,
        mesh,
        input_overlap=input_overlap,
        deripple_coeff=filt if deripple else None,
        temporal_taper=temporal_taper,
    )
