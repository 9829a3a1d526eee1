"""Purity sweep of the round trip through the plain ops, on any device.

The −60 dB purity gates (TestPureTone.m:20, TestImpulse.m:26 in the
reference; CSP_Low_PST_REQ-627/697, CSP_Mid_PST_REQ-385/386) are tested
on the CPU by the suite. This tool runs the temporal (impulse) and spectral
(tone) sweeps — with the adversarial block-boundary ± overlap placement of
current_performance.m:60-96 — through ``ops.polyphase_analysis[_padded]``
and ``ops.polyphase_synthesis`` (tuple API, one jitted step) on whatever
device JAX uses, so that on a GPU it checks the compiled GPU path:

  low: polyphase_analysis (3073 taps) -> polyphase_synthesis;
  mid: polyphase_analysis_padded (production 100353-tap filter) ->
       polyphase_synthesis with the 1,835,008-point backward FFT.

Writes products/report.purity.<platform>.<cfg>.json with per-point
max/total spurious dB, the worst in-window value, the device (and, on a
GPU, the card's name and power limit) and the gate verdict. Exits nonzero
if any in-window point exceeds −60 dB.

    python tools/purity.py -c low -n 24
    python tools/purity.py -c mid -n 24

Every sweep point shares one compiled executable (shapes are constant
across points), so compilation is paid once per config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from ska_pst_dsp.cli.current_performance import (  # noqa: E402
    chop, freq_domain_offsets, time_domain_offsets,
)
from ska_pst_dsp.data_gen.config import products_dir  # noqa: E402
from ska_pst_dsp.data_gen.generate_test_vector import (  # noqa: E402
    complex_sinusoid, time_domain_impulse,
)
from ska_pst_dsp.data_gen.util import NumpyEncoder  # noqa: E402
from ska_pst_dsp.utils import device, geometry  # noqa: E402
from ska_pst_dsp.utils.config import load_config  # noqa: E402
from ska_pst_dsp.verify.util import DomainPerformance  # noqa: E402


def pipeline(config, filt):
    """The config's round trip through the plain ops as one jitted step:
    complex host signal (n,) -> complex128 inverted stream."""
    import jax

    from ska_pst_dsp.ops import (
        polyphase_analysis, polyphase_analysis_padded, polyphase_synthesis,
    )

    os_f = config.os_factor
    analysis = (
        polyphase_analysis_padded
        if config.analysis_function == "polyphase_analysis_padded"
        else polyphase_analysis
    )

    @jax.jit
    def forward(xr, xi):
        cr, ci = analysis((xr, xi), filt, config.channels, os_f)
        return polyphase_synthesis(
            (cr, ci), config.input_fft_length, os_f,
            input_overlap=config.input_overlap,
            deripple_coeff=filt if config.deripple else None,
            temporal_taper=config.temporal_taper,
        )

    def run(signal):
        xr = np.ascontiguousarray(signal.real, dtype=np.float32)[None]
        xi = np.ascontiguousarray(signal.imag, dtype=np.float32)[None]
        rr, ri = forward(xr, xi)
        return (
            np.asarray(rr).astype(np.float64)
            + 1j * np.asarray(ri).astype(np.float64)
        ).reshape(-1)

    return run


def subsample(arr, n):
    """Keep at most n points, evenly spread (always keep first/last)."""
    arr = np.asarray(arr)
    if arr.size <= n:
        return arr
    idx = np.unique(np.linspace(0, arr.size - 1, n).round().astype(int))
    return arr[idx]


def sweep(cfg_name: str, npoints: int, out_path: str) -> int:
    config = load_config(cfg_name)
    os_f = config.os_factor
    filt = config.load_fir_filter_coeff()
    block_size = os_f.normalize(config.input_fft_length) * config.channels
    output_overlap = os_f.normalize(config.input_overlap) * config.channels
    nblocks = config.blocks
    n_samples = block_size * nblocks
    filt_offset = (filt.size - 1) // 2 + output_overlap
    padded = config.analysis_function == "polyphase_analysis_padded"
    shift = geometry.total_sample_shift(
        config.channels, os_f, config.fir_filter_taps, config.input_overlap,
        padded=padded,
    )
    perf = DomainPerformance(guard=2)
    run = pipeline(config, filt)

    report = {
        "config": cfg_name,
        **device.record(),
        "path": (
            "ops.polyphase_analysis_padded+ops.polyphase_synthesis" if padded
            else "ops.polyphase_analysis+ops.polyphase_synthesis"
        ),
        "n_samples": int(n_samples),
        "requirement_dB": -60.0,
    }

    # temporal: impulse at inversion block boundaries, boundaries +-
    # output_overlap, block strides, and a uniform sweep
    offsets = subsample(
        time_domain_offsets(
            npoints, block_size, nblocks, config.input_overlap,
            output_overlap, filt_offset, n_samples,
        ),
        2 * npoints,
    )
    temporal = []
    t0 = time.time()
    for off in offsets:
        sig = time_domain_impulse(
            n_samples, [int(off)], [1], dtype=np.complex64
        )
        inv = run(sig)
        ichop, vchop = chop(config, sig, inv, {})
        if vchop.size == 0:
            continue
        in_window = 0 <= off - shift < vchop.size
        r = perf.temporal_performance(vchop) if in_window else {}
        r.update(perf.temporal_difference(ichop, vchop))
        r["offset"] = int(off)
        r["in_window"] = bool(in_window)
        temporal.append(r)
        print(f"temporal offset={off}: {r}", flush=True)
    report["temporal"] = temporal
    report["temporal_seconds"] = round(time.time() - t0, 1)

    # spectral: tones at exact analysis bins stepping through the band
    freqs = subsample(
        freq_domain_offsets(npoints, block_size, nblocks), npoints
    )
    spectral = []
    t0 = time.time()
    for fq in freqs:
        sig = complex_sinusoid(
            n_samples, [int(fq)], [np.pi / 4], dtype=np.complex64
        )
        inv = run(sig)
        ichop, vchop = chop(config, sig, inv, {})
        if vchop.size == 0:
            continue
        nfft = (vchop.size // block_size) * block_size
        r = perf.spectral_performance(vchop, nfft)
        r.update(perf.temporal_difference(ichop, vchop))
        r["frequency"] = int(fq)
        spectral.append(r)
        print(f"spectral freq={fq}: {r}", flush=True)
    report["spectral"] = spectral
    report["spectral_seconds"] = round(time.time() - t0, 1)

    worst = max(
        (r["max_spurious"] for rs in (temporal, spectral) for r in rs
         if "max_spurious" in r and r.get("in_window", True)),
        default=float("-inf"),
    )
    report["worst_in_window_max_spurious_dB"] = worst
    report["pass"] = bool(worst <= -60.0)

    os.makedirs(products_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    print(f"worst in-window max_spurious: {worst:.1f} dB "
          f"({'PASS' if report['pass'] else 'FAIL'}) -> {out_path}",
          flush=True)
    return 0 if report["pass"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", dest="cfg", default="low",
                   choices=["low", "mid"])
    p.add_argument("-n", "--npoints", type=int, default=24)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import jax

    out = a.out or os.path.join(
        products_dir,
        f"report.purity.{jax.devices()[0].platform}.{a.cfg}.json",
    )
    return sweep(a.cfg, a.npoints, out)


if __name__ == "__main__":
    raise SystemExit(main())
