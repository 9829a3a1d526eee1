"""Benchmark: SKA-Low and SKA-Mid round trips (analysis + Golden inversion)
on one GPU, with roofline accounting. Prints ONE JSON line:

  {"metric": "low_roundtrip_throughput", "value": N,
   "unit": "Msamples/s/card", "device": {...}, "nvidia_smi": "...",
   "roofline": {...}, "mid": {...}, "vs_baseline": {...}}

Both cells run the plain ops (``ops.polyphase_analysis[_padded]`` then
``ops.polyphase_synthesis``, tuple API, data on the device) through XLA;
every FFT is a cuFFT call.

Roofline, per raw complex sample, against the peaks of the card's
``device_kind`` (:data:`PEAKS`):
  * memory floor — the essential bytes: read the raw stream once, write and
    read the fine channels, write the output (split-complex float32);
  * compute floor — the FFT-optimal flops (5·N·log2 N per N-point FFT, 4
    per complex-by-real filter tap) at the float32 rate, since every
    contraction runs at ``Precision.HIGHEST``;
  * the larger of the two is the bound; ``pct_sol`` is the achieved share
    of the speed of light it sets.

``vs_baseline`` compares with the fp64 NumPy oracle running the same Low
math single-threaded on the HOST CPU: a host number, not a device metric.

    python bench.py                 # both cells, one JSON line
    python bench.py --trace DIR     # also trace a few steps of each cell and
                                    # report per-stage device time + idle share

Exits non-zero when JAX finds no GPU, or when the card's ``device_kind`` is
not in :data:`PEAKS`.
"""

import argparse
import glob
import json
import math
import os
import time

import numpy as np

#: Published peaks by JAX ``device_kind``. Source: NVIDIA H100 data sheet,
#: SXM part, dense rates (no sparsity), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbs": 3350.0,
        "fp32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "source": "NVIDIA H100 SXM data sheet (dense)",
    },
}

CONFIGS = {
    "low": dict(n_chan=256, taps=3073, L=256, ov=48, nu=4, de=3),
    "mid": dict(n_chan=4096, taps=100353, L=512, ov=128, nu=8, de=7),
}


def peaks(device_kind: str) -> dict:
    """Peaks of a card; an unknown card is an error, not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def _fft_flops(n):
    return 5.0 * n * math.log2(n)


def per_sample_work(name: str) -> dict:
    """FFT-optimal flops and essential HBM bytes per raw complex sample."""
    from ska_pst_dsp.utils import geometry
    from ska_pst_dsp.utils.rational import Rational

    c = CONFIGS[name]
    os_f = Rational(c["nu"], c["de"])
    n_chan = c["n_chan"]
    step = geometry.analysis_step(n_chan, os_f)
    fl = geometry.padded_filter_length(c["taps"], n_chan)
    geom = geometry.SynthesisGeometry(n_chan, c["L"], c["ov"], os_f)
    ana = (4.0 * fl + _fft_flops(n_chan)) / step
    per_block = (
        n_chan * _fft_flops(c["L"])
        + 6.0 * n_chan * geom.fn_width
        + _fft_flops(geom.output_fft_length)
    )
    return {
        "flops": ana + per_block / geom.output_keep,
        # raw in + fine out + fine in + raw out, 8 bytes per complex value
        "bytes": 8 + 2 * 8 * c["nu"] / c["de"] + 8,
    }


def roofline(name: str, msps: float, device_kind: str) -> dict:
    """Speed of light of a cell on a card, and the achieved share of it."""
    pk = peaks(device_kind)
    w = per_sample_work(name)
    sol_mem = pk["hbm_gbs"] * 1e9 / w["bytes"]
    sol_flop = pk["fp32_tflops"] * 1e12 / w["flops"]
    sol = min(sol_mem, sol_flop)
    return {
        "flops_per_sample_fft_optimal": w["flops"],
        "bytes_per_sample": w["bytes"],
        "sol_mem_msps": sol_mem / 1e6,
        "sol_flop_msps": sol_flop / 1e6,
        "bound": "memory" if sol_mem <= sol_flop else "compute",
        "sol_msps": sol / 1e6,
        "pct_sol": 100.0 * msps * 1e6 / sol,
        "peaks_source": pk["source"],
    }


def _chain_timer(forward, args, reps):
    """Seconds per call of ``forward`` (best of 3 passes of ``reps``), and
    the jitted step that was timed.

    Each step's first input is perturbed by the previous step's scalar
    carry, so the device runs every repetition in turn and XLA cannot
    elide one; the host enqueues all ``reps`` steps and waits once. The
    carry is ADDED (a multiply by zero would be folded away): it stays
    ~1e-27, so x + c == x in float32, but XLA cannot prove it."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(c, *a):
        o = forward(*(x + c if i == 0 else x for i, x in enumerate(a)))
        return c + sum(map(jnp.sum, o)) * 1e-30

    c = step(jnp.float32(0), *args)
    float(c)  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            c = step(c, *args)
        float(c)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best, step


def low_cell(n_dat=2**23):
    """SKA-Low: 256 ch, OS 4/3, 3073 taps, L=256/ov=48, 2 pol x 2^23."""
    from ska_pst_dsp.design import fir
    from ska_pst_dsp.ops import polyphase_analysis, polyphase_synthesis
    from ska_pst_dsp.utils.rational import Rational

    c = CONFIGS["low"]
    os_f = Rational(c["nu"], c["de"])
    filt = fir.design_pfb_fir_filter(c["n_chan"], os_f, 12)

    def forward(a, b):
        cr, ci = polyphase_analysis((a, b), filt, c["n_chan"], os_f)
        return polyphase_synthesis(
            (cr, ci), c["L"], os_f, input_overlap=c["ov"],
            deripple_coeff=filt, temporal_taper="tukey",
        )

    return forward, n_dat


def mid_cell():
    """SKA-Mid: 4096 ch, OS 8/7, the 100353-tap two-stage filter,
    L=512/ov=128 with the 1,835,008-point backward FFT; 2 pol x
    (2*128 + 4*256)*3584 samples (four inversion blocks)."""
    from ska_pst_dsp.design import fir
    from ska_pst_dsp.ops import polyphase_analysis_padded, polyphase_synthesis
    from ska_pst_dsp.utils import geometry
    from ska_pst_dsp.utils.rational import Rational

    c = CONFIGS["mid"]
    os_f = Rational(c["nu"], c["de"])
    filt = fir.design_pfb_fir_filter_two_stage(c["n_chan"], os_f, 28)
    geom = geometry.SynthesisGeometry(c["n_chan"], c["L"], c["ov"], os_f)
    n_dat = (2 * c["ov"] + 4 * geom.input_keep) * geometry.analysis_step(
        c["n_chan"], os_f
    )

    def forward(a, b):
        cr, ci = polyphase_analysis_padded((a, b), filt, c["n_chan"], os_f)
        return polyphase_synthesis(
            (cr, ci), c["L"], os_f, input_overlap=c["ov"],
            deripple_coeff=filt, temporal_taper="tukey",
        )

    return forward, n_dat


def stage_bytes(name: str, n_dat: int, n_pol: int = 2) -> list:
    """HBM bytes of the tensors between the round trip's stages for one
    step of ``n_dat`` samples per polarization, split-complex float32:
    [raw, folded, fine channels, frames, spectra, assembled, inverse, out].
    Stage ``profiling.STAGES[i]`` reads entry i and writes entry i + 1."""
    from ska_pst_dsp.utils import geometry
    from ska_pst_dsp.utils.rational import Rational

    c = CONFIGS[name]
    os_f = Rational(c["nu"], c["de"])
    n_chan = c["n_chan"]
    step = geometry.analysis_step(n_chan, os_f)
    if name == "mid":  # zero-padded analysis: one spectrum per step
        t = n_dat // step
    else:
        t = (n_dat - geometry.padded_filter_length(c["taps"], n_chan)) // step
    geom = geometry.SynthesisGeometry(n_chan, c["L"], c["ov"], os_f)
    b = geom.n_blocks(t)
    fine = n_pol * n_chan * t
    frames = n_pol * n_chan * b * c["L"]
    flat = n_pol * b * n_chan * geom.fn_width
    out = n_pol * b * geom.output_keep
    return [8 * v for v in (n_pol * n_dat, fine, fine, frames, frames, flat,
                            flat, out)]


def stage_floors_ms(name: str, n_dat: int, device_kind: str) -> dict:
    """Least time of each stage, and of every run of adjacent stages XLA
    may fuse, at the card's HBM rate: read its input once, write its output
    once. Keys match ``profiling.stage_device_ns``."""
    from ska_pst_dsp.utils.profiling import STAGES

    sizes = stage_bytes(name, n_dat)
    rate = peaks(device_kind)["hbm_gbs"] * 1e9
    return {
        "+".join(STAGES[i:j + 1]): (sizes[i] + sizes[j + 1]) / rate * 1e3
        for i in range(len(STAGES)) for j in range(i, len(STAGES))
    }


def _stream(n_dat, seed=0):
    import jax

    rng = np.random.default_rng(seed)
    return tuple(
        jax.device_put(rng.standard_normal((2, n_dat)).astype(np.float32))
        for _ in range(2)
    )


def trace_cell(step, args, trace_dir, floors, steps=3) -> dict:
    """Per-stage device time of ``steps`` chained calls of ``step`` beside
    each stage's HBM floor (``floors``, ms), and the device idle share over
    the traced window."""
    import jax
    import jax.numpy as jnp

    from ska_pst_dsp.utils import profiling

    c = step(jnp.float32(0), *args)
    float(c)
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            c = step(c, *args)
        float(c)
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events = profiling.device_op_events(path)
    op_stages = profiling.hlo_op_stages(
        step.lower(jnp.float32(0), *args).compile().as_text()
    )
    window = max(e[2] + e[3] for e in events) - min(e[2] for e in events)
    busy = profiling.busy_ns(events)
    stages = profiling.stage_device_ns(events, op_stages)
    return {
        "steps": steps,
        "stages": {
            k: {"ms_per_step": v / steps / 1e6,
                "hbm_floor_ms": floors.get(k)}
            for k, v in stages.items()
        },
        "busy_ms_per_step": busy / steps / 1e6,
        "idle_share": 1.0 - busy / window,
        "xplane": path,
    }


def bench_oracle_cpu(n_dat=2**19):
    """Single-threaded fp64 NumPy oracle running the Low math on the host
    CPU — the stand-in for the reference's Matlab. Samples/s."""
    from ska_pst_dsp import oracle
    from ska_pst_dsp.design import fir
    from ska_pst_dsp.utils import windows
    from ska_pst_dsp.utils.rational import Rational

    os_f = Rational(4, 3)
    n_chan, L, ov = 256, 256, 48
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    rng = np.random.default_rng(0)
    x = (
        rng.standard_normal((2, 1, n_dat))
        + 1j * rng.standard_normal((2, 1, n_dat))
    ).astype(np.complex64)
    t0 = time.perf_counter()
    chan = oracle.polyphase_analysis(x, filt, n_chan, os_f)
    oracle.polyphase_synthesis(
        chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
        temporal_taper=windows.tukey_window(L, ov).astype(np.float64),
    )
    dt = time.perf_counter() - t0
    return (x.shape[0] * n_dat) / dt


def main(argv=None):
    p = argparse.ArgumentParser(description="SKA-Low/Mid round-trip benchmark")
    p.add_argument("--trace", metavar="DIR",
                   help="also trace each cell and report per-stage times")
    a = p.parse_args(argv)

    from ska_pst_dsp.utils import compile_cache, device

    dev = device.require_gpu()
    peaks(dev["kind"])  # an unknown card fails before any work
    smi = device.nvidia_smi()
    compile_cache.enable()

    out = {"metric": "low_roundtrip_throughput", "unit": "Msamples/s/card",
           "device": dev, "nvidia_smi": smi}
    for name, cell, reps in (("low", low_cell, 50), ("mid", mid_cell, 10)):
        forward, n_dat = cell()
        args = _stream(n_dat)
        dt, step = _chain_timer(forward, args, reps)
        msps = 2 * n_dat / dt / 1e6
        res = {"value": msps, "seconds_per_step": dt,
               "roofline": roofline(name, msps, dev["kind"])}
        if a.trace:
            res["trace"] = trace_cell(
                step, args, os.path.join(a.trace, name),
                stage_floors_ms(name, n_dat, dev["kind"]),
            )
        if name == "low":
            out.update(res)
        else:
            out["mid"] = res

    host = bench_oracle_cpu()
    out["vs_baseline"] = {
        "value": out["value"] * 1e6 / host,
        "baseline": "fp64 NumPy oracle, Low math, one host CPU thread",
        "host_oracle_msps": host / 1e6,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
