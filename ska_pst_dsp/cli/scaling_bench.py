"""Scaling-efficiency benchmark for the sharded pipelines.

Measures the time-sharded (1-D) and chan×time (2-D) round trips at the
production low geometry over growing device counts and reports samples/s
and parallel efficiency vs the single-device run:

    python -m ska_pst_dsp.cli.scaling_bench --devices 1 2 4 8

On real multi-chip hardware the efficiency numbers are the BASELINE
scaling target (>= 90% at N >= 2); under
``--xla_force_host_platform_device_count`` the same program structure runs
on one host's cores, so the report records the collective/halo structure
and relative overhead trends, not real interconnect scaling (the report
notes which).

Writes products/report.scaling.json.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

module_logger = logging.getLogger(__name__)


def _measure(fn, args, reps):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def comm_model(n_chan, taps, L, ov, os_f, n_pol=2, dc=2):
    """Analytical per-shard-step communication volume of the sharded
    pipelines (bytes that must cross the interconnect per output sample),
    independent of
    the host this runs on. Split-complex float32 (8 bytes per complex
    sample).

    1-D time mesh: analysis halo = padded_taps raw samples; synthesis halo
    = 2*input_overlap fine-channel samples across all channels
    (parallel/sharded.py). 2-D adds the corner-turn all-to-all: each device
    ships (dc-1)/dc of its phase-1 passband output (parallel/corner_turn.py).
    Amortization: halos are per shard-STEP, so their share falls as
    samples-per-shard grows — reported at a production-sized shard
    (64 Msample, sgcht.m:481's block size) and per million output samples.
    """
    from ..utils import geometry

    step = geometry.analysis_step(n_chan, os_f)
    fl = geometry.padded_filter_length(taps, n_chan)
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    shard_raw = 64 * 1024 * 1024  # samples per device per step (sgcht block)
    out_per_shard = (shard_raw // step) // geom.input_keep * geom.output_keep

    halo_analysis = n_pol * 8 * fl                      # raw samples
    halo_synth = n_pol * 8 * 2 * ov * n_chan            # fine samples
    # all-to-all: phase-1 output is (P, C/dc, B, fnw); (dc-1)/dc leaves
    blocks = (shard_raw // step) // geom.input_keep
    a2a = n_pol * 8 * (n_chan // dc) * blocks * geom.fn_width * (dc - 1)
    # published H100 NVLink peak: 900 GB/s to the other cards, 450 GB/s
    # each way (NVIDIA H100 SXM data sheet) — a peak, not a measurement
    link_gbs = 450.0

    def per_msample(b):
        return round(b / (out_per_shard / 1e6), 1)

    return {
        "shard_raw_samples": shard_raw,
        "out_samples_per_shard_step": out_per_shard,
        "halo_analysis_bytes": halo_analysis,
        "halo_synthesis_bytes": halo_synth,
        "all_to_all_bytes_2d": a2a,
        "bytes_per_Msample_1d": per_msample(halo_analysis + halo_synth),
        "bytes_per_Msample_2d": per_msample(
            halo_analysis + halo_synth + a2a
        ),
        "modeled_comm_seconds_per_Gsample_2d": round(
            (halo_analysis + halo_synth + a2a)
            / (out_per_shard / 1e9) / (link_gbs * 1e9), 4
        ),
        "nvlink_gbs_each_way_published_peak": link_gbs,
        "note": (
            "1-D halo volume is O(1) per shard step — vanishing vs "
            "compute as shards grow; the 2-D all-to-all moves a constant "
            "(dc-1)/dc fraction of the fine-channel stream and is the "
            "scaling-relevant term."
        ),
    }


#: collective HLO op mnemonics counted by :func:`_hlo_collective_stats`
_COLLECTIVES = (
    "all-to-all", "collective-permute", "all-reduce", "all-gather",
    "reduce-scatter",
)


def _hlo_collective_stats(fn, args) -> dict:
    """Count the compiled program's ACTUAL collective ops and their
    payload bytes from the optimized HLO — ground truth for what moves
    over the interconnect, immune to virtual-mesh wall-clock artifacts."""
    import re

    txt = fn.lower(*args).compile().as_text()
    stats = {}
    # e.g.:  %all-to-all.3 = f32[2,256,1536]{2,1,0} all-to-all(...)
    # or, tuple-result:  %x = (f32[..]{..}, f32[..]{..}) all-to-all(...)
    shape_re = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    dt_bytes = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "f64": 8, "s8": 1, "u8": 1, "pred": 1}
    for line in txt.splitlines():
        if " = " not in line:
            continue
        lhs, _, rhs = line.partition(" = ")
        opm = re.search(r"^\s*\(?[^=]*?([a-z][a-z-]*)\(", rhs)
        if not opm:
            continue
        # XLA:GPU emits async pairs (all-to-all-start / -done): count each
        # collective once, at its -done, whose result is the received
        # payload (a -start's result tuple also holds the send buffers)
        op = opm.group(1)
        if op.endswith("-start"):
            continue
        op = op.removesuffix("-done")
        if op not in _COLLECTIVES:
            continue
        payload = 0
        for dtype, dims in shape_re.findall(rhs[: opm.start(1)]):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            payload += n * dt_bytes.get(dtype, 4)
        e = stats.setdefault(op, {"count": 0, "payload_bytes": 0})
        e["count"] += 1
        e["payload_bytes"] += payload
    return stats or {"none": {"count": 0, "payload_bytes": 0}}


def run(argv=None) -> int:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..design import fir
    from ..parallel.sharded import make_mesh, sharded_round_trip
    from ..parallel.corner_turn import make_mesh_2d, sharded_round_trip_2d
    from ..utils import device, geometry
    from ..utils.rational import Rational
    from .sgcht import PRODUCTS_DIR

    p = argparse.ArgumentParser(prog="scaling_bench")
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--samples-per-device", type=int, default=192 * 4 * 1200)
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    os_f = Rational(4, 3)
    n_chan, L, ov = 256, 256, 48
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    avail = len(jax.devices())
    counts = [d for d in a.devices if d <= avail]

    virtual = "force_host_platform" in os.environ.get("XLA_FLAGS", "")
    report = {
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "n_devices_available": avail,
        "virtual_devices": virtual,
        "geometry": "low (256 chan, OS 4/3, 3073 taps, L=256, ov=48)",
        "note": (
            "Per device count: the compiled program's ACTUAL collective "
            "ops (counts + payload bytes from the optimized HLO) plus the "
            "analytic comm model. Wall-clock 'efficiency' is deliberately "
            "NOT reported on a virtual mesh — N oversubscribed devices "
            "sharing one host's cores cannot weak-scale, and such numbers "
            "read as a broken machine. On H100s the collective payloads "
            "below ride NVLink; the modeled_comm_seconds_per_Gsample "
            "figures divide them by its published 450 GB/s each way."
        ),
        "runs": {},
        **({"nvidia_smi": device.nvidia_smi()} if not virtual
           and jax.default_backend() == "gpu" else {}),
        "comm_model": {
            "low": comm_model(256, 3073, 256, 48, Rational(4, 3)),
            "mid": comm_model(4096, 100353, 512, 128, Rational(8, 7)),
        },
    }

    for nd in counts:
        n_dat = nd * a.samples_per_device
        rng = np.random.default_rng(0)
        xr = rng.standard_normal((2, n_dat)).astype(np.float32)
        xi = rng.standard_normal((2, n_dat)).astype(np.float32)
        entry = {}

        mesh = make_mesh(nd)
        spec = NamedSharding(mesh, P(None, "time"))
        args = (jax.device_put(xr, spec), jax.device_put(xi, spec))
        fn = jax.jit(
            lambda xa, xb, m=mesh: sharded_round_trip(
                (xa, xb), filt, n_chan, os_f, L, ov, m
            )
        )
        entry["1d"] = {
            "collectives": _hlo_collective_stats(fn, args),
            "raw_msamples": round(2 * n_dat / 1e6, 1),
        }
        if not virtual:
            dt = _measure(fn, args, a.reps)
            entry["1d"]["msps"] = round(2 * n_dat / dt / 1e6, 1)

        if nd % 2 == 0:
            mesh2 = make_mesh_2d(2, nd // 2)
            spec2 = NamedSharding(mesh2, P(None, "time"))
            args2 = (jax.device_put(xr, spec2), jax.device_put(xi, spec2))
            fn2 = jax.jit(
                lambda xa, xb, m=mesh2: sharded_round_trip_2d(
                    (xa, xb), filt, n_chan, os_f, L, ov, m
                )
            )
            entry["2d_2xT"] = {
                "collectives": _hlo_collective_stats(fn2, args2),
            }
            if not virtual:
                dt2 = _measure(fn2, args2, a.reps)
                entry["2d_2xT"]["msps"] = round(2 * n_dat / dt2 / 1e6, 1)

        report["runs"][str(nd)] = entry
        module_logger.info("devices=%d: %s", nd, entry)

    os.makedirs(PRODUCTS_DIR, exist_ok=True)
    path = os.path.join(PRODUCTS_DIR, "report.scaling.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    module_logger.info("wrote %s", path)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
