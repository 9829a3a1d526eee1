"""Coherent dedispersion during inversion, on any device, against the fp64
NumPy oracle.

The ``spectral_filter`` slot of ``ops.polyphase_synthesis`` is the native
analog of dspsr's convolution-during-inversion (reference
python/verify/test_dedispersion.py:54-321). This tool drives a coherent-
dedispersion chirp through it on whatever device JAX uses, at the SKA-Low
geometry:

  gate:  the device round trip (ops.polyphase_analysis ->
         ops.polyphase_synthesis with the chirp) must match the fp64 oracle
         (oracle.polyphase_analysis -> oracle.polyphase_synthesis with the
         same chirp) to max|dev - oracle| / max|oracle| < 1e-5;
  info:  the device result is also compared against whole-stream
         dedispersion of the unfiltered inversion; the per-block chirp
         approximation bounds that near -30 dB (chirp tails beyond the
         overlap-save discard), so it is recorded, not gated; the
         reference's whole-stream commutation gate lives in
         verify/test_dedispersion.py.

Writes products/report.dedispersion.<platform>.json (or ``--out``); exits
nonzero on gate failure.

    python tools/dedispersion.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from ska_pst_dsp import oracle  # noqa: E402
from ska_pst_dsp.data_gen.config import products_dir  # noqa: E402
from ska_pst_dsp.data_gen.util import NumpyEncoder  # noqa: E402
from ska_pst_dsp.models.signals import SquareWave  # noqa: E402
from ska_pst_dsp.ops import dedispersion  # noqa: E402
from ska_pst_dsp.utils import geometry, windows  # noqa: E402
from ska_pst_dsp.utils.config import load_config  # noqa: E402
from ska_pst_dsp.verify.util import dB  # noqa: E402

GATE = 1e-5


def main(argv=None) -> int:
    import jax

    from ska_pst_dsp.ops import polyphase_analysis, polyphase_synthesis
    from ska_pst_dsp.utils import device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    config = load_config("low")
    # overlap-save validity: the chirp's (one-sided) dispersion delay must
    # fit inside the per-side discard output_overlap = 9216 samples; at
    # 1405 MHz / 40 MHz band the delay is ~4792*dm samples, so dm <= 1.92
    # (the config's 2.64476 is only valid for whole-stream dedispersion)
    dm, f0, bw = 1.5, 1405.0, 40.0
    filt = config.load_fir_filter_coeff()
    os_f = config.os_factor
    n_chan, L, ov = config.channels, config.input_fft_length, config.input_overlap
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    n_bins = geom.fn_width * n_chan * config.blocks * 2
    deripple = filt if config.deripple else None

    sw = SquareWave(period=4096, duty_cycle=0.1, on_amp=4.0, off_amp=0.04,
                    seed=11)
    clean = np.asarray(sw.generate(0, n_bins))[0, 0]
    dispersed = dedispersion.dedisperse(
        clean[None], dm, f0, bw, inverse=True
    )[0].astype(np.complex64)
    hr, hi = (np.asarray(v, np.float32) for v in
              dedispersion.chirp_filter(n_chan * geom.fn_width, dm, f0, bw))

    xr = jax.device_put(np.ascontiguousarray(dispersed.real, np.float32)[None])
    xi = jax.device_put(np.ascontiguousarray(dispersed.imag, np.float32)[None])

    def run(spectral_filter):
        cr, ci = polyphase_analysis((xr, xi), filt, n_chan, os_f)
        rr, ri = polyphase_synthesis(
            (cr, ci), L, os_f, input_overlap=ov, deripple_coeff=deripple,
            temporal_taper=config.temporal_taper,
            spectral_filter=spectral_filter,
        )
        return (np.asarray(rr).astype(np.float64)
                + 1j * np.asarray(ri).astype(np.float64)).reshape(-1)

    got = run((hr, hi))
    chan = oracle.polyphase_analysis(
        dispersed[None, None].astype(np.complex128), filt, n_chan, os_f
    )
    want = oracle.polyphase_synthesis(
        chan, L, os_f, input_overlap=ov, deripple_coeff=deripple,
        temporal_taper=windows.build(config.temporal_taper, L, ov).astype(
            np.float64
        ),
        spectral_filter=hr.astype(np.float64) + 1j * hi.astype(np.float64),
    ).reshape(-1)
    if got.shape != want.shape:
        raise SystemExit(f"shape {got.shape} vs oracle {want.shape}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())

    # informational: commutation against whole-stream dedispersion of the
    # unfiltered inversion
    plain = run(None)
    after = dedispersion.dedisperse(plain[None], dm, f0, bw)[0]
    m = min(after.size, got.size)
    guard = m // 8
    diff = np.abs(got[guard: m - guard] - after[guard: m - guard]) ** 2
    ref = np.abs(after[guard: m - guard]) ** 2
    report = {
        "config": "low",
        **device.record(),
        "path": "ops.polyphase_analysis+ops.polyphase_synthesis"
                "(spectral_filter)",
        "dm": dm,
        "n_compared": int(got.size),
        "device_vs_oracle_max_rel": rel,
        "gate_max_rel": GATE,
        "blockwise_vs_wholestream_mean_db": float(dB(diff.mean() / ref.mean())),
        "blockwise_vs_wholestream_max_db": float(dB(diff.max() / ref.max())),
    }
    report["pass"] = bool(rel < GATE)
    out = a.out or os.path.join(
        products_dir, f"report.dedispersion.{report['backend']}.json"
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
