"""Smoke test of the system on one GPU, through the entry points a user calls.

Phases, in one process, each printing one line; any failure exits non-zero:

  1. device     JAX's first device must be a GPU; prints the card's name and
                power limit from nvidia-smi.
  2. low        SKA-Low round trip (256 ch, OS 4/3, 3073 taps, L=256/ov=48)
                on 2 pol x 2^23 samples through ops.polyphase_analysis ->
                ops.polyphase_synthesis (tuple API, on device): pol 0 carries
                a tone (purity <= -60 dB), pol 1 an impulse (peak at
                offset - total_sample_shift, leakage <= -60 dB); then the
                same geometry on a few inversion blocks of noise against the
                fp64 NumPy oracle (max|gpu - oracle| / max|oracle| <= 1e-5).
  3. mid        SKA-Mid round trip (4096 ch, OS 8/7, the 100353-tap two-stage
                filter, L=512/ov=128, 1,835,008-point backward FFT) on
                2 pol x (2*128 + 4*256)*3584 samples through
                ops.polyphase_analysis_padded -> ops.polyphase_synthesis;
                the same three checks.
  4. sgcht      the streaming driver, in-process: cli.sgcht.run for
                --cfg low --signal complex_sinusoid --invert --test -> 0.
  5. memory     compiled.memory_analysis() of the Low and Mid steps and the
                device's peak_bytes_in_use.

The last line of output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

    python chip_smoke.py            # the phases above, one card
    python chip_smoke.py --multi    # only the sharded dry run on 4 cards
"""

import argparse
import json
import sys
import time

import numpy as np

PURITY_DB = -60.0
ORACLE_REL = 1e-5


def _phase(name, **info):
    print(f"phase {name}: ok {json.dumps(info)}", flush=True)


def _round_trip(filt, n_chan, os_f, L, ov, padded):
    """The user's round trip as one jitted step on (re, im) float32 pairs."""
    import jax

    from ska_pst_dsp.ops import (
        polyphase_analysis, polyphase_analysis_padded, polyphase_synthesis,
    )

    analysis = polyphase_analysis_padded if padded else polyphase_analysis

    def forward(xr, xi):
        cr, ci = analysis((xr, xi), filt, n_chan, os_f)
        return polyphase_synthesis(
            (cr, ci), L, os_f, input_overlap=ov, deripple_coeff=filt,
            temporal_taper="tukey",
        )

    return jax.jit(forward)


def _run(step, x):
    """Run the compiled step on a complex (n_pol, n_dat) host stream; returns
    the (n_pol, n_out) complex output and the compiled executable."""
    import jax

    xr = jax.device_put(np.ascontiguousarray(x.real, dtype=np.float32))
    xi = jax.device_put(np.ascontiguousarray(x.imag, dtype=np.float32))
    compiled = step.lower(xr, xi).compile()
    rr, ri = compiled(xr, xi)
    out = np.asarray(rr)[:, 0].astype(np.float64) + 1j * np.asarray(ri)[:, 0]
    return out, compiled


def _check_cell(name, filt, n_chan, os_f, L, ov, n_dat, n_oracle, padded):
    """Tone, impulse and oracle checks of one round-trip geometry."""
    from ska_pst_dsp import oracle
    from ska_pst_dsp.utils import geometry, windows
    from ska_pst_dsp.verify.util import DomainPerformance

    t0 = time.perf_counter()
    step = _round_trip(filt, n_chan, os_f, L, ov, padded)
    shift = geometry.total_sample_shift(n_chan, os_f, filt.size, ov,
                                        padded=padded)
    freq = 80.5 / 1024  # an exact bin of any 2048-multiple FFT length
    x = np.zeros((2, n_dat), dtype=np.complex64)
    x[0] = np.exp(2j * np.pi * ((freq * np.arange(n_dat)) % 1.0))
    offset = shift + n_dat // 4  # well inside the output of both cells
    x[1, offset] = 1.0
    out, compiled = _run(step, x)
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{name}: non-finite output")

    perf = DomainPerformance(guard=1)
    nfft = (out.shape[1] // 2048) * 2048
    tone_db = perf.spectral_performance(out[0], nfft)["max_spurious"]
    peak = int(np.abs(out[1]).argmax())
    imp_db = perf.temporal_performance(out[1])["max_spurious"]
    if tone_db > PURITY_DB:
        raise AssertionError(f"{name}: tone purity {tone_db:.2f} dB")
    if peak != offset - shift:
        raise AssertionError(
            f"{name}: impulse peak at {peak}, expected {offset - shift}"
        )
    if imp_db > PURITY_DB:
        raise AssertionError(f"{name}: impulse leakage {imp_db:.2f} dB")

    rng = np.random.default_rng(0)
    xn = (rng.standard_normal((2, n_oracle))
          + 1j * rng.standard_normal((2, n_oracle))).astype(np.complex64)
    got, _ = _run(step, xn)
    ana = oracle.polyphase_analysis_padded if padded else oracle.polyphase_analysis
    chan = ana(xn[:, None, :].astype(np.complex128), filt, n_chan, os_f)
    want = oracle.polyphase_synthesis(
        chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
        temporal_taper=windows.tukey_window(L, ov).astype(np.float64),
    )[:, 0]
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs oracle {want.shape}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if not rel <= ORACLE_REL:
        raise AssertionError(f"{name}: oracle rel err {rel:.3e}")
    _phase(name, samples=2 * n_dat, out_shape=list(out.shape),
           tone_max_spurious_dB=tone_db, impulse_peak=peak,
           impulse_expected=offset - shift, impulse_max_spurious_dB=imp_db,
           oracle_samples=2 * n_oracle, oracle_max_rel_err=rel,
           seconds=time.perf_counter() - t0)
    return compiled


def _memory(compiled):
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
    )}


def single_card(dev):
    from ska_pst_dsp.cli import sgcht
    from ska_pst_dsp.design import fir
    from ska_pst_dsp.utils import geometry
    from ska_pst_dsp.utils.rational import Rational

    os_low = Rational(4, 3)
    filt_low = fir.design_pfb_fir_filter(256, os_low, 12)
    low_keep = 256 - 2 * 48
    low = _check_cell(
        "low", filt_low, 256, os_low, 256, 48, n_dat=2**23,
        n_oracle=geometry.padded_filter_length(filt_low.size, 256)
        + (2 * 48 + 4 * low_keep) * 192,
        padded=False,
    )

    os_mid = Rational(8, 7)
    filt_mid = fir.design_pfb_fir_filter_two_stage(4096, os_mid, 28)
    if filt_mid.size != 100353:
        raise AssertionError(f"mid filter has {filt_mid.size} taps")
    step_mid = geometry.analysis_step(4096, os_mid)
    mid = _check_cell(
        "mid", filt_mid, 4096, os_mid, 512, 128,
        n_dat=(2 * 128 + 4 * 256) * step_mid,
        n_oracle=(2 * 128 + 2 * 256) * step_mid,
        padded=True,
    )

    t0 = time.perf_counter()
    rc = sgcht.run(["--cfg", "low", "--signal", "complex_sinusoid",
                    "--invert", "--test", "--blocks", "8",
                    "--blocksz", str(2**20)])
    if rc != 0:
        raise AssertionError(f"sgcht returned {rc}")
    _phase("sgcht", rc=rc, samples=8 * 2**20,
           seconds=time.perf_counter() - t0)

    import jax

    stats = jax.devices()[0].memory_stats() or {}
    _phase("memory", low=_memory(low), mid=_memory(mid),
           peak_bytes_in_use=stats.get("peak_bytes_in_use"))


def multi_card(dev):
    import __graft_entry__

    if dev["count"] != 4:
        raise SystemExit(f"--multi needs 4 cards, JAX sees {dev['count']}")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    _phase("multichip", n_devices=4, seconds=time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the sharded dry run on 4 cards")
    a = p.parse_args(argv)

    from ska_pst_dsp.utils import compile_cache, device

    dev = device.require_gpu()
    smi = device.nvidia_smi()
    print(smi, flush=True)
    _phase("device", nvidia_smi=smi, **dev)
    compile_cache.enable()
    (multi_card if a.multi else single_card)(dev)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
