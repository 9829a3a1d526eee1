"""PFB inversion parameter studies.

Equivalents of the reference's matlab/pfb_param_opt/ scripts:
derippling_effect.m:1-60 (reconstruction error with deripple on/off versus
filter length), overlap_effect.m:1-80 and overlap_parameter_search.m:1-216
(overlap-save discard size versus purity), phase_offset_effect.m (tone
phase versus reconstruction error).

Each study runs tones/impulses through a one-shot analysis+inversion with a
swept parameter and reports max/total spurious power; results are returned
as records and optionally plotted.

    python -m ska_pst_dsp.analysis.param_opt --study overlap -c low
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from typing import List, Optional

import numpy as np

from ..data_gen.config import products_dir
from ..data_gen.generate_test_vector import complex_sinusoid
from ..data_gen.util import NumpyEncoder
from ..design import fir
from ..ops import polyphase_analysis, polyphase_synthesis
from ..utils import geometry
from ..utils.config import load_config
from ..utils.rational import Rational
from ..verify.util import DomainPerformance, dB, mean_spurious

module_logger = logging.getLogger(__name__)


def _roundtrip(sig, filt, n_chan, os_f, L, ov, deripple, taper="tukey"):
    chan = polyphase_analysis(sig[None, None], filt, n_chan, os_f)
    inv = np.asarray(
        polyphase_synthesis(
            chan, L, os_f, input_overlap=ov,
            deripple_coeff=filt if deripple else None, temporal_taper=taper,
        )
    )[0, 0]
    shift = geometry.total_sample_shift(n_chan, os_f, filt.size, ov)
    n = min(inv.size, sig.size - shift)
    return sig[shift: shift + n], inv[:n]


def derippling_effect(n_chan=64, os_f=Rational(4, 3), L=128, ov=24,
                      taps_per_chan=(6, 8, 12, 16, 20), freq_bin=0.23):
    """Deripple on/off reconstruction error versus filter length
    (derippling_effect.m)."""
    perf = DomainPerformance(guard=1)
    records = []
    for tpc in taps_per_chan:
        filt = fir.design_pfb_fir_filter(n_chan, os_f, tpc)
        block = os_f.normalize(L) * n_chan
        sig = complex_sinusoid(block * 4, [freq_bin], [np.pi / 4],
                               dtype=np.complex64)
        for deripple in (False, True):
            inp, inv = _roundtrip(sig, filt, n_chan, os_f, L, ov, deripple)
            d = perf.temporal_difference(inp, inv)
            records.append({
                "taps_per_chan": tpc, "deripple": deripple,
                "mean_diff": d["mean"], "max_diff": d["max"],
            })
            module_logger.info("%s", records[-1])
    return records


def overlap_effect(n_chan=64, os_f=Rational(4, 3), L=128,
                   overlaps=(0, 8, 16, 24, 32, 40), freq_bin=0.23):
    """Overlap-discard size versus spectral purity (overlap_effect.m /
    overlap_parameter_search.m)."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    records = []
    for ov in overlaps:
        if (L - 2 * ov) <= 0 or (os_f.normalize(ov * os_f.nu) % os_f.nu):
            pass
        try:
            block = os_f.normalize(L) * n_chan
        except ValueError:
            continue
        sig = complex_sinusoid(block * 4, [freq_bin], [np.pi / 4],
                               dtype=np.complex64)
        try:
            inp, inv = _roundtrip(sig, filt, n_chan, os_f, L, ov, True)
        except ValueError:
            continue
        nfft = (inv.size // block) * block
        if nfft == 0:
            continue
        r = perf.spectral_performance(inv, nfft)
        d = perf.temporal_difference(inp, inv)
        records.append({"overlap": ov, **r, "mean_diff": d["mean"]})
        module_logger.info("%s", records[-1])
    return records


def phase_offset_effect(n_chan=64, os_f=Rational(4, 3), L=128, ov=24,
                        phases=np.linspace(0, 2 * np.pi, 9)):
    """Tone phase versus reconstruction error (phase_offset_effect.m)."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    block = os_f.normalize(L) * n_chan
    records = []
    for ph in phases:
        sig = complex_sinusoid(block * 4, [0.23], [float(ph)],
                               dtype=np.complex64)
        inp, inv = _roundtrip(sig, filt, n_chan, os_f, L, ov, True)
        d = perf.temporal_difference(inp, inv)
        records.append({"phase": float(ph), "mean_diff": d["mean"],
                        "max_diff": d["max"]})
        module_logger.info("%s", records[-1])
    return records


def overlap_parameter_search(n_chan=256, os_f=Rational(4, 3),
                             fft_lengths=(512, 1024, 2048),
                             overlaps=(128, 256, 512),
                             npoints=200, nblocks=3, window="tukey"):
    """2-D exhaustive fft_length x overlap x window purity search
    (overlap_parameter_search.m:1-216): for every (input_fft_length,
    overlap) combination with L/ov > 2, sweep ~npoints tone frequencies
    across one block (freq_domain_offsets, :30-35) through the
    analysis + Golden-inversion round trip, recording the reference's six
    spectral measures (:59-66): max/total/mean power of the time-series
    difference and max/total/mean spurious power of the inverted
    spectrum at the reference's 2*block FFT length (:106)."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    records = []
    for L in fft_lengths:
        for ov in overlaps:
            if L / ov <= 2:
                continue  # :68-70
            block = os_f.normalize(L) * n_chan
            nbins = nblocks * block
            nfft = min(2 * block, nbins)
            stepf = max(1, round(block / npoints))
            freqs = np.arange(1, block + 1, stepf) * nblocks
            for fbin in freqs:
                sig = complex_sinusoid(
                    nbins, [int(fbin)], [np.pi / 4], dtype=np.complex64
                )
                try:
                    inp, inv = _roundtrip(
                        sig, filt, n_chan, os_f, L, ov, True, taper=window
                    )
                except ValueError:
                    continue
                if inv.size < nfft:
                    continue
                d = perf.temporal_difference(inp, inv)
                s = perf.spectral_performance(inv, nfft)
                spec = np.fft.fft(np.asarray(inv).ravel()[:nfft]) / nfft
                records.append({
                    "fft_length": L, "overlap": ov, "window": window,
                    "frequency": int(fbin),
                    "diff_max": float(dB(d["max"])),
                    "diff_sum": float(dB(d["sum"])),
                    "diff_mean": float(dB(d["mean"])),
                    "max_spurious": s["max_spurious"],
                    "total_spurious": s["total_spurious"],
                    "mean_spurious": mean_spurious(spec),
                })
            if records:
                last = [r for r in records
                        if r["fft_length"] == L and r["overlap"] == ov]
                if last:
                    worst = max(r["max_spurious"] for r in last)
                    module_logger.info(
                        "L=%d ov=%d: %d points, worst max_spurious %.1f dB",
                        L, ov, len(last), worst)
    return records


def pipeline_study(n_chan=8, os_f=Rational(8, 7), L=128, nblocks=400):
    """The pfb_param_opt study driver (pipeline.m:1-80): one tone and one
    impulse through the analysis + inversion round trip at the study
    geometry (8 chan, OS 8/7, L=128, zero overlap), with the run's meta
    recorded alongside the performance measures — the role of
    ``dump_meta_data`` + ``pipeline.{freq,time}.meta.json``."""
    from ..data_gen.generate_test_vector import time_domain_impulse

    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 10)
    block = os_f.normalize(L) * n_chan
    nbins = nblocks * block
    records = []

    tone = complex_sinusoid(nbins, [4], [np.pi / 4], dtype=np.complex64)
    inp, inv = _roundtrip(tone, filt, n_chan, os_f, L, 0, True)
    nfft = (inv.size // block) * block
    records.append({
        "signal": "complex_sinusoid", "frequency": 4, "phase": np.pi / 4,
        "n_bins": nbins, "input_fft_length": L, "overlap": 0,
        **perf.spectral_performance(inv, nfft),
        "mean_diff": perf.temporal_difference(inp, inv)["mean"],
    })
    module_logger.info("%s", records[-1])

    pos = int(0.1874 * nbins)
    imp = time_domain_impulse(nbins, [pos], [1], dtype=np.complex64)
    inp, inv = _roundtrip(imp, filt, n_chan, os_f, L, 0, True)
    records.append({
        "signal": "time_domain_impulse", "impulse_position": pos,
        "impulse_width": 1, "n_bins": nbins,
        "input_fft_length": L, "overlap": 0,
        **perf.temporal_performance(inv),
        "mean_diff": perf.temporal_difference(inp, inv)["mean"],
    })
    module_logger.info("%s", records[-1])
    return records


STUDIES = {
    "deripple": derippling_effect,
    "overlap": overlap_effect,
    "phase": phase_offset_effect,
    "search": overlap_parameter_search,
    "pipeline": pipeline_study,
}


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="param_opt",
                                description="PFB parameter studies")
    p.add_argument("--study", choices=sorted(STUDIES), default="overlap")
    p.add_argument("--npoints", type=int, default=0,
                   help="frequency points per combo (search study; "
                        "default = the reference's 200)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    kwargs = {}
    if a.study == "search" and a.npoints:
        kwargs["npoints"] = a.npoints
    records = STUDIES[a.study](**kwargs)
    os.makedirs(products_dir, exist_ok=True)
    out = os.path.join(
        products_dir,
        "report.param_search.json" if a.study == "search"
        else f"param_opt.{a.study}.json",
    )
    with open(out, "w") as f:
        json.dump(records, f, cls=NumpyEncoder, indent=2)
    module_logger.info("study written to %s", out)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
