"""Cross-implementation inversion equivalence.

Equivalent of the reference's
python/verify/test_matlab_dspsr_pfb_inversion.py:29-352 (Matlab Golden ≡
dspsr InverseFilterbank at atol=rtol=1e-6, mean fraction 1.0): the same test
vector is channelized once and inverted through the framework's two
independent implementations (JAX kernels and the fp64 NumPy oracle);
every sample must agree. Variants: impulse, sinusoid, simulated pulsar
(square-wave-modulated noise).

    python -m ska_pst_dsp.verify.test_cross_implementation -c low -t -f
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile

import numpy as np

from .. import data_gen
from ..data_gen.config import products_dir
from ..data_gen.util import NumpyEncoder
from ..io import dada
from ..models.signals import SquareWave
from .common import create_parser

module_logger = logging.getLogger(__name__)

ATOL = RTOL = 1e-6  # test_matlab_dspsr_pfb_inversion.py:35


def _compare_inversions(config, vector_file, out_dir):
    chan = data_gen.channelize(
        vector_file,
        channels=config.channels,
        os_factor_str=str(config.os_factor),
        fir_filter_path=config.fir_filter_path,
        backend="jax",
        use_padded=config.analysis_function == "polyphase_analysis_padded",
        output_dir=out_dir,
        output_file_name="chan.dump",
    )
    inv = {}
    for backend in ("jax", "numpy"):
        f = data_gen.synthesize(
            chan.file_path,
            input_fft_length=config.input_fft_length,
            input_overlap=config.input_overlap,
            fft_window_str=config.temporal_taper,
            apply_deripple=config.deripple,
            backend=backend,
            output_dir=out_dir,
            output_file_name=f"inv.{backend}.dump",
        )
        inv[backend] = f.data
    a, b = inv["jax"], inv["numpy"]
    scale = max(np.abs(b).max(), 1e-30)
    close = np.isclose(a, b, atol=ATOL * scale, rtol=RTOL)
    return {
        "mean": float(close.mean()),
        "sum": int(close.sum()),
        "n": int(close.size),
        "max_rel_diff": float(np.abs(a - b).max() / scale),
    }


def run_suite(config, n_bins=None, do_time=True, do_freq=True,
              do_pulsar=True, output_dir=None):
    out = output_dir or tempfile.mkdtemp()
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks
        )
    report = {}
    if do_time:
        gen = data_gen.generate_test_vector(
            backend="numpy", domain_name="time", n_bins=n_bins
        )
        f = gen([0.11], [1], output_dir=out, n_pol=config.n_pol)
        report["test_time_domain_impulse"] = [
            {"offset": 0.11, **_compare_inversions(config, f.file_path, out)}
        ]
    if do_freq:
        gen = data_gen.generate_test_vector(
            backend="numpy", domain_name="freq", n_bins=n_bins
        )
        f = gen([0.11], [np.pi / 4], output_dir=out, n_pol=config.n_pol)
        report["test_complex_sinusoid"] = [
            {"freq": 0.11, **_compare_inversions(config, f.file_path, out)}
        ]
    if do_pulsar:
        # simulated pulsar: square-wave-modulated noise (the checked-in
        # simulated_pulsar dump of the reference, regenerated)
        sw = SquareWave(period=1024, duty_cycle=0.1, on_amp=4.0, off_amp=0.25,
                        seed=3)
        x = np.asarray(sw.generate(0, n_bins))
        x = np.repeat(x, config.n_pol, axis=0)
        path = os.path.join(out, "simulated_pulsar.dump")
        hdr = config.load_header()
        dada.save(path, x, hdr)
        report["test_simulated_pulsar"] = [
            _compare_inversions(config, path, out)
        ]
    return report


def main(argv=None):
    parsed = create_parser(
        description="JAX ≡ oracle PFB inversion equivalence"
    ).parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    config = data_gen.config.load_config(parsed.sub_config_name)
    do_all = not (parsed.do_time or parsed.do_freq)
    report = run_suite(
        config,
        do_time=parsed.do_time or do_all,
        do_freq=parsed.do_freq or do_all,
        do_pulsar=do_all,
    )
    module_logger.info("%s", json.dumps(report, indent=2, cls=NumpyEncoder))
    os.makedirs(products_dir, exist_ok=True)
    with open(os.path.join(products_dir, "report.cross_impl.json"), "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    ok = all(e["mean"] > 0.999 for rs in report.values() for e in rs)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
