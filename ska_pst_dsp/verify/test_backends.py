"""Backend equivalence verification.

Equivalent of the reference's python/verify/test_backends.py:28-122 (python
``pfb`` channelizer vs Matlab channelizer on a tone vector, isclose at
1e-4): here the two independent implementations are the JAX kernels and
the fp64 NumPy oracle, compared through the full file-level pipeline.

    python -m ska_pst_dsp.verify.test_backends -c low [--use-padded]
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
from .common import create_parser

module_logger = logging.getLogger(__name__)

#: fp32 kernel vs fp64 oracle, relative to the output scale (the reference
#: compares two fp32 implementations at atol=rtol=1e-4; ours is tighter)
REL_ATOL = 1e-6
RTOL = 1e-4


def compare_channelizer_backends(config, *, use_padded=False, n_bins=None,
                                 output_dir=None, freq=0.26):
    out = output_dir or tempfile.mkdtemp()
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks
        )
    gen = data_gen.generate_test_vector(
        backend="numpy", domain_name="freq", n_bins=n_bins
    )
    tone = gen([freq], [np.pi / 4], output_dir=out, n_pol=config.n_pol)
    results = {}
    for backend in ("jax", "numpy"):
        f = data_gen.channelize(
            tone.file_path,
            channels=config.channels,
            os_factor_str=str(config.os_factor),
            fir_filter_path=config.fir_filter_path,
            backend=backend,
            use_padded=use_padded,
            output_dir=out,
            output_file_name=f"chan.{backend}.dump",
        )
        results[backend] = f.data
    a, b = results["jax"], results["numpy"]
    scale = float(np.abs(b).max())
    close = np.isclose(a, b, atol=REL_ATOL * scale, rtol=RTOL)
    report = {
        "mean_close": float(close.mean()),
        "max_rel_diff": float(np.abs(a - b).max() / scale),
        "atol": REL_ATOL * scale,
        "n_compared": int(close.size),
        "use_padded": use_padded,
    }
    return report


def main(argv=None):
    parsed = create_parser(
        description="JAX-vs-oracle channelizer backend equivalence"
    )
    parsed.add_argument("--use-padded", dest="use_padded",
                        action="store_true")
    a = parsed.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    config = data_gen.config.load_config(a.sub_config_name)
    report = compare_channelizer_backends(config, use_padded=a.use_padded)
    module_logger.info("backend equivalence: %s", report)
    os.makedirs(products_dir, exist_ok=True)
    with open(os.path.join(products_dir, "report.backends.json"), "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    sys.exit(0 if report["mean_close"] == 1.0 else 1)


if __name__ == "__main__":
    main()
