"""current_performance / purity alignment for padded (SKA-Mid-style) configs.

Round-2 shipped garbage reconstruction diffs for `-c mid` because chop()
used the non-padded shift formula (output_overlap + (taps-1)//2) while the
padded analysis kernel removes its group delay internally (reference
alignment semantics: current_performance.m:286, chop.m:1-46). These tests
pin the padded branch of geometry.total_sample_shift functionally — an
impulse must land exactly where chop expects it — so a mis-chop can never
again produce a "max diff² = 1.0" report silently.
"""

import dataclasses
import json

import numpy as np
import pytest

from ska_pst_dsp.cli import current_performance as cp
from ska_pst_dsp.design import fir
from ska_pst_dsp.ops import polyphase_analysis_padded, polyphase_synthesis
from ska_pst_dsp.utils import geometry
from ska_pst_dsp.utils.config import Config, load_config
from ska_pst_dsp.utils.rational import Rational


def _small_padded_config(tmp_path):
    """A fast padded-analysis config: 256 chan, OS 8/7, 1793-tap FIR."""
    return Config(
        name="mid_small",
        analysis_function="polyphase_analysis_padded",
        os_factor=Rational(8, 7),
        channels=256,
        input_fft_length=128,
        input_overlap=32,
        fir_filter_coeff_file_path="Prototype_FIR.new.8-7.256.test.npy",
        fir_filter_taps=1793,
        blocks=3,
        config_dir=str(tmp_path),
    )


def test_mid_total_sample_shift_formula():
    """At the production mid geometry the padded chain's verified shift is
    output_overlap - 1 (tests/test_mid_production.py derivation)."""
    geom = geometry.SynthesisGeometry(4096, 512, 128, Rational(8, 7))
    assert geometry.total_sample_shift(
        4096, Rational(8, 7), 100353, 128, padded=True
    ) == geom.output_overlap - 1 == 458_751


def test_padded_shift_small_geometry():
    """The padded chain's shift is output_overlap - 1 at any geometry whose
    FIR group delay is a whole number of steps (all production padded
    configs); an impulse lands exactly there with ~unit amplitude."""
    n_chan, L, ov = 256, 128, 32
    os_f = Rational(8, 7)
    step = geometry.analysis_step(n_chan, os_f)  # 224
    filt = np.asarray(fir.design_pfb_fir_filter(n_chan, os_f, 7))  # 1793
    assert (filt.size - 1) // 2 % step == 0
    shift = geometry.total_sample_shift(
        n_chan, os_f, filt.size, ov, padded=True
    )
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    assert shift == geom.output_overlap - 1

    nfine = 2 * ov + 2 * geom.input_keep
    n_dat = nfine * step
    offset = shift + 1000
    x = np.zeros(n_dat, dtype=np.complex64)
    x[offset] = 1.0
    chan = polyphase_analysis_padded(x[None, None], filt, n_chan, os_f)
    inv = np.asarray(
        polyphase_synthesis(
            chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
            temporal_taper="tukey",
        )
    )[0, 0]
    pk = int(np.abs(inv).argmax())
    assert pk == offset - shift
    assert abs(abs(inv[pk]) - 1.0) < 1e-2


def test_published_mid_products_sane():
    """The published products for the mid config must never regress to the
    round-2 mis-chop garbage (max diff^2 = 1.0): every in-window point must
    reconstruct to < 1e-6 and meet the -60 dB requirement."""
    import os

    from ska_pst_dsp.data_gen.config import products_dir

    for dom in ("temporal", "spectral"):
        path = os.path.join(products_dir, f"performance.{dom}.mid.json")
        if not os.path.exists(path):
            pytest.skip("mid products not generated")
        rows = json.load(open(path))[dom]
        assert rows
        for r in rows:
            if not r.get("in_window", True):
                continue
            assert r["max"] < 1e-6, r
            if "max_spurious" in r:
                assert r["max_spurious"] < -60.0, r


class TestCurrentPerformancePadded:
    @pytest.fixture(scope="class")
    def cfg(self, tmp_path_factory):
        return _small_padded_config(tmp_path_factory.mktemp("cp_cfg"))

    def test_impulse_chop_alignment(self, cfg):
        """An impulse through the padded pipeline must reconstruct in place
        after chop — a mis-chop (the round-2 bug) misses the impulse
        entirely and scores max |diff|^2 = 1.0. The small geometry's own
        sidelobes sit at ~-40 dB (identical in the fp64 oracle), so the
        gate here is 1e-3; the production-geometry gate lives in the
        regenerated products and test_mid_production."""
        from ska_pst_dsp.data_gen.generate_test_vector import (
            time_domain_impulse,
        )
        from ska_pst_dsp.verify.util import DomainPerformance

        os_f = cfg.os_factor
        block_size = os_f.normalize(cfg.input_fft_length) * cfg.channels
        output_overlap = os_f.normalize(cfg.input_overlap) * cfg.channels
        n_samples = block_size * cfg.blocks
        shift = geometry.total_sample_shift(
            cfg.channels, os_f, cfg.fir_filter_taps, cfg.input_overlap,
            padded=True,
        )
        perf = DomainPerformance(guard=2)
        # boundary, boundary ± overlap, and an interior point
        seam = shift + block_size - 2 * output_overlap
        for off in (seam, seam - output_overlap, seam + output_overlap,
                    shift + 12345):
            sig = time_domain_impulse(n_samples, [int(off)], [1],
                                      dtype=np.complex64)
            inp, inv, meta = cp.test_data_pipeline(cfg, sig, backend="jax")
            ichop, vchop = cp.chop(cfg, inp, inv, meta)
            r = perf.temporal_difference(ichop, vchop)
            assert r["max"] < 1e-3, (off, r)
            # the impulse itself must reconstruct in place at ~unit amplitude
            rel = off - shift
            assert abs(abs(vchop[rel]) - 1.0) < 1e-2, (off, vchop[rel])

    def test_sinusoid_chop_alignment(self, cfg):
        from ska_pst_dsp.data_gen.generate_test_vector import (
            complex_sinusoid,
        )
        from ska_pst_dsp.verify.util import DomainPerformance

        os_f = cfg.os_factor
        block_size = os_f.normalize(cfg.input_fft_length) * cfg.channels
        n_samples = block_size * cfg.blocks
        perf = DomainPerformance(guard=2)
        # a mid-band tone: at this frequency a chop off by even ONE sample
        # de-phases to mean diff^2 ~ 5e-2 (measured), while correct
        # alignment sits at the geometry's ~1e-4 algorithmic floor
        sig = complex_sinusoid(n_samples, [cfg.blocks * 1000], [np.pi / 4],
                               dtype=np.complex64)
        inp, inv, meta = cp.test_data_pipeline(cfg, sig, backend="jax")
        ichop, vchop = cp.chop(cfg, inp, inv, meta)
        r = perf.temporal_difference(ichop, vchop)
        assert r["mean"] < 5e-3, r


def test_published_gpu_purity_products():
    """The on-chip purity products (tools/purity.py: the plain ops compiled
    for the GPU, run on an H100) must exist and meet the -60 dB
    requirement, and must name the card they ran on."""
    import os

    from ska_pst_dsp.data_gen.config import products_dir

    for cfg in ("low", "mid"):
        path = os.path.join(products_dir, f"report.purity.gpu.{cfg}.json")
        assert os.path.exists(path), (
            f"on-chip purity product missing for {cfg} — run "
            f"tools/purity.py -c {cfg} on the GPU"
        )
        rep = json.load(open(path))
        assert rep["pass"] is True, rep
        assert rep["worst_in_window_max_spurious_dB"] <= -60.0
        assert rep["backend"] == "gpu", rep["backend"]
        assert "W" in rep["nvidia_smi"], rep["nvidia_smi"]  # power limit
        assert rep["temporal"] and rep["spectral"]


def test_published_gpu_dedispersion_product():
    """The on-chip dedispersion product (tools/dedispersion.py) must show
    the GPU's spectral_filter slot matching the fp64 oracle."""
    import os

    from ska_pst_dsp.data_gen.config import products_dir

    path = os.path.join(products_dir, "report.dedispersion.gpu.json")
    assert os.path.exists(path), (
        "on-chip dedispersion product missing — run tools/dedispersion.py "
        "on the GPU"
    )
    rep = json.load(open(path))
    assert rep["pass"] is True, rep
    assert rep["device_vs_oracle_max_rel"] < 1e-5
    assert rep["backend"] == "gpu", rep["backend"]


def test_published_purity_sweeps_are_dense():
    """The on-chip sweeps must place >= 20 adversarial points per domain
    (block boundaries ± overlap for impulses, per-bin tones) so seam bugs
    in the compiled path cannot hide."""
    import os

    from ska_pst_dsp.data_gen.config import products_dir

    for cfg in ("low", "mid"):
        rep = json.load(
            open(os.path.join(products_dir, f"report.purity.gpu.{cfg}.json"))
        )
        assert len(rep["temporal"]) >= 20, (cfg, len(rep["temporal"]))
        assert len(rep["spectral"]) >= 20, (cfg, len(rep["spectral"]))


def test_published_scaling_report_schema():
    """The scaling report must carry compiled-HLO collective stats per
    device count and must NOT publish wall-clock 'efficiency' measured on
    an oversubscribed virtual mesh (round-4's misreadable 14% artifact)."""
    import os

    from ska_pst_dsp.data_gen.config import products_dir

    rep = json.load(open(os.path.join(products_dir, "report.scaling.json")))
    assert rep["runs"], rep
    for nd, entry in rep["runs"].items():
        c = entry["1d"]["collectives"]
        assert any(k != "none" for k in c), (nd, c)
        total = sum(v["payload_bytes"] for v in c.values())
        if int(nd) > 1:
            assert total > 0, (nd, c)
        assert "efficiency" not in entry["1d"]
        if rep.get("virtual_devices"):
            assert "msps" not in entry["1d"]
    assert "comm_model" in rep
