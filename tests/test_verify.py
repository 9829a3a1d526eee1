"""Tests for the verification harness: comparator, metrics, purity suite
(small geometry), cross-implementation equivalence, dedispersion."""

import json
import os

import numpy as np
import pytest

from ska_pst_dsp.verify import comparator, util as vutil
from ska_pst_dsp.verify.purity import TestPurity
from ska_pst_dsp.ops import dedispersion
from ska_pst_dsp.utils.rational import Rational


class TestComparator:
    def test_single_domain(self):
        c = comparator.TimeDomainComparator("time")
        c.operators["this"] = lambda a: a
        c.operators["diff"] = lambda a, b: a - b
        c.products["mean"] = lambda a: float(np.mean(np.abs(a)))
        a = np.ones(10)
        b = np.zeros(10)
        ops, prods = c(a, b)
        assert prods["diff"][0, 1]["mean"] == 1.0
        assert prods["this"][0]["mean"] == 1.0
        np.testing.assert_array_equal(ops["diff"][1, 0], b - a)

    def test_freq_domain_transform(self):
        c = comparator.FrequencyDomainComparator()
        c.operators["this"] = lambda a: a
        c.products["peak"] = lambda a: int(np.abs(a).argmax())
        x = np.exp(2j * np.pi * 5 * np.arange(64) / 64)
        _, prods = c(x)
        assert prods["this"][0]["peak"] == 5

    def test_multi_domain_shared_registry(self):
        m = comparator.MultiDomainComparator(
            domains={
                "time": comparator.TimeDomainComparator(),
                "freq": comparator.FrequencyDomainComparator(),
            }
        )
        m.operators["this"] = lambda a: a
        m.products["max"] = lambda a: float(np.abs(a).max())
        _, p1 = m.time(np.ones(8))
        _, p2 = m.freq(np.ones(8))
        assert p1["this"][0]["max"] == 1.0
        assert p2["this"][0]["max"] == 8.0  # DC bin of the FFT


class TestMetrics:
    def test_spurious_zeroes_peak(self):
        a = np.array([1.0, 5.0, 2.0])
        out = vutil.spurious(a)
        np.testing.assert_array_equal(out, [1.0, 0.0, 2.0])

    def test_max_spurious_db(self):
        a = np.zeros(100)
        a[10] = 1.0
        a[20] = 1e-3  # -60 dB in power
        assert vutil.max_spurious(a) == pytest.approx(-60, abs=0.1)

    def test_domain_performance(self):
        dp = vutil.DomainPerformance(guard=1)
        x = np.zeros(1000)
        x[500] = 1.0
        x[600] = 1e-4
        perf = dp.temporal_performance(x)
        assert perf["max_spurious"] == pytest.approx(-80, abs=0.5)
        d = dp.temporal_difference(x, x)
        assert d["max"] == 0.0


class TestPuritySuite:
    """Run the full purity harness on a small geometry and check it emits a
    report meeting the SKAO requirement."""

    @pytest.fixture(scope="class")
    def purity(self, tmp_path_factory):
        import ska_pst_dsp.data_gen.config as dgc
        import dataclasses

        out = str(tmp_path_factory.mktemp("purity"))
        cfg = dgc.load_config("low")
        # small surrogate geometry: 64 channels, short FIR
        p = TestPurity(
            n_test=2,
            os_factor="4/3",
            input_fft_length=128,
            input_overlap=24,
            fft_window="tukey",
            deripple=True,
            channels=64,
            fir_filter_taps=769,
            blocks=3,
            backend={"test_vectors": "numpy", "channelize": "jax",
                     "synthesize": "jax"},
            output_dir=out,
            make_plots=False,
        )
        # point the channelizer/synthesizer at a matching small filter
        from ska_pst_dsp.design import fir as fir_design
        import ska_pst_dsp.data_gen.channelize as dgch

        filt = fir_design.design_pfb_fir_filter(64, Rational(4, 3), 12)
        import ska_pst_dsp.data_gen as dg

        p.channelizer = dg.channelize(
            backend="jax", channels=64, os_factor_str="4/3",
            fir_filter_path=_write_filt(out, filt),
        )
        p.pipeline = dg.pipeline(
            p.generator, p.channelizer, lambda a, **k: a, output_dir=out
        )
        return p

    def test_temporal_and_report(self, purity):
        rep = purity.temporal_purity()
        assert len(rep) == 2
        # mid-stream impulse must satisfy the -60 dB requirement
        mid = [r for r in rep if 0 < r["arg"] < purity.n_samples - 1]
        for r in mid:
            assert r["max_spurious_power"] < -60
        path = purity.finish()
        assert os.path.exists(path)
        with open(path) as f:
            loaded = json.load(f)
        assert "test_time_domain_impulse" in loaded


def _write_filt(d, filt):
    import numpy as np

    path = os.path.join(d, "filt.npy")
    np.save(path, filt)
    return path


class TestDedispersion:
    def test_roundtrip_identity(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(
            np.complex64
        )[None, :]
        d = dedispersion.dedisperse(x, dm=10.0, center_freq_mhz=1405.0,
                                    bw_mhz=40.0)
        back = dedispersion.dedisperse(d, dm=10.0, center_freq_mhz=1405.0,
                                       bw_mhz=40.0, inverse=True)
        np.testing.assert_allclose(back, x, atol=2e-5)

    def test_delay_direction_and_magnitude(self):
        """A dispersed impulse must arrive later at lower frequencies; the
        chirp must undo an analytic dispersion delay."""
        n = 1 << 16
        bw, f0 = 1.0, 300.0  # 1 MHz band at 300 MHz -> measurable delay
        dm = 1.0
        # impulse mid-stream
        x = np.zeros(n, dtype=np.complex64)
        x[n // 2] = 1.0
        # disperse then dedisperse restores the impulse position
        disp = dedispersion.dedisperse(x[None], dm, f0, bw, inverse=True)
        assert np.abs(disp).argmax() != n // 2 or np.abs(disp[0]).max() < 0.9
        clean = dedispersion.dedisperse(disp, dm, f0, bw)
        assert int(np.abs(clean[0]).argmax()) == n // 2
        assert np.abs(clean[0]).max() > 0.99

    def test_inversion_commutes_with_dedispersion(self):
        """The reference's dedispersion invariance check
        (test_dedispersion.py): dedisperse(invert(channelize(x))) must equal
        dedisperse(x) to the inversion's error floor."""
        from ska_pst_dsp.ops import polyphase_analysis, polyphase_synthesis
        from ska_pst_dsp.utils import geometry
        from ska_pst_dsp.design import fir as fir_design

        os_f = Rational(4, 3)
        n_chan, L, ov = 64, 128, 24
        filt = fir_design.design_pfb_fir_filter(n_chan, os_f, 12)
        n = 2**16
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        chan = polyphase_analysis(x[None, None], filt, n_chan, os_f)
        inv = np.asarray(
            polyphase_synthesis(chan, L, os_f, input_overlap=ov,
                                deripple_coeff=filt, temporal_taper="tukey")
        )[0, 0]
        shift = geometry.total_sample_shift(n_chan, os_f, filt.size, ov)
        m = (min(inv.size, n - shift) // 2) * 2
        a = dedispersion.dedisperse(inv[:m][None], 2.64, 1405.0, 40.0)[0]
        b = dedispersion.dedisperse(x[shift: shift + m][None], 2.64, 1405.0,
                                    40.0)[0]
        # interior samples (away from the circular-convolution wrap region)
        s = m // 8
        err = np.abs(a[s:-s] - b[s:-s])
        assert err.mean() < 1e-3


class TestPurityProductionAdversarial:
    """Purity harness at the PRODUCTION low config with ADVERSARIAL impulse
    placement: inversion block boundaries ± output_overlap ± 1 — exactly the
    points current_performance.m:60-74 sweeps because blockwise overlap-save
    leaks there first. (The committed products/performance.*.low.json files
    carry the full CLI sweeps; this is the CI gate.)"""

    @pytest.fixture(scope="class")
    def purity(self, tmp_path_factory):
        from ska_pst_dsp.utils.config import load_config

        out = str(tmp_path_factory.mktemp("purity_low"))
        cfg = load_config("low")
        cfg.load_fir_filter_coeff()
        p = TestPurity(
            n_test=2,
            os_factor=str(cfg.os_factor),
            input_fft_length=cfg.input_fft_length,
            input_overlap=cfg.input_overlap,
            fft_window=cfg.temporal_taper,
            deripple=cfg.deripple,
            channels=cfg.channels,
            fir_filter_taps=cfg.fir_filter_taps,
            blocks=3,
            backend={"test_vectors": "numpy", "channelize": "jax",
                     "synthesize": "jax"},
            output_dir=out,
            make_plots=False,
        )
        import ska_pst_dsp.data_gen as dg

        p.channelizer = dg.channelize(
            backend="jax", channels=cfg.channels,
            os_factor_str=str(cfg.os_factor),
            fir_filter_path=cfg.fir_filter_path,
        )
        p.pipeline = dg.pipeline(
            p.generator, p.channelizer, lambda a, **k: a, output_dir=out
        )
        # adversarial placement: output-block seam, seam +- overlap, +-1
        keep = p.block_size - 2 * p.output_sample_shift  # output_keep
        seam = p.total_sample_shift + keep
        p.time_domain_args["offset"] = [
            seam, seam - 1, seam + 1,
            seam - p.output_sample_shift, seam + p.output_sample_shift,
        ]
        return p

    def test_block_boundary_impulses(self, purity):
        rep = purity.temporal_purity()
        assert len(rep) == 5
        for r in rep:
            assert r["max_spurious_power"] < -60, r
            # a real measurement, not the -130 dB epsilon floor of an
            # untouched stream
            assert r["max_spurious_power"] > -120, r
