"""Sharded-vs-single-device equivalence on an 8-virtual-device CPU mesh —
the multi-chip correctness gate (SURVEY §4: sharded output must be
bit-equivalent to one-shot output)."""

import jax
import numpy as np
import pytest

from ska_pst_dsp.ops import (
    polyphase_analysis,
    polyphase_analysis_padded,
    polyphase_synthesis,
)
from ska_pst_dsp.parallel.sharded import (
    make_mesh,
    sharded_polyphase_analysis,
    sharded_polyphase_analysis_padded,
    sharded_polyphase_synthesis,
    sharded_round_trip,
)
from ska_pst_dsp.utils import geometry
from ska_pst_dsp.utils.rational import Rational


def _filt(taps, block):
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / block) * np.hamming(taps)
    return (h / h.sum()).astype(np.float64)


def _noise(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ).astype(np.complex64)


N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV
    return make_mesh(N_DEV)


class TestShardedAnalysis:
    def test_matches_oneshot(self, mesh):
        os_f = Rational(4, 3)
        block, taps = 32, 257
        step = 24
        filt = _filt(taps, block)
        n_dat = N_DEV * step * os_f.nu * 40  # nu-aligned shards
        x = _noise((2, n_dat), seed=1)
        one = np.asarray(polyphase_analysis(x, filt, block, os_f))
        from ska_pst_dsp.ops import cfft
        shd = cfft.combine(*sharded_polyphase_analysis(x, filt, block, os_f, mesh))
        n = one.shape[2]
        scale = np.abs(one).max()
        np.testing.assert_allclose(shd[:, :, :n], one, atol=1e-6 * scale, rtol=0)

    def test_padded_matches_oneshot(self, mesh):
        os_f = Rational(8, 7)
        block, taps = 56, 449
        step = 49
        filt = _filt(taps, block)
        n_dat = N_DEV * step * os_f.nu * 10
        x = _noise((1, n_dat), seed=2)
        one = np.asarray(polyphase_analysis_padded(x, filt, block, os_f))
        from ska_pst_dsp.ops import cfft
        shd = cfft.combine(*sharded_polyphase_analysis_padded(x, filt, block, os_f, mesh))
        scale = np.abs(one).max()
        np.testing.assert_allclose(shd, one, atol=1e-6 * scale, rtol=0)


class TestShardedSynthesis:
    def test_matches_oneshot(self, mesh):
        os_f = Rational(4, 3)
        n_chan, L, ov = 16, 64, 8
        keep = L - 2 * ov
        filt = _filt(8 * n_chan + 1, n_chan)
        n_dat = N_DEV * keep * 6
        x = _noise((2, n_chan, n_dat), seed=3)
        one = np.asarray(
            polyphase_synthesis(
                x, L, os_f, input_overlap=ov, deripple_coeff=filt,
                temporal_taper="tukey",
            )
        )
        from ska_pst_dsp.ops import cfft
        shd = cfft.combine(*sharded_polyphase_synthesis(
            x, L, os_f, mesh, input_overlap=ov, deripple_coeff=filt,
            temporal_taper="tukey",
        ))
        assert shd.shape == one.shape
        scale = np.abs(one).max()
        np.testing.assert_allclose(shd, one, atol=1e-6 * scale, rtol=0)


class TestShardedRoundTrip:
    def test_tone_reconstruction(self, mesh):
        os_f = Rational(4, 3)
        n_chan, L, ov = 32, 64, 12
        taps = n_chan * 8 + 1
        filt = _filt(taps, n_chan)
        step = 24
        n_dat = N_DEV * step * os_f.nu * 64
        t = np.arange(n_dat)
        x = np.exp(2j * np.pi * (5.0 / n_chan) * t).astype(np.complex64)[None, :]

        from ska_pst_dsp.ops import cfft
        out = cfft.combine(*sharded_round_trip(x, filt, n_chan, os_f, L, ov, mesh))[0, 0]
        # the hard invariant: sharded pipeline == one-shot pipeline
        from ska_pst_dsp.ops import polyphase_analysis, polyphase_synthesis

        chan = polyphase_analysis(x, filt, n_chan, os_f)
        one = np.asarray(
            polyphase_synthesis(
                chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
                temporal_taper="tukey",
            )
        )[0, 0]
        m = min(out.size, one.size)
        assert m > 0
        np.testing.assert_allclose(
            out[:m], one[:m], atol=2e-6 * np.abs(one).max(), rtol=0
        )
        # and the physics: reconstruction tracks the input (8 taps/chan
        # prototype → ~1e-3 ripple floor)
        shift = geometry.total_sample_shift(n_chan, os_f, taps, ov)
        n = min(out.size, n_dat - shift)
        err = np.abs(out[:n] - x[0, shift: shift + n])
        assert err.mean() < 2e-3


class TestCornerTurn2D:
    """Channel x time mesh with all-to-all corner turn vs one-shot."""

    def test_2d_synthesis_matches_oneshot(self):
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_polyphase_synthesis_2d,
        )
        from ska_pst_dsp.ops import cfft

        os_f = Rational(4, 3)
        n_chan, L, ov = 16, 64, 8
        keep = L - 2 * ov
        filt = _filt(8 * n_chan + 1, n_chan)
        dc, dt = 2, 4
        n_dat = dt * keep * 8  # 8 blocks per time shard, divisible by dc
        x = _noise((2, n_chan, n_dat), seed=7)
        one = np.asarray(
            polyphase_synthesis(
                x, L, os_f, input_overlap=ov, deripple_coeff=filt,
                temporal_taper="tukey",
            )
        )
        mesh = make_mesh_2d(dc, dt)
        shd = cfft.combine(*sharded_polyphase_synthesis_2d(
            x, L, os_f, mesh, input_overlap=ov, deripple_coeff=filt,
            temporal_taper="tukey",
        ))
        assert shd.shape == one.shape
        scale = np.abs(one).max()
        np.testing.assert_allclose(shd, one, atol=2e-6 * scale, rtol=0)

    def test_2d_4x2_mesh(self):
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_polyphase_synthesis_2d,
        )
        from ska_pst_dsp.ops import cfft

        os_f = Rational(8, 7)
        n_chan, L, ov = 8, 112, 8
        keep = L - 2 * ov
        filt = _filt(8 * n_chan + 1, n_chan)
        dc, dt = 4, 2
        n_dat = dt * keep * 12
        x = _noise((1, n_chan, n_dat), seed=8)
        one = np.asarray(
            polyphase_synthesis(x, L, os_f, input_overlap=ov,
                                temporal_taper="hann")
        )
        mesh = make_mesh_2d(dc, dt)
        shd = cfft.combine(*sharded_polyphase_synthesis_2d(
            x, L, os_f, mesh, input_overlap=ov, temporal_taper="hann",
        ))
        scale = np.abs(one).max()
        np.testing.assert_allclose(shd, one, atol=2e-6 * scale, rtol=0)


class TestProductionLowSharded:
    """Sharded pipelines at the PRODUCTION low geometry (256 chan, 3073
    taps, L=256/ov=48) — halo/alignment bugs that only appear at
    step=192/fl=3328 scale cannot hide behind toy shapes here."""

    @pytest.fixture(scope="class")
    def low(self):
        from ska_pst_dsp.design import fir

        os_f = Rational(4, 3)
        filt = fir.design_pfb_fir_filter(256, os_f, 12)
        return os_f, filt, 256, 256, 48

    @pytest.fixture(scope="class")
    def noise(self, low):
        os_f, filt, n_chan, L, ov = low
        n_dat = 2 * 192 * 4 * 2400  # divisible by 8*step*nu
        rng = np.random.default_rng(0)
        return (
            rng.standard_normal((2, n_dat)) + 1j * rng.standard_normal((2, n_dat))
        ).astype(np.complex64)

    def test_1d_roundtrip_matches_oneshot(self, low, noise):
        from ska_pst_dsp.parallel.sharded import (
            make_mesh, sharded_round_trip,
        )

        os_f, filt, n_chan, L, ov = low
        mesh = make_mesh(8)
        rr, ri = sharded_round_trip(noise, filt, n_chan, os_f, L, ov, mesh)
        got = np.asarray(rr) + 1j * np.asarray(ri)

        chan = polyphase_analysis(noise[:, None, :], filt, n_chan, os_f)
        ref = np.asarray(
            polyphase_synthesis(
                chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
                temporal_taper="tukey",
            )
        )
        n = min(got.shape[2], ref.shape[2])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-6 * scale, rtol=0
        )

    def test_2d_analysis_matches_oneshot(self, low, noise):
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_polyphase_analysis_2d,
        )

        os_f, filt, n_chan, L, ov = low
        mesh = make_mesh_2d(4, 2)
        cr, ci = sharded_polyphase_analysis_2d(noise, filt, n_chan, os_f, mesh)
        got = np.asarray(cr) + 1j * np.asarray(ci)
        ref = np.asarray(polyphase_analysis(noise[:, None, :], filt, n_chan, os_f))
        nb = ref.shape[2]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :nb], ref, atol=3e-6 * scale, rtol=0
        )

    def test_2d_roundtrip_matches_oneshot(self, low, noise):
        """Channel-sharded analysis -> all-to-all corner turn -> block-
        sharded big IFFT, against the one-shot chain."""
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_round_trip_2d,
        )

        os_f, filt, n_chan, L, ov = low
        mesh = make_mesh_2d(4, 2)
        rr, ri = sharded_round_trip_2d(noise, filt, n_chan, os_f, L, ov, mesh)
        got = np.asarray(rr) + 1j * np.asarray(ri)

        chan = polyphase_analysis(noise[:, None, :], filt, n_chan, os_f)
        ref = np.asarray(
            polyphase_synthesis(
                chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
                temporal_taper="tukey",
            )
        )
        n = min(got.shape[2], ref.shape[2])
        assert n > 2_000_000  # this is not a toy stream
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-6 * scale, rtol=0
        )


class TestMidGeometry2D:
    """SKA-Mid channel count (4096, OS 8/7, L=512/ov=128, 1.8M-point
    backward FFT) through the 2-D chan x time corner-turn pipeline with the
    ZERO-PADDED analysis — the mid chain's distributed structure at its
    production geometry (taps reduced to 2/chan to keep the CPU-mesh fold
    tractable; the index math being verified — channel-column sharding of
    the padded DFT, reverse+IFFT identity, halo/delay alignment, 4096-way
    corner turn, 1.8M-point block IFFT — is tap-count independent)."""

    OS = Rational(8, 7)
    N_CHAN, L, OV = 4096, 512, 128
    TAPS = 2 * 4096 + 1

    @pytest.fixture(scope="class")
    def mid(self):
        return _filt(self.TAPS, self.N_CHAN)

    @pytest.fixture(scope="class")
    def noise(self):
        step = geometry.analysis_step(self.N_CHAN, self.OS)  # 3584
        # t_valid = 2048 fine samples: dt*keep*dc = 2*256*4 whole blocks
        n_dat = 2048 * step
        return _noise((1, n_dat), seed=7)

    def test_padded_2d_analysis_matches_oneshot(self, mid, noise):
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_polyphase_analysis_padded_2d,
        )

        mesh = make_mesh_2d(4, 2)
        cr, ci = sharded_polyphase_analysis_padded_2d(
            noise, mid, self.N_CHAN, self.OS, mesh
        )
        got = np.asarray(cr) + 1j * np.asarray(ci)
        ref = np.asarray(
            polyphase_analysis_padded(
                noise[:, None, :], mid, self.N_CHAN, self.OS
            )
        )
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=3e-6 * scale, rtol=0)

    def test_padded_2d_roundtrip_matches_oneshot(self, mid, noise):
        from ska_pst_dsp.parallel.corner_turn import (
            make_mesh_2d, sharded_round_trip_2d_padded,
        )

        mesh = make_mesh_2d(4, 2)
        rr, ri = sharded_round_trip_2d_padded(
            noise, mid, self.N_CHAN, self.OS, self.L, self.OV, mesh
        )
        got = np.asarray(rr) + 1j * np.asarray(ri)

        chan = polyphase_analysis_padded(
            noise[:, None, :], mid, self.N_CHAN, self.OS
        )
        ref = np.asarray(
            polyphase_synthesis(
                chan, self.L, self.OS, input_overlap=self.OV,
                deripple_coeff=mid, temporal_taper="tukey",
            )
        )
        n = min(got.shape[2], ref.shape[2])
        assert n >= 4 * (self.N_CHAN * 448 - 2 * 128 * 7 // 8 * 4096)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-6 * scale, rtol=0
        )

    def test_padded_1d_roundtrip_matches_oneshot(self, mid, noise):
        from ska_pst_dsp.parallel.sharded import sharded_round_trip_padded

        mesh = make_mesh(8)
        rr, ri = sharded_round_trip_padded(
            noise, mid, self.N_CHAN, self.OS, self.L, self.OV, mesh
        )
        got = np.asarray(rr) + 1j * np.asarray(ri)
        chan = polyphase_analysis_padded(
            noise[:, None, :], mid, self.N_CHAN, self.OS
        )
        ref = np.asarray(
            polyphase_synthesis(
                chan, self.L, self.OS, input_overlap=self.OV,
                deripple_coeff=mid, temporal_taper="tukey",
            )
        )
        n = min(got.shape[2], ref.shape[2])
        assert n > 0
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-6 * scale, rtol=0
        )
