"""Two-stage cascade differential tests.

TwoStageFilterBank / TwoStageInverseFilterBank (TwoStageFilterBank.m:81-118,
TwoStageInverseFilterBank.m:100-159) against straightforward one-shot
compositions of the plain kernels — the critical-chomp seam ("second write
wins", TwoStageFilterBank.m:102-105), the batched stage-2, the combine
reordering and the inverse cascade's critical detection are all exercised.

Geometry: the ``test32`` config (32 chan, OS 4/3, 129 taps, fft 32, ov 8) —
the cascade logic is geometry-generic; the production low geometry runs
through the same classes in tests/test_sgcht_matrix.py and the CLI sweep.
"""

import numpy as np
import pytest

from ska_pst_dsp.models.two_stage import (
    TwoStageFilterBank,
    TwoStageInverseFilterBank,
)
from ska_pst_dsp.models.streaming import FilterBank
from ska_pst_dsp.ops import polyphase_analysis
from ska_pst_dsp.utils.config import load_config
from ska_pst_dsp.utils.rational import Rational


@pytest.fixture(scope="module")
def cfg():
    c = load_config("test32")
    c.load_fir_filter_coeff()  # design + cache
    return c


def _tone(n, f=7 / 512, n_pol=2):
    t = np.arange(n)
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    return np.broadcast_to(x, (n_pol, n)).copy()


def _oneshot_cascade(x, cfg, *, critical=False, single=False):
    """Reference composition: stage-1 kernel, then the stage-2 kernel per
    coarse channel, then (optionally) the matlab chomp re-derived here
    independently of models/two_stage.py."""
    filt = cfg.load_fir_filter_coeff()
    os_f = Rational.coerce(cfg.os_factor)
    n1 = cfg.channels
    s1 = np.asarray(polyphase_analysis(x, filt, n1, os_f))
    # truncate like the streaming layer: multiple of nu spectra
    t1 = (s1.shape[2] // os_f.nu) * os_f.nu
    s1 = s1[:, :, :t1]
    nch1 = 1 if single else n1
    outs = []
    for c in range(nch1):
        s2 = np.asarray(
            polyphase_analysis(s1[:, c, :][:, None, :], filt, n1, os_f)
        )
        outs.append(s2)
    t2 = min(o.shape[2] for o in outs)
    t2 = (t2 // os_f.nu) * os_f.nu
    out = np.stack([o[:, :, :t2] for o in outs], axis=1)  # (P, nch1, n1, T)
    if critical:
        nch2 = os_f.normalize(n1)       # 24
        offset = n1 - nch2              # 8
        half = nch2 // 2                # 12
        # matlab 1-based overlapped assignment, second write wins at seam
        tmp = np.concatenate(
            [out[:, :, : half - 1, :], out[:, :, half - 1 + offset: n1 + offset, :]],
            axis=2,
        )
        out = tmp
    n_pol = out.shape[0]
    return out.reshape(n_pol, nch1 * out.shape[2], out.shape[3])


class TestTwoStageFilterBank:
    def test_matches_oneshot(self, cfg):
        x = _tone(120000)
        fb = TwoStageFilterBank(cfg)
        state = fb.init_state()
        state, got = fb.execute(state, x[:, None, :])
        ref = _oneshot_cascade(x[:, None, :], cfg)
        n = min(got.shape[2], ref.shape[2])
        assert n > 4
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-5 * scale, rtol=0
        )

    def test_critical_chomp_matches_oneshot(self, cfg):
        """The seam: keep tmp[j] below nch2/2-1 and tmp[j+offset] at and
        above it (TwoStageFilterBank.m:102-105)."""
        x = _tone(120000)
        fb = TwoStageFilterBank(cfg, critical=True)
        state, got = fb.execute(fb.init_state(), x[:, None, :])
        ref = _oneshot_cascade(x[:, None, :], cfg, critical=True)
        assert got.shape[1] == 32 * 24  # chomped channel count
        n = min(got.shape[2], ref.shape[2])
        assert n > 4
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-5 * scale, rtol=0
        )

    def test_single(self, cfg):
        x = _tone(120000)
        fb = TwoStageFilterBank(cfg, single=True)
        state, got = fb.execute(fb.init_state(), x[:, None, :])
        ref = _oneshot_cascade(x[:, None, :], cfg, single=True)
        assert got.shape[1] == 32
        n = min(got.shape[2], ref.shape[2])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(
            got[..., :n], ref[..., :n], atol=3e-5 * scale, rtol=0
        )

    def test_streamed_equals_oneshot(self, cfg):
        """Feeding the cascade in two chunks must reproduce the one-call
        output (buffered-carry invariant, FilterBank.m:119-126)."""
        x = _tone(160000)
        fb1 = TwoStageFilterBank(cfg)
        s = fb1.init_state()
        s, a = fb1.execute(s, x[:, None, :80000])
        s, b = fb1.execute(s, x[:, None, 80000:])
        streamed = np.concatenate([a, b], axis=2)

        fb2 = TwoStageFilterBank(cfg)
        # force the same stage chunking the streamed run adapted to
        fb2.stage1.chunk_spectra = fb1.stage1.chunk_spectra
        fb2.stage2.chunk_spectra = fb1.stage2.chunk_spectra
        s2, oneshot = fb2.execute(fb2.init_state(), x[:, None, :])
        n = min(streamed.shape[2], oneshot.shape[2])
        assert n > 0
        scale = np.abs(oneshot).max()
        np.testing.assert_allclose(
            streamed[..., :n], oneshot[..., :n], atol=1e-6 * scale, rtol=0
        )


class TestTwoStageInverse:
    def _stage1_reference(self, x, cfg):
        filt = cfg.load_fir_filter_coeff()
        fb = FilterBank(cfg)
        s, out = fb.execute(fb.init_state(), x[:, None, :])
        return out

    def test_roundtrip_reconstructs_stage1(self, cfg):
        """Two-stage analysis then the inverse cascade must reproduce the
        stage-1 (coarse channelized) stream after the stage-2 round-trip
        alignment shift."""
        from ska_pst_dsp.utils import geometry

        x = _tone(700000)
        fb = TwoStageFilterBank(cfg)
        state, chan2 = fb.execute(fb.init_state(), x[:, None, :])
        os_f = Rational.coerce(cfg.os_factor)

        inv = TwoStageInverseFilterBank(cfg, nch2=cfg.channels)
        istate = inv.init_state()
        istate, got = inv.execute(istate, chan2)
        assert got.shape[1] == cfg.channels  # back to coarse channels
        assert got.shape[2] > 0

        ref = self._stage1_reference(x, cfg)
        filt = cfg.load_fir_filter_coeff()
        shift = geometry.total_sample_shift(
            cfg.channels, os_f, filt.size, cfg.input_overlap
        )
        n = min(got.shape[2], ref.shape[2] - shift)
        err = np.abs(got[:, :, :n] - ref[:, :, shift: shift + n])
        scale = np.abs(ref).max()
        # fp32 PFB round trip: ~-60 dB class reconstruction
        assert err.max() / scale < 3e-3
        assert err.mean() / scale < 5e-4

    def test_critical_roundtrip_tone(self, cfg):
        """Critical inversion emits the coarse stream at de/nu rate with a
        half-fine-channel modulation (polyphase_synthesis.m:253-255 keeps
        each channel's band at its lower edge — no DC split): a tone at
        stage-1 baseband f1 must come out at f1*nu/de + 1/(2*nch2_critical)
        (mapping verified against the kernel in both directions)."""
        from fractions import Fraction

        f = Fraction(9, 1024)
        x = _tone(700000, f=float(f))
        fb = TwoStageFilterBank(cfg, critical=True)
        state, chan2 = fb.execute(fb.init_state(), x[:, None, :])
        os_f = Rational.coerce(cfg.os_factor)
        nch2c = os_f.normalize(cfg.channels)  # 24

        inv = TwoStageInverseFilterBank(cfg, nch2=nch2c)
        istate = inv.init_state()
        istate, got = inv.execute(istate, chan2)
        assert got.shape[1] == cfg.channels

        c1 = round(f * cfg.channels) % cfg.channels
        f1 = (f * cfg.channels - round(f * cfg.channels)) * Fraction(
            os_f.de, os_f.nu
        )
        f_out = (f1 * Fraction(os_f.nu, os_f.de) + Fraction(1, 2 * nch2c)) % 1
        v = got[0, c1]
        q = f_out.denominator
        nfft = (v.size // q) * q
        S = np.abs(np.fft.fft(v[:nfft]))
        pk = int(S.argmax())
        assert pk == round(float(f_out) * nfft)
        sp = S.copy()
        sp[pk] = 0.0
        db = 20 * np.log10(sp.max() / S[pk])
        # purity bounded by the chomp's hard band edges, not -60 dB
        assert db < -35.0

    def test_combine(self, cfg):
        """combine=4: four critically-chomped coarse channels inverted per
        call (TwoStageInverseFilterBank.m:117-131)."""
        x = _tone(700000)
        fb = TwoStageFilterBank(cfg, critical=True)
        state, chan2 = fb.execute(fb.init_state(), x[:, None, :])
        os_f = Rational.coerce(cfg.os_factor)
        nch2 = os_f.normalize(cfg.channels)

        inv = TwoStageInverseFilterBank(cfg, nch2=nch2, combine=4)
        istate = inv.init_state()
        istate, got = inv.execute(istate, chan2)
        assert got.shape[1] == cfg.channels // 4
        assert got.shape[2] > 0
        # energy must be preserved through the combined inversion (tone in)
        assert np.abs(got).max() > 0.1

    def test_rejects_combining_oversampled(self, cfg):
        inv = TwoStageInverseFilterBank(cfg, nch2=cfg.channels, combine=4)
        with pytest.raises(ValueError):
            inv.init_state()

    def test_rejects_bad_nch2(self, cfg):
        inv = TwoStageInverseFilterBank(cfg, nch2=17)
        with pytest.raises(ValueError):
            inv.init_state()
