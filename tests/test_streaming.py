"""Streaming-vs-one-shot equivalence — the invariant the reference tests via
its in-stream testers, and the invariant our sharded pipeline must also keep
(SURVEY §4: 'streamed FilterBank output must equal one-shot kernel output
despite buffering')."""

import dataclasses

import numpy as np
import pytest

from ska_pst_dsp.models import (
    FilterBank, InverseFilterBank, StatefulPipeline,
    PureTone, Impulse, SquareWave, FrequencyComb, FrequencyWedge, Stream,
    TestPureTone, TestImpulse, PhaseAverage,
)
from ska_pst_dsp.ops import (
    polyphase_analysis, polyphase_analysis_padded, polyphase_analysis_lowcbf,
    polyphase_synthesis,
)
from ska_pst_dsp.utils.rational import Rational
from ska_pst_dsp.utils import geometry


@dataclasses.dataclass
class SmallConfig:
    """Minimal config-shaped object for kernel-level streaming tests."""
    analysis_function: str
    channels: int
    os_factor: Rational
    input_fft_length: int
    input_overlap: int
    fir_filter_taps: int
    deripple: bool = True
    temporal_taper: str = "tukey"
    kept_channels: int = 0
    _filt: np.ndarray = None

    def load_fir_filter_coeff(self):
        return self._filt


def _filt(taps, block):
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / block) * np.hamming(taps)
    return (h / h.sum()).astype(np.float64)


def _noise(n_dat, seed=0, n_pol=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pol, 1, n_dat)) + 1j * rng.standard_normal(
        (n_pol, 1, n_dat)
    )
    return x.astype(np.complex64)


def _cfg(analysis="polyphase_analysis", block=32, os=Rational(4, 3), taps_pc=8):
    taps = block * taps_pc + 1
    return SmallConfig(
        analysis_function=analysis,
        channels=block,
        os_factor=os,
        input_fft_length=64,
        input_overlap=8,
        fir_filter_taps=taps,
        _filt=_filt(taps, block),
    )


def _stream_all(fb, x, chunks):
    state = fb.init_state()
    outs = []
    pos = 0
    for c in chunks:
        state, out = fb.execute(state, x[:, :, pos: pos + c])
        pos += c
        if out.shape[-1]:
            outs.append(np.asarray(out))
    return np.concatenate(outs, axis=2) if outs else np.zeros((x.shape[0], 0, 0))


class TestFilterBankStreaming:
    @pytest.mark.parametrize("chunks", [[4000, 4000], [1000, 3000, 2500, 1500],
                                        [333, 5555, 2112]])
    def test_plain_streaming_equals_oneshot(self, chunks):
        cfg = _cfg()
        x = _noise(sum(chunks), seed=1)
        one = np.asarray(
            polyphase_analysis(x, cfg._filt, cfg.channels, cfg.os_factor)
        )
        streamed = _stream_all(FilterBank(cfg), x, chunks)
        n = streamed.shape[2]
        assert n > 0
        scale = np.abs(one).max()
        np.testing.assert_allclose(
            streamed, one[:, :, :n], atol=3e-6 * scale, rtol=0
        )

    @pytest.mark.parametrize("chunks", [[3000, 3000, 2000], [500, 4500, 3000]])
    def test_padded_streaming_equals_oneshot(self, chunks):
        cfg = _cfg("polyphase_analysis_padded", os=Rational(8, 7), block=56)
        x = _noise(sum(chunks), seed=2)
        one = np.asarray(
            polyphase_analysis_padded(x, cfg._filt, cfg.channels, cfg.os_factor)
        )
        streamed = _stream_all(FilterBank(cfg), x, chunks)
        n = streamed.shape[2]
        assert n > 0
        scale = np.abs(one).max()
        np.testing.assert_allclose(
            streamed, one[:, :, :n], atol=3e-6 * scale, rtol=0
        )

    def test_lowcbf_streaming_equals_oneshot(self):
        rng = np.random.default_rng(3)
        taps = rng.standard_normal(3072)
        cfg = SmallConfig(
            analysis_function="polyphase_analysis_lowcbf",
            channels=256,
            os_factor=Rational(4, 3),
            input_fft_length=256,
            input_overlap=48,
            fir_filter_taps=3072,
            kept_channels=216,
            _filt=taps,
        )
        n_dat = 60000
        x = _noise(n_dat, seed=4)
        one = np.asarray(
            polyphase_analysis_lowcbf(x, taps, first_call=True)
        )
        streamed = _stream_all(FilterBank(cfg), x, [20000, 20000, 20000])
        n = streamed.shape[2]
        assert n > 0
        scale = np.abs(one).max()
        np.testing.assert_allclose(
            streamed, one[:, :, :n], atol=3e-6 * scale, rtol=0
        )


class TestInverseStreaming:
    @pytest.mark.parametrize("chunks", [[600, 600], [123, 456, 621]])
    def test_streaming_equals_oneshot(self, chunks):
        cfg = _cfg()
        n_dat = sum(chunks)
        rng = np.random.default_rng(5)
        x = (
            rng.standard_normal((1, cfg.channels, n_dat))
            + 1j * rng.standard_normal((1, cfg.channels, n_dat))
        ).astype(np.complex64)
        one = np.asarray(
            polyphase_synthesis(
                x, cfg.input_fft_length, cfg.os_factor,
                input_overlap=cfg.input_overlap,
                deripple_coeff=cfg._filt, temporal_taper="tukey",
            )
        )
        inv = InverseFilterBank(cfg)
        state = inv.init_state()
        outs = []
        pos = 0
        for c in chunks:
            state, out = inv.execute(state, x[:, :, pos: pos + c])
            pos += c
            if out.shape[-1]:
                outs.append(np.asarray(out))
        streamed = np.concatenate(outs, axis=2)
        n = streamed.shape[2]
        assert n > 0
        scale = np.abs(one).max()
        np.testing.assert_allclose(streamed, one[:, :, :n], atol=3e-6 * scale, rtol=0)


class TestSignals:
    def test_blocking_invariance(self):
        """Generators must produce identical samples under any block split."""
        gens = [
            PureTone(frequency=0.0371),
            Impulse(offset=500, noise=1e-6, seed=1),
            SquareWave(period=26, seed=2),
            FrequencyComb.standard(8),
            FrequencyWedge(resolution=4096, seed=3),
        ]
        for g in gens:
            whole = np.asarray(g.generate(0, 3000))
            parts = np.concatenate(
                [np.asarray(g.generate(0, 1000)),
                 np.asarray(g.generate(1000, 700)),
                 np.asarray(g.generate(1700, 1300))],
                axis=2,
            )
            np.testing.assert_array_equal(whole, parts), type(g).__name__

    def test_stream_adapter(self):
        g = PureTone(frequency=0.01)
        s = Stream(g)
        a = np.asarray(s.generate(100))
        b = np.asarray(s.generate(100))
        whole = np.asarray(g.generate(0, 200))
        np.testing.assert_array_equal(np.concatenate([a, b], axis=2), whole)

    def test_square_wave_statistics(self):
        g = SquareWave(period=100, duty_cycle=0.5, on_amp=4.0, seed=7)
        x = np.asarray(g.generate(0, 100000))[0, 0]
        t = np.arange(100000)
        on = (t % 100) < 50
        on_power = np.mean(np.abs(x[on]) ** 2)
        assert on_power == pytest.approx(4.0, rel=0.05)
        assert np.all(x[~on] == 0)

    def test_tone_phase_continuity_far_out(self):
        g = PureTone(frequency=1 / 26.5)
        far = 10**9
        x = np.asarray(g.generate(far, 64))[0, 0]
        t = np.arange(far, far + 64, dtype=np.float64)
        expected = np.exp(2j * np.pi * ((t / 26.5) % 1.0))
        np.testing.assert_allclose(x, expected, atol=1e-5)


class TestTesters:
    def test_pure_tone_pass_and_fail(self):
        f = 0.125
        t = np.arange(4096)
        clean = np.exp(2j * np.pi * f * t)[None, None, :]
        tester = TestPureTone(frequency=f)
        state, result = tester.test(tester.init_state(), clean)
        assert result == 0
        dirty = clean + 0.01 * np.exp(2j * np.pi * 0.3 * t)[None, None, :]
        state, result = tester.test(tester.init_state(), dirty)
        assert result == -1

    def test_impulse_pass_and_fail(self):
        x = np.full((1, 1, 4096), 1e-8, dtype=np.complex64)
        x[0, 0, 1000] = 1.0
        tester = TestImpulse(offset=1000)
        _, result = tester.test(tester.init_state(), x)
        assert result == 0
        x[0, 0, 2000] = 0.1  # -20 dB leakage
        _, result = tester.test(tester.init_state(), x)
        assert result == -1

    def test_impulse_across_blocks(self):
        tester = TestImpulse(offset=1500)
        state = tester.init_state()
        x1 = np.full((1, 1, 1000), 1e-8, dtype=np.complex64)
        state, r1 = tester.test(state, x1)
        x2 = np.full((1, 1, 1000), 1e-8, dtype=np.complex64)
        x2[0, 0, 500] = 1.0
        state, r2 = tester.test(state, x2)
        assert (r1, r2) == (0, 0)

    def test_phase_average(self):
        freq = 1 / 64
        pa = PhaseAverage(frequency=freq, nbin=64)
        state = pa.init_state()
        t = np.arange(6400)
        x = np.cos(2 * np.pi * freq * t).astype(np.complex64)[None, None, :]
        state = pa.average(state, x[:, :, :3000])
        state = pa.average(state, x[:, :, 3000:])
        prof = state.result[0, 0] / np.maximum(state.hits, 1)
        # folded profile of a cosine at the fold frequency stays cosine-like
        assert np.abs(prof).max() > 0.9
        assert state.current == 6400


class TestEndToEndStreamingPipeline:
    def test_tone_through_streaming_chain(self):
        cfg = _cfg(block=64, taps_pc=12)
        cfg.input_fft_length, cfg.input_overlap = 128, 24
        gen = PureTone(frequency=10.125 / 64)
        fb = FilterBank(cfg)
        inv = InverseFilterBank(cfg)
        pipe = StatefulPipeline(fb, inv)
        outs = []
        for i in range(6):
            x = gen.generate(i * 16384, 16384)
            y = pipe.execute(x)
            if y.shape[-1]:
                outs.append(np.asarray(y))
        inv_stream = np.concatenate(outs, axis=2)[0, 0]
        # compare against the same signal put through one-shot kernels
        x_all = np.asarray(gen.generate(0, 6 * 16384))
        chan = polyphase_analysis(x_all, cfg._filt, cfg.channels, cfg.os_factor)
        one = np.asarray(
            polyphase_synthesis(
                chan, cfg.input_fft_length, cfg.os_factor,
                input_overlap=cfg.input_overlap, deripple_coeff=cfg._filt,
                temporal_taper="tukey",
            )
        )[0, 0]
        n = inv_stream.size
        assert n > 0
        np.testing.assert_allclose(
            inv_stream, one[:n], atol=5e-6 * np.abs(one).max(), rtol=0
        )
