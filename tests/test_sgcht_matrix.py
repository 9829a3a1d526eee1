"""The test_sgcht.m 8-case pass/fail matrix, in CI.

Runs the sgcht driver chain matrix (channelize / invert / two-stage /
critical / combine; test_sgcht.m:1-57) through the in-stream testers.
Single-stage cases run at the production low config; the cascade cases run
at the ``test32`` geometry so the whole matrix stays CI-fast (the low-config
cascade needs ~18M samples per case — that full sweep is the
``python -m ska_pst_dsp.cli.test_sgcht -c low`` CLI, whose committed
product is products/report.test_sgcht.low.json).

sgcht returns 0 = pass, -1 = tester failed, -2 = tester starved (saw no
samples — a vacuous run we refuse to count as a pass).
"""

import pytest

from ska_pst_dsp.cli import sgcht
from ska_pst_dsp.utils.config import load_config


@pytest.fixture(scope="module", autouse=True)
def _warm_configs():
    load_config("low").load_fir_filter_coeff()
    load_config("test32").load_fir_filter_coeff()


def _run(extra, *, cfg, blocks, blocksz, signal, **kw):
    args = ["--signal", signal, "--cfg", cfg, "--test",
            "--blocks", str(blocks), "--blocksz", str(blocksz)]
    for k, v in kw.items():
        args += [f"--{k}", str(v)]
    return sgcht.run(args + extra)


class TestSingleStageLow:
    """Matrix cases 1-2 at the production low config (256 ch, OS 4/3)."""

    @pytest.mark.parametrize("signal", ["complex_sinusoid", "temporal_impulse"])
    def test_channelize(self, signal):
        assert _run([], cfg="low", blocks=3, blocksz=131072,
                    signal=signal) == 0

    @pytest.mark.parametrize("signal", ["complex_sinusoid", "temporal_impulse"])
    def test_channelize_invert(self, signal):
        assert _run(["--invert"], cfg="low", blocks=3, blocksz=131072,
                    signal=signal) == 0


CASES = [
    ([], "plain"),
    (["--invert"], "invert"),
    (["--two_stage"], "two_stage"),
    (["--two_stage", "--invert"], "two_stage_invert"),
    (["--two_stage", "--critical"], "two_stage_critical"),
    (["--two_stage", "--critical", "--invert"], "two_stage_critical_invert"),
    (["--two_stage", "--critical", "--invert", "--combine", "4"],
     "two_stage_critical_invert_combine4"),
]


class TestMatrixTest32:
    """The full matrix at the reduced test32 geometry (fast; exercises the
    cascade seams, inverse critical detection and combine reordering)."""

    # 9/1024: stage-1 channel 0, stage-2 channel 7 — clear of every channel
    # boundary at 32 channels (the header default 7/512 lands exactly on a
    # stage-2 seam)
    FREQ = 9 / 1024

    @pytest.mark.parametrize("extra,name", CASES, ids=[c[1] for c in CASES])
    def test_tone(self, extra, name):
        rc = _run(extra, cfg="test32", blocks=3, blocksz=65536,
                  signal="complex_sinusoid", frequency=self.FREQ)
        assert rc == 0, f"{name}: rc={rc}"

    @pytest.mark.parametrize(
        "extra,name",
        [c for c in CASES if "critical" not in c[1] or "invert" not in c[1]],
        ids=[c[1] for c in CASES
             if "critical" not in c[1] or "invert" not in c[1]],
    )
    def test_impulse(self, extra, name):
        rc = _run(extra, cfg="test32", blocks=3, blocksz=65536,
                  signal="temporal_impulse", offset=100000)
        assert rc == 0, f"{name}: rc={rc}"

    def test_impulse_critical_invert_undefined(self):
        """A chomped (band-limited) impulse can't meet the +-1-sample
        criterion — sgcht must refuse rather than fake a pass."""
        with pytest.raises(ValueError):
            _run(["--two_stage", "--critical", "--invert"], cfg="test32",
                 blocks=1, blocksz=65536, signal="temporal_impulse")

    def test_starved_tester_fails(self):
        """A test run whose tester saw no data must NOT report success."""
        rc = _run(["--two_stage", "--invert"], cfg="test32", blocks=1,
                  blocksz=8192, signal="complex_sinusoid",
                  frequency=self.FREQ)
        assert rc == -2

    def test_all_transient_stream_is_starved(self):
        """A stream entirely inside the startup-transient skip must NOT
        report success — nothing was actually judged."""
        rc = _run([], cfg="low", blocks=1, blocksz=2048,
                  signal="complex_sinusoid", frequency=self.FREQ)
        assert rc == -2
