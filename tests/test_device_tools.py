"""CPU tests of what surrounds the device measurements: the peaks table and
roofline arithmetic of bench.py, the per-stage trace reduction, the
compile-cache placement, the refusal of bench.py and chip_smoke.py to run
without a GPU, the precision of every contraction on the purity path, and
the collective counter of the scaling report."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # bench.py lives at the checkout root

import bench  # noqa: E402
from ska_pst_dsp.utils import compile_cache, profiling  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# peaks table and roofline arithmetic
# ---------------------------------------------------------------------------

def test_peaks_known_h100():
    pk = bench.peaks(H100)
    assert pk["hbm_gbs"] == 3350.0
    assert pk["fp32_tflops"] == 67.0
    assert pk["tf32_tflops"] == 495.0
    assert pk["bf16_tflops"] == 989.0
    assert "H100" in pk["source"]


def test_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks("TFRT_CPU_0")
    with pytest.raises(ValueError):
        bench.roofline("low", 1000.0, "NVIDIA A100-SXM4-40GB")


def _fft(n):
    return 5.0 * n * math.log2(n)


@pytest.mark.parametrize("name, flops, nbytes", [
    # low: 3328-sample padded filter, hop 192, 256-pt channel FFT; per
    # 30720 output samples: 256 x 256-pt FFTs, 256 x 192 deripple/assemble
    # complex MACs, one 49152-pt FFT
    ("low",
     (4 * 3328 + _fft(256)) / 192
     + (256 * _fft(256) + 6 * 256 * 192 + _fft(49152)) / 30720,
     8 + 16 * 4 / 3 + 8),
    # mid: 102400-sample padded filter, hop 3584, 4096-pt channel FFT; per
    # 917504 output samples: 4096 x 512-pt FFTs, 4096 x 448 MACs, one
    # 1835008-pt FFT
    ("mid",
     (4 * 102400 + _fft(4096)) / 3584
     + (4096 * _fft(512) + 6 * 4096 * 448 + _fft(1835008)) / 917504,
     8 + 16 * 8 / 7 + 8),
])
def test_roofline_arithmetic(name, flops, nbytes):
    w = bench.per_sample_work(name)
    assert w["flops"] == pytest.approx(flops, rel=1e-12)
    assert w["bytes"] == pytest.approx(nbytes, rel=1e-12)
    r = bench.roofline(name, 1000.0, H100)
    assert r["sol_mem_msps"] == pytest.approx(3350e9 / nbytes / 1e6)
    assert r["sol_flop_msps"] == pytest.approx(67e12 / flops / 1e6)
    # FFT-optimal work is far below the float32 rate per byte: both cells
    # are memory-bound on this card
    assert r["bound"] == "memory"
    assert r["pct_sol"] == pytest.approx(100.0 * 1000.0 / r["sol_msps"])


def test_stage_floors_chain():
    """Each stage reads what the previous one wrote; a fused run of stages
    reads the first input and writes the last output once."""
    n = 2**20
    sizes = bench.stage_bytes("low", n)
    assert sizes[0] == 2 * n * 8
    assert len(sizes) == len(profiling.STAGES) + 1
    floors = bench.stage_floors_ms("low", n, H100)
    rate = 3350e9
    assert floors["fold"] == pytest.approx((sizes[0] + sizes[1]) / rate * 1e3)
    whole = "+".join(profiling.STAGES)
    assert floors[whole] == pytest.approx((sizes[0] + sizes[-1]) / rate * 1e3)


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------

def test_busy_ns_union():
    events = [("a", "", 0.0, 10.0), ("b", "", 5.0, 10.0),
              ("c", "", 30.0, 5.0), ("d", "", 31.0, 1.0)]
    assert profiling.busy_ns(events) == 20.0


def test_hlo_op_stages_fusion_across_scopes():
    hlo = """
%fused_computation (p0: f32[4]) -> c64[4] {
  %p0 = f32[4]{0} parameter(0)
  %sin.0 = f32[4]{0} sine(%p0), metadata={op_name="jit(f)/jit(_analysis_core)/fold/sin"}
  ROOT %c.0 = c64[4]{0} convert(%sin.0), metadata={op_name="jit(f)/jit(_analysis_core)/channel_fft/convert"}
}

ENTRY %main (x: f32[4]) -> c64[4] {
  %x = f32[4]{0} parameter(0)
  %fusion = c64[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation, metadata={op_name="jit(f)/add"}
  ROOT %fft.1 = c64[4]{0} fft(%fusion), fft_type=FFT, metadata={op_name="jit(f)/jit(_synthesis_core)/backward_fft/fft"}
}
"""
    st = profiling.hlo_op_stages(hlo)
    assert st["fusion"] == "fold+channel_fft"
    assert st["fft.1"] == "backward_fft"
    assert st["x"] == "other"
    events = [("fusion", "", 0.0, 3.0), ("fft.1", "", 3.0, 2.0),
              ("fft.1.0", "jit(f)/discard/x", 5.0, 1.0)]
    assert profiling.stage_device_ns(events, st) == {
        "fold+channel_fft": 3.0, "backward_fft": 2.0, "discard": 1.0,
    }


def test_trace_reduction_on_recorded_trace(tmp_path):
    """Record a small trace with named stages and reduce it: every traced
    operation lands in a stage key, and the busy time is within the window."""

    @jax.jit
    def f(x):
        with jax.named_scope("fold"):
            y = jnp.sin(x) * 2.0 + 1.0
        with jax.named_scope("channel_fft"):
            z = jnp.fft.fft(y.astype(jnp.complex64))
        return jnp.real(z).sum()

    x = jnp.ones((16, 1024))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            f(x).block_until_ready()
    paths = sorted(tmp_path.glob("**/*.xplane.pb"))
    assert paths
    events = profiling.device_op_events(str(paths[-1]))
    assert events
    stages = profiling.stage_device_ns(
        events, profiling.hlo_op_stages(f.lower(x).compile().as_text())
    )
    assert any("fold" in k for k in stages)
    assert any("channel_fft" in k for k in stages)
    assert sum(stages.values()) == pytest.approx(sum(e[3] for e in events))
    window = max(e[2] + e[3] for e in events) - min(e[2] for e in events)
    assert 0 < profiling.busy_ns(events) <= window


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX owns the cache: the helper
    reports that directory and sets nothing."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_checkout_default(monkeypatch):
    """Unset, the cache goes to the fixed, gitignored in-checkout dir."""
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---------------------------------------------------------------------------
# the device scripts refuse the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_refuses_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


# ---------------------------------------------------------------------------
# every contraction on the purity path runs at HIGHEST
# ---------------------------------------------------------------------------

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _dot_precisions(inner)
    return out


def _pair(n_pol, n):
    return jnp.zeros((n_pol, n), jnp.float32), jnp.zeros((n_pol, n), jnp.float32)


def _analysis_core():
    from ska_pst_dsp.ops import analysis

    f2d = jnp.ones((4, 32), jnp.float32)
    return jax.make_jaxpr(
        lambda a, b: analysis._analysis_core(a, b, f2d, block=32, step=24,
                                             k0=0)
    )(*_pair(2, 2400))


def _analysis_padded_core():
    from ska_pst_dsp.ops import analysis

    f2d = jnp.ones((4, 32), jnp.float32)
    return jax.make_jaxpr(
        lambda a, b: analysis._analysis_padded_core(
            a, b, f2d, block=32, step=28, k0=0, delay=2)
    )(*_pair(2, 2800))


def _lowcbf():
    from ska_pst_dsp.ops import lowcbf

    taps = jnp.ones((lowcbf.TAPS, lowcbf.BLOCK), jnp.float32)
    return jax.make_jaxpr(
        lambda a, b: lowcbf._lowcbf_core(a, b, taps, scale=1.0)
    )(*_pair(1, 3072 + 192 * 8))


def _corner_turn(padded):
    from ska_pst_dsp.parallel import corner_turn

    mesh = corner_turn.make_mesh_2d(2, 2)
    filt = np.hamming(8 * 32 + 1)
    fn = (corner_turn.sharded_polyphase_analysis_padded_2d if padded
          else corner_turn.sharded_polyphase_analysis_2d)
    n = 2 * 24 * 4 * 40
    return jax.make_jaxpr(
        lambda a, b: fn((a, b), filt, 32, "4/3", mesh)
    )(*_pair(2, n))


@pytest.mark.parametrize("build", [
    _analysis_core, _analysis_padded_core, _lowcbf,
    lambda: _corner_turn(False), lambda: _corner_turn(True),
], ids=["analysis", "analysis_padded", "lowcbf", "corner_turn_2d",
        "corner_turn_2d_padded"])
def test_contractions_run_at_highest(build):
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "no dot_general on this path"
    for p in precisions:
        assert p is not None and all(
            q == jax.lax.Precision.HIGHEST for q in p
        ), p


# ---------------------------------------------------------------------------
# scaling report: collectives as XLA:GPU emits them
# ---------------------------------------------------------------------------

def test_collective_counter_counts_async_pairs_once():
    from ska_pst_dsp.cli.scaling_bench import _hlo_collective_stats

    class Compiled:
        def __init__(self, text):
            self.text = text

        def lower(self, *args):
            return self

        def compile(self):
            return self

        def as_text(self):
            return self.text

    hlo = "\n".join([
        "  %a2a-start = ((f32[2,64,8]{2,1,0}), f32[2,64,8]{2,1,0}) "
        "all-to-all-start(f32[2,64,8]{2,1,0} %x)",
        "  %a2a-done = f32[2,64,8]{2,1,0} all-to-all-done(%a2a-start)",
        "  %cp = f32[4]{0} collective-permute(f32[4]{0} %y)",
        "  %cp-start = (f32[4]{0}, f32[4]{0}, u32[], u32[]) "
        "collective-permute-start(f32[4]{0} %y)",
        "  %cp-done = f32[4]{0} collective-permute-done(%cp-start)",
    ])
    assert _hlo_collective_stats(Compiled(hlo), ()) == {
        "all-to-all": {"count": 1, "payload_bytes": 2 * 64 * 8 * 4},
        "collective-permute": {"count": 2, "payload_bytes": 32},
    }
