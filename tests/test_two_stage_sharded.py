"""Sharded two-stage cascade vs the one-shot models.

Two chains, both on the 8-virtual-device CPU mesh:
  * low + low — the reference sweep's canonical two-stage inversion chain
    (all_sgcht.m sweeps two_stage over the SAME config; test_sgcht.m:47
    adds critical+invert+combine=16): ACTIVE critical chomp (256 -> 192)
    and the combine=16 combined inversion (TwoStageFilterBank.m:92-110,
    polyphase_synthesis.m:198-238);
  * sps + lowpsi — the production SPS→LowCBF cascade: the sharded LowCBF
    firmware-model stage 2 (quarter-turn derotation under sharding) with
    the chomp a no-op (the firmware already emits the 216-channel
    critical subset).
"""

import numpy as np
import pytest

from ska_pst_dsp.models.two_stage import (
    TwoStageFilterBank,
    TwoStageInverseFilterBank,
)
from ska_pst_dsp.utils.config import load_config


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    ).astype(np.complex64)


def _sharded(cfg1, cfg2, x, combine, invert):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ska_pst_dsp.parallel.sharded import make_mesh
    from ska_pst_dsp.parallel.two_stage_sharded import (
        sharded_two_stage_round_trip,
    )

    mesh = make_mesh(len(jax.devices()))
    spec = NamedSharding(mesh, P(None, "time"))
    xr = jax.device_put(np.ascontiguousarray(x.real).astype(np.float32), spec)
    xi = jax.device_put(np.ascontiguousarray(x.imag).astype(np.float32), spec)
    rr, ri = jax.jit(
        lambda a, b: sharded_two_stage_round_trip(
            (a, b), cfg1, cfg2, mesh, critical=True, combine=combine,
            invert=invert,
        )
    )(xr, xi)
    return np.asarray(rr) + 1j * np.asarray(ri)


@pytest.mark.parametrize("combine", [1, 16])
def test_low_low_roundtrip_matches_models(combine):
    import jax

    cfg1 = cfg2 = load_config("low")
    # deep cascade: stage-2 needs T1 > fl + 256*step for one inversion block
    quantum = len(jax.devices()) * 192 * 4
    n = (10_200_000 // quantum + 1) * quantum
    x = _noise(n, 11)

    fb = TwoStageFilterBank(cfg1, cfg2, critical=True)
    _, chan = fb.execute(fb.init_state(), x[:, None, :])
    nch2 = cfg1.os_factor.normalize(cfg1.channels)          # 192
    inv = TwoStageInverseFilterBank(cfg1, cfg2, combine=combine, nch2=nch2)
    _, ref = inv.execute(inv.init_state(), chan)
    assert ref.shape[2] > 0, "reference produced no output — grow the stream"

    got = _sharded(cfg1, cfg2, x, combine, invert=True)
    assert got.shape[1] == ref.shape[1]
    n_c = min(got.shape[2], ref.shape[2])
    scale = np.abs(ref[..., :n_c]).max()
    err = np.abs(got[..., :n_c] - ref[..., :n_c]).max()
    assert err / scale < 1e-4, f"combine={combine}: rel err {err / scale}"


def test_sps_lowpsi_cascade_matches_models():
    import jax

    cfg1 = load_config("sps")
    cfg2 = load_config("lowpsi")
    quantum = len(jax.devices()) * 216 * 32
    n = (1_500_000 // quantum + 1) * quantum
    x = _noise(n, 12)

    fb = TwoStageFilterBank(cfg1, cfg2, critical=True)
    _, ref = fb.execute(fb.init_state(), x[:, None, :])
    assert ref.shape[2] > 0

    got = _sharded(cfg1, cfg2, x, combine=1, invert=False)
    assert got.shape[1] == ref.shape[1]
    n_c = min(got.shape[2], ref.shape[2])
    scale = np.abs(ref[..., :n_c]).max()
    err = np.abs(got[..., :n_c] - ref[..., :n_c]).max()
    assert err / scale < 1e-4, f"cascade rel err {err / scale}"


@pytest.mark.parametrize("combine", [1, 16])
def test_lowpsi_lowpsi_monotonic_critical_matches_models(combine):
    """Cascaded LowCBF with an ACTIVE fftshift-aware chomp (216 -> 192,
    band EDGES discarded — divergences.rst) and the monotonic combined
    inversion (perm identity): the sharded chain must match the one-shot
    models bit-for-float. The sps+lowpsi case above has a no-op chomp, so
    only this geometry exercises the monotonic chomp/inversion under
    sharding."""
    import jax

    cfg1 = cfg2 = load_config("lowpsi")
    quantum = len(jax.devices()) * 192 * 4
    n = (10_200_000 // quantum + 1) * quantum
    x = _noise(n, 13)

    fb = TwoStageFilterBank(cfg1, cfg2, critical=True)
    assert fb.stage2_monotonic
    _, chan = fb.execute(fb.init_state(), x[:, None, :])
    nch2 = cfg1.os_factor.normalize(cfg1.channels)          # 192
    inv = TwoStageInverseFilterBank(cfg1, cfg2, combine=combine, nch2=nch2)
    _, ref = inv.execute(inv.init_state(), chan)
    assert ref.shape[2] > 0, "reference produced no output — grow the stream"

    got = _sharded(cfg1, cfg2, x, combine, invert=True)
    assert got.shape[1] == ref.shape[1]
    n_c = min(got.shape[2], ref.shape[2])
    scale = np.abs(ref[..., :n_c]).max()
    err = np.abs(got[..., :n_c] - ref[..., :n_c]).max()
    assert err / scale < 1e-4, f"combine={combine}: rel err {err / scale}"
