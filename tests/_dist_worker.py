"""Worker process for the TRUE multi-process distributed test.

Launched by tests/test_distributed.py::TestTwoProcess as one of two
localhost processes. Each process owns 4 virtual CPU devices; together
they form the 8-device global mesh. The worker joins the cluster through
``parallel.distributed.initialize`` (real ``jax.distributed.initialize``,
gRPC coordinator on localhost), ingests only its own byte range of the
DADA file (``load_dada_sharded`` per-host mmap slices), runs the sharded
analysis + Golden inversion, and checks its ADDRESSABLE shards of the
result against a locally computed one-shot reference. Exit code 0 =
every local shard matched.

Usage: python _dist_worker.py <dada_path> <port> <process_id> <n_procs>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    path, port, pid_s, nproc_s = sys.argv[1:5]
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

    from jax.sharding import Mesh

    from ska_pst_dsp.io import dada
    from ska_pst_dsp.ops import polyphase_analysis, polyphase_synthesis
    from ska_pst_dsp.parallel import distributed
    from ska_pst_dsp.utils.config import load_config
    from ska_pst_dsp.utils.rational import Rational

    multi = distributed.initialize(
        f"localhost:{port}", int(nproc_s), int(pid_s)
    )
    assert multi, "expected multi-process mode"
    assert jax.process_count() == int(nproc_s), jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 4 * int(nproc_s), jax.device_count()

    mesh = Mesh(np.array(jax.devices()), ("time",))
    cfg = load_config("low")
    rr, ri = distributed.sharded_file_round_trip(path, cfg, mesh)

    # local one-shot reference over the whole (small) stream
    x, _ = dada.load(path)
    filt = cfg.load_fir_filter_coeff()
    os_f = Rational.coerce(cfg.os_factor)
    chan = polyphase_analysis(x, filt, cfg.channels, os_f)
    ref = np.asarray(
        polyphase_synthesis(
            chan, cfg.input_fft_length, os_f,
            input_overlap=cfg.input_overlap, deripple_coeff=filt,
            temporal_taper=cfg.temporal_taper,
        )
    )
    scale = np.abs(ref).max()

    checked = 0
    for sr, si in zip(rr.addressable_shards, ri.addressable_shards):
        sl = sr.index[-1]
        lo = sl.start or 0
        got = np.asarray(sr.data) + 1j * np.asarray(si.data)
        # the sharded pipeline trims to whole per-shard inversion blocks;
        # the one-shot reference may be slightly longer at the stream end
        n = min(got.shape[-1], ref.shape[-1] - lo)
        if n <= 0:
            continue
        np.testing.assert_allclose(
            got[..., :n], ref[..., lo:lo + n], atol=3e-6 * scale, rtol=0
        )
        checked += n
    assert checked > 100_000, f"only {checked} samples checked"
    print(f"process {pid_s}: {checked} samples matched", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
