"""Multi-host distributed setup and per-host sharded DADA ingest.

The reference is single-process; inter-tool communication is argv + DADA
files on disk (SURVEY §5 "Distributed communication backend"). The JAX
equivalent:

* :func:`initialize` — guarded ``jax.distributed.initialize``: multi-host
  runs (one process per host, e.g. under GKE/Slurm) set the standard
  coordinator environment (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
  ``JAX_PROCESS_ID`` or an auto-detectable cluster env) and every process
  joins the global mesh; single-process runs are a no-op, so every code
  path below also works unmodified on one host (how CI exercises it).
* :func:`load_dada_sharded` — each process reads ONLY the byte range of the
  DADA file covering its addressable devices' time-axis shards
  (``io.dada.load_split`` mmap reads), and the global sharded array is
  assembled with ``jax.make_array_from_process_local_data`` — no host ever
  touches more than 1/n_processes of the stream.
* :func:`sharded_file_round_trip` — DADA file → per-host sharded ingest →
  time-sharded analysis + Golden inversion (halo-exchange collectives) —
  the distributed form of the reference's file-driven pipeline
  (test_data_pipeline.m:105-144).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io import dada
from ..utils import geometry
from ..utils.rational import Rational

module_logger = logging.getLogger(__name__)

Pair = Tuple[jax.Array, jax.Array]


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the multi-host cluster if one is configured; no-op otherwise.

    Returns True when running multi-process. Explicit arguments override the
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
    environment; with neither present this is single-process mode.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes or num_processes <= 1:
        module_logger.debug("single-process mode (no coordinator configured)")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    module_logger.info(
        "joined cluster: process %d/%d, %d local of %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def load_dada_sharded(
    path: str,
    mesh: Mesh,
    *,
    axis: str = "time",
    count: Optional[int] = None,
) -> Tuple[Pair, dict]:
    """Read a DADA file time-sharded over ``mesh[axis]``, each process
    touching only its own slice of the stream.

    Returns ((re, im) global jax arrays of shape (n_pol, n_dat) with
    NamedSharding P(None, axis), header dict). n_dat is truncated to a
    multiple of the axis size. Single-channel (raw stream) files only —
    fine-channel files shard the same way with the channel axis replicated.
    """
    header = dada.read_header(path)
    n_chan = int(header.get("NCHAN", 1))
    npol = int(header.get("NPOL", 2))
    nbit = int(header.get("NBIT", 32))
    ndim = int(header.get("NDIM", 2))
    hdr_size = int(header.get("HDR_SIZE", 4096))
    fsize = os.path.getsize(path)
    total = (fsize - hdr_size) // (npol * n_chan * ndim * (nbit // 8))
    if count is not None:
        total = min(total, count)

    n_shards = mesh.shape[axis]
    n_dat = (total // n_shards) * n_shards
    per_shard = n_dat // n_shards

    if n_chan != 1:
        spec = P(None, None, axis)
    else:
        spec = P(None, axis)
    sharding = NamedSharding(mesh, spec)

    # which global shard indices live on this process's devices
    local_rows = sorted(
        {
            _shard_index(mesh, axis, d)
            for d in mesh.devices.ravel()
            if d.process_index == jax.process_index()
        }
    )
    # the concatenated pieces are handed to make_array_from_process_local_data,
    # which requires this process's addressable shards to form one contiguous
    # run of the global time axis — reject meshes whose process-to-device
    # layout interleaves rows rather than silently misassembling the stream
    if local_rows != list(range(local_rows[0], local_rows[0] + len(local_rows))):
        raise ValueError(
            f"process {jax.process_index()} owns non-contiguous shard rows "
            f"{local_rows}; reorder the mesh so each process holds a "
            f"contiguous run of the sharded axis"
        )
    # contiguous run per process for a single mmap read each
    pieces = []
    for row in local_rows:
        xr, xi, _ = dada.load_split(
            path, count=per_shard, offset_samples=row * per_shard
        )
        if n_chan == 1:
            xr, xi = xr[:, 0, :], xi[:, 0, :]
        pieces.append((xr, xi))
    local_r = np.concatenate([p[0] for p in pieces], axis=-1)
    local_i = np.concatenate([p[1] for p in pieces], axis=-1)

    if n_chan == 1:
        gshape = (npol, n_dat)
    else:
        gshape = (npol, n_chan, n_dat)
    gr = jax.make_array_from_process_local_data(sharding, local_r, gshape)
    gi = jax.make_array_from_process_local_data(sharding, local_i, gshape)
    return (gr, gi), header


def _shard_index(mesh: Mesh, axis: str, device) -> int:
    """Index of ``device`` along ``axis`` in the mesh device grid."""
    pos = np.argwhere(mesh.devices == device)
    if pos.size == 0:
        raise ValueError(f"{device} not in mesh")
    return int(pos[0][list(mesh.axis_names).index(axis)])


def sharded_file_round_trip(
    path: str,
    config,
    mesh: Mesh,
    *,
    count: Optional[int] = None,
) -> Pair:
    """DADA file → per-host sharded ingest → time-sharded analysis +
    Golden inversion. Returns the (re, im) inverted stream (sharded)."""
    from .sharded import sharded_round_trip

    (xr, xi), header = load_dada_sharded(path, mesh, count=count)
    filt = config.load_fir_filter_coeff()
    os_f = Rational.coerce(config.os_factor)
    step = geometry.analysis_step(config.channels, os_f)
    n_dev = mesh.shape["time"]
    quantum = n_dev * step * os_f.nu
    n_dat = (xr.shape[-1] // quantum) * quantum
    spec = NamedSharding(mesh, P(None, "time"))
    xr = jax.lax.with_sharding_constraint(xr[:, :n_dat], spec)
    xi = jax.lax.with_sharding_constraint(xi[:, :n_dat], spec)
    return sharded_round_trip(
        (xr, xi), filt, config.channels, os_f,
        config.input_fft_length, config.input_overlap, mesh,
        temporal_taper=config.temporal_taper,
        deripple=bool(config.deripple),
    )
