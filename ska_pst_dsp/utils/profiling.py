"""Tracing / profiling helpers (SURVEY §5 "Tracing / profiling").

The reference sprinkles tic/toc prints through every kernel and driver
(polyphase_analysis.m:40,124-127; sgcht.m:502,577-578). The JAX
equivalents here:

* :class:`StageTimer` — per-stage wall-clock + samples/s counters with a
  one-line report, for driver block loops (device work is made observable
  by blocking on the stage's outputs);
* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard/XProf trace directory when profiling is requested
  (``SKA_PST_TRACE_DIR`` or an explicit path), and a no-op otherwise, so
  drivers can leave it permanently in place;
* :func:`hlo_op_stages`, :func:`device_op_events`,
  :func:`stage_device_ns` and :func:`busy_ns` — the reduction of a trace
  to device time per named stage (:data:`STAGES`) and device busy time,
  used by ``bench.py --trace``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

module_logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulate wall-clock and item counts per named stage.

    >>> t = StageTimer()
    >>> with t.stage("analysis", samples=n):
    ...     out = jax.block_until_ready(analyze(x))
    >>> t.report()
    """

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.items[name] = self.items.get(name, 0) + samples

    def report(self, log=None) -> Dict[str, dict]:
        out = {}
        for name, sec in self.seconds.items():
            n = self.items.get(name, 0)
            entry = {"seconds": round(sec, 4)}
            if n and sec > 0:
                entry["msamples_per_s"] = round(n / sec / 1e6, 2)
            out[name] = entry
            (log or module_logger.info)("%s: %s", name, entry)
        return out


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """jax.profiler trace scope; no-op unless a directory is given or
    SKA_PST_TRACE_DIR is set."""
    trace_dir = trace_dir or os.environ.get("SKA_PST_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
    module_logger.info("profiler trace written to %s", trace_dir)


# ---------------------------------------------------------------------------
# trace -> per-stage device time
# ---------------------------------------------------------------------------

#: the named scopes (``jax.named_scope``) of the round trip's stages, in
#: pipeline order (ops/analysis.py, ops/synthesis.py)
STAGES = (
    "fold", "channel_fft", "frame_taper", "forward_fft", "assemble",
    "backward_fft", "discard",
)


def _stage_key(op_names, stages) -> str:
    """``+``-joined stages (in pipeline order) named as a path component of
    any of ``op_names``; "other" when none is."""
    found = {part for name in op_names for part in name.split("/")}
    key = "+".join(s for s in stages if s in found)
    return key or "other"


def hlo_op_stages(hlo_text: str, stages=STAGES) -> Dict[str, str]:
    """Map each instruction of an optimized HLO module to the stage(s) its
    work belongs to: the named scopes in the ``op_name`` metadata of the
    instruction and of every instruction in the computation it calls. A
    fusion that XLA builds across a stage boundary maps to the joined key
    (e.g. ``fold+channel_fft``), so no stage is credited with another's
    time."""
    import re

    inst = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=")
    comp = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s.*\{\s*$")
    op_name = re.compile(r'op_name="([^"]*)"')
    calls = re.compile(r"(?:calls|to_apply)=%([\w.\-]+)")
    comp_names: Dict[str, list] = {}
    own: Dict[str, list] = {}
    called: Dict[str, list] = {}
    current = None
    for line in hlo_text.splitlines():
        m = comp.match(line)
        if m:
            current = comp_names.setdefault(m.group(1), [])
            continue
        m = inst.match(line)
        if not m:
            continue
        names = op_name.findall(line)
        if current is not None:
            current.extend(names)
        own[m.group(1)] = names
        called[m.group(1)] = calls.findall(line)
    return {
        name: _stage_key(
            names + [n for c in called[name] for n in comp_names.get(c, [])],
            stages,
        )
        for name, names in own.items()
    }


def device_op_events(xplane_path: str):
    """``(hlo_op, op_name, start_ns, duration_ns)`` of every operation the
    trace shows running on a device. GPU traces carry them on the
    ``/device:GPU:n`` planes (kernels, with the HLO instruction and its
    op_name as stats); a CPU trace has no device plane, and its operations
    run on host threads instead."""
    import jax

    prof = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in prof.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in prof.planes if p.name.startswith("/host:CPU")]
    events = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" in stats:
                    events.append((
                        str(stats["hlo_op"]), str(stats.get("name", "")),
                        float(ev.start_ns), float(ev.duration_ns),
                    ))
    return events


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted((e[2], e[3]) for e in events):
        if start > end:
            total += dur
            end = start + dur
        elif start + dur > end:
            total += start + dur - end
            end = start + dur
    return total


def stage_device_ns(events, op_stages: Dict[str, str],
                    stages=STAGES) -> Dict[str, float]:
    """Sum device time per stage key of :func:`hlo_op_stages`. An event
    whose instruction is not in the module (a runtime thunk name) falls back
    to the op_name the trace recorded for it."""
    out: Dict[str, float] = {}
    for op, name, _, dur in events:
        key = op_stages.get(op) or _stage_key([name], stages)
        out[key] = out.get(key, 0.0) + dur
    return out
