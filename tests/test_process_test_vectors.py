"""Test-vector tree walker (process_test_vectors role) + quick-look tools."""

import json
import os

import numpy as np
import pytest

from ska_pst_dsp.analysis import process_test_vectors as ptv
from ska_pst_dsp.analysis import quicklook
from ska_pst_dsp.utils.config import load_config


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tv_tree"))
    cfg = load_config("low")
    n = ptv.generate_tree(cfg, base, n_test=2)
    assert n == 4  # 2 time + 2 freq
    return base


def test_iter_test_vectors(tree):
    found = list(ptv.iter_test_vectors(tree))
    assert len(found) == 4
    domains = {d for d, _ in found}
    assert domains == {"time", "freq"}
    for _, sub in found:
        meta = json.load(open(os.path.join(sub, "meta.json")))
        for key in ("input_file", "channelized_file", "inverted_file"):
            assert os.path.exists(os.path.join(sub, meta[key]))


def test_three_way_report(tree):
    report = ptv.process_test_vectors(tree, plot=False)
    assert len(report["time"]) == 2 and len(report["freq"]) == 2
    for rows in report.values():
        for r in rows:
            # model inversion and the independent (fp64 oracle) inversion
            # must agree far more tightly than either matches the input
            assert r["time_mean_diff"]["independent_vs_inverted"] < 1e-5
            assert (
                r["time_mean_diff"]["independent_vs_inverted"]
                < max(r["time_mean_diff"]["inverted_vs_input"], 1e-9)
            )
    # the products report landed
    from ska_pst_dsp.data_gen.config import products_dir

    assert os.path.exists(
        os.path.join(products_dir, "report.process_test_vectors.json")
    )


def test_quicklook_dada(tree, tmp_path):
    _, sub = next(ptv.iter_test_vectors(tree))
    meta = json.load(open(os.path.join(sub, "meta.json")))
    out = str(tmp_path / "ql.png")
    # channelized file -> waterfall branch; input -> trace branch
    quicklook.plot_dada_file(
        os.path.join(sub, meta["channelized_file"]), out_path=out
    )
    assert os.path.getsize(out) > 1000
    out2 = str(tmp_path / "ql2.png")
    quicklook.plot_dada_file(
        os.path.join(sub, meta["input_file"]), out_path=out2
    )
    assert os.path.getsize(out2) > 1000


def test_quicklook_binary(tmp_path):
    raw = tmp_path / "x.bin"
    (np.arange(64) + 1j * np.arange(64)).astype(np.complex64).tofile(str(raw))
    out = str(tmp_path / "b.png")
    quicklook.plot_binary_files(
        str(raw), dtype=np.complex64, out_path=out
    )
    assert os.path.getsize(out) > 1000
    # npy path
    npy = tmp_path / "y.npy"
    np.save(str(npy), np.arange(32, dtype=np.float32))
    out2 = str(tmp_path / "n.png")
    quicklook.plot_binary_files(str(npy), dtype=np.float32, out_path=out2)
    assert os.path.getsize(out2) > 1000
