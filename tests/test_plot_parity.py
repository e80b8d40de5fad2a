"""Numeric parity of the three charts vs the REAL reference plotting code
: the encoded numbers — bar heights, cumulative series,
coverage curves, the cutoff x-position, and the tick labels — must equal
what scTagger.py's plot functions compute on the same inputs, including the
reference's positional-label / row-0-moved-last quirks (scTagger.py:398-414).

The reference module is imported in-process with its native deps stubbed
(refharness), and every chart is captured by monkeypatching plt.savefig and
snapshotting the live figure (patch heights, line xy data, tick texts).
"""

import importlib.util
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from refharness import REFERENCE, make_stub_dir  # noqa: E402


@pytest.fixture(scope="module")
def ref_mod(tmp_path_factory):
    stub = make_stub_dir(tmp_path_factory.mktemp("stubs"))
    sys.path.insert(0, str(stub))
    try:
        spec = importlib.util.spec_from_file_location("ref_sctagger", REFERENCE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(stub))
    return mod


def _snapshot(fig):
    fig.canvas.draw()
    axes = []
    for ax in fig.axes:
        axes.append(
            {
                "heights": [round(p.get_height(), 9) for p in ax.patches],
                "lines": [
                    (
                        [round(float(v), 9) for v in l.get_xdata()],
                        [round(float(v), 9) for v in l.get_ydata()],
                    )
                    for l in ax.get_lines()
                ],
                "ticks": [t.get_text() for t in ax.get_xticklabels()],
            }
        )
    return axes


class _Capture:
    """Monkeypatches plt.savefig; records a numeric snapshot per save."""

    def __init__(self, monkeypatch):
        import matplotlib.pyplot as plt

        self.snaps = []
        self._plt = plt
        monkeypatch.setattr(
            plt, "savefig", lambda *a, **k: self.snaps.append(
                _snapshot(plt.gcf())
            )
        )

    def one(self):
        self._plt.close("all")
        assert len(self.snaps) == 1, len(self.snaps)
        return self.snaps[0]


@pytest.mark.parametrize(
    "dists",
    [
        # with an NA bucket (the normal case)
        [-1, -1, 0, 0, 0, 1, 2, 2, 5, 5, 5, 3],
        # NO NA bucket: the reference still moves row 0 (distance 0) last
        # and labels positionally — the quirk the r5 rewrite reproduces
        [0, 0, 1, 1, 1, 2, 4, 4],
        # sparse distances: positional labels diverge from the values
        [-1, 0, 3, 3, 7, 7, 7],
    ],
)
def test_stage1_distance_chart_parity(ref_mod, monkeypatch, tmp_path, dists):
    from sctagger.plots import plot_extract_lr_bc

    rnames = [f"r{i}" for i in range(len(dists))]
    alns = [(d, "+", [3], None) for d in dists]

    cap = _Capture(monkeypatch)
    ref_mod.show_plots_extract_lr_bc(rnames, alns, str(tmp_path / "ref.png"))
    ref = cap.one()

    cap2 = _Capture(monkeypatch)
    plot_extract_lr_bc(rnames, np.asarray(dists), str(tmp_path / "ours.png"))
    ours = cap2.one()

    assert len(ref) == len(ours) == 2  # ax + twinx
    for a_ref, a_ours in zip(ref, ours):
        assert a_ref["heights"] == a_ours["heights"]
    # counts bars, cumulative bars, cumulative-% bars all non-empty
    k = len(set(dists))
    assert len(ref[0]["heights"]) == 2 * k and len(ref[1]["heights"]) == k
    assert ref[0]["ticks"] == ours[0]["ticks"]


def test_stage2_coverage_chart_parity(ref_mod, monkeypatch, tmp_path):
    """Coverage curves + the cutoff x-position, with distribution and
    last_idx computed by OUR stage code and the REFERENCE's own
    get_barcode_hist cross-checked on the same top list."""
    from sctagger.core.cutoff import barcode_hist, elbow_cutoff
    from sctagger.plots import plot_sr_bc_coverage

    rng = np.random.default_rng(3)
    counts = np.sort(rng.integers(1, 2000, size=7000))[::-1]
    top = [(f"BC{i}", int(c)) for i, c in enumerate(counts)]
    total = int(counts.sum()) + 500  # includes NA-tag alignments
    step = 1000

    dist = barcode_hist(top, total=total, step_size=step)
    # the reference's own histogram on identical inputs
    ref_mod.step_size = step
    ref_dist = ref_mod.get_barcode_hist(top, total, step)
    assert dist == ref_dist
    last_idx = elbow_cutoff(dist, n_barcodes=len(top), thresh=0.005)

    cap = _Capture(monkeypatch)
    ref_mod.plot_sr_bc_coverage(dist, step, last_idx, str(tmp_path / "r.png"))
    ref = cap.one()

    cap2 = _Capture(monkeypatch)
    plot_sr_bc_coverage(dist, step, last_idx, str(tmp_path / "o.png"))
    ours = cap2.one()

    assert len(ref) == len(ours) == 2
    for a_ref, a_ours in zip(ref, ours):
        assert a_ref["lines"] == a_ours["lines"]
    # the dashed cut line sits at x == last_idx on the twin axis
    cut_x = ours[1]["lines"][-1][0]
    assert cut_x == [last_idx, last_idx]
    # cumulative curve really is a percentage series ending at the cap
    y1 = ours[0]["lines"][0][1]
    assert y1 == sorted(y1) and 0 < y1[-1] <= 100


def test_match_trie_chart_parity(ref_mod, monkeypatch, tmp_path):
    """The dead-code match_trie histogram: per-distance read counts
    (including the -1 'not found' bucket) equal the reference's groupby."""
    from sctagger.plots import plot_match_trie

    rng = np.random.default_rng(9)
    max_error = 2
    full_data = {}
    dists = []
    for rid in range(40):
        e = int(rng.integers(-1, max_error + 1))
        find = {i: set() for i in range(max_error + 1)}
        if e >= 0:
            find[e] = {int(rng.integers(100))}
        full_data[rid] = find
        dists.append(e)

    cap = _Capture(monkeypatch)
    ref_mod.show_plot_match_trie(full_data, str(tmp_path / "r.png"), max_error)
    ref = cap.one()

    cap2 = _Capture(monkeypatch)
    plot_match_trie(np.asarray(dists), str(tmp_path / "o.png"))
    ours = cap2.one()

    assert ref[0]["heights"] == ours[0]["heights"]
    assert ref[0]["ticks"] == ours[0]["ticks"]
