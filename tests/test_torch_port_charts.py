"""The port's charts (`utils/chart.py`, `utils/plotting.py`) against the JAX package's
matplotlib figures, on the CPU.

Each JAX chart function runs with `matplotlib.figure.Figure.savefig` wrapped, so that the
figure is recorded after JAX's own save; the port's chart function runs with its
`chart.Figure.savefig` wrapped the same way. The records must agree:

(a) the figure's pixel size and the written file's decoded size;
(b) per axes (in figure order, the colorbar's last): the view limits and the tick
    locations (within 1e-9 relative), the tick-label, offset, title and axis-label strings;
(c) the artists' data: line vertices, bar and histogram rectangles (heights are the
    counts), `hist2d` counts and edges, scatter offsets, the image's array, rectangles;
(d) the port's `Blues` table and `tab10` cycle against matplotlib's in uint8, and DejaVu
    Sans' advance widths against the font file matplotlib ships;
(e) the raster agrees with the data: every heatmap cell's centre pixel (the confusion
    matrix, each `hist2d`, the colorbar's bands) is `Blues` of its value, and each line's
    vertices lie on pixels of its colour (the last line of an axes exactly; an earlier one,
    which later lines may cross, on a pixel its colour at its alpha can make over some
    colour).

Pixels are not compared with matplotlib's: its fonts and antialiasing are not the port's.
"""

import csv

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
from matplotlib import colormaps, font_manager, ft2font  # noqa: E402
from matplotlib.figure import Figure as MplFigure  # noqa: E402

import sar_yolo_tpu.utils.plotting as jax_plotting  # noqa: E402
from sar_yolo_tpu_torch.data.imageio import imread  # noqa: E402
from sar_yolo_tpu_torch.utils import chart  # noqa: E402
from sar_yolo_tpu_torch.utils import plotting  # noqa: E402

RTOL = 1e-9


@pytest.fixture
def figures(monkeypatch):
    """The figures each package saved, in order."""
    saved = {"jax": [], "port": []}
    mpl_save, port_save = MplFigure.savefig, chart.Figure.savefig

    def jax_savefig(self, *args, **kw):
        out = mpl_save(self, *args, **kw)
        saved["jax"].append((self, args[0] if args else kw.get("fname"), kw.get("dpi")))
        return out

    def port_savefig(self, path, dpi=120.0):
        out = port_save(self, path, dpi)
        saved["port"].append((self, path, dpi))
        return out
    monkeypatch.setattr(MplFigure, "savefig", jax_savefig)
    monkeypatch.setattr(chart.Figure, "savefig", port_savefig)
    return saved


def _mpl_record(fig, dpi) -> dict:
    """What matplotlib drew, read back from the saved figure."""
    out = {"size": (int(round(fig.get_size_inches()[1] * dpi)),
                    int(round(fig.get_size_inches()[0] * dpi))), "axes": []}
    for ax in fig.axes:
        rec = {"xlim": ax.get_xlim(), "ylim": ax.get_ylim(), "title": ax.get_title(),
               "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(), "visible_axis": ax.axison}
        for name, axis in (("x", ax.xaxis), ("y", ax.yaxis)):
            rec[f"{name}ticks"] = np.asarray(axis.get_majorticklocs(), np.float64)
            rec[f"{name}labels"] = [t.get_text() for t in axis.get_majorticklabels()]
            rec[f"{name}offset"] = axis.get_offset_text().get_text()
        if ax.get_label() == "<colorbar>":
            rec["xticks"], rec["xlabels"] = np.zeros(0), []
        rec["lines"] = [(np.asarray(ln.get_xdata(), np.float64), np.asarray(ln.get_ydata(),
                                                                             np.float64),
                         matplotlib.colors.to_rgb(ln.get_color()), ln.get_alpha(),
                         ln.get_linewidth(), ln.get_label() if not ln.get_label().startswith("_")
                         else None) for ln in ax.lines]
        rec["rects"] = [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
                        for p in ax.patches]
        meshes, scatters = [], []
        for c in ax.collections:
            if isinstance(c, matplotlib.collections.QuadMesh) and ax.get_label() != "<colorbar>":
                coords = c.get_coordinates()
                meshes.append((np.asarray(c.get_array()).reshape(coords.shape[0] - 1,
                                                                 coords.shape[1] - 1),
                               coords[0, :, 0], coords[:, 0, 1]))
            elif isinstance(c, matplotlib.collections.PathCollection):
                scatters.append(np.asarray(c.get_offsets(), np.float64))
        rec["meshes"], rec["scatters"] = meshes, scatters
        rec["images"] = [np.asarray(im.get_array()) for im in ax.images]
        out["axes"].append(rec)
    return out


def _port_record(fig, dpi) -> dict:
    out = {"size": fig.pixels.shape[:2], "axes": []}
    for ax in fig.axes:
        rec = {"xlim": ax.get_xlim(), "ylim": ax.get_ylim(), "title": ax.get_title(),
               "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(), "visible_axis": ax.axison}
        for name, axis in (("x", ax.xaxis), ("y", ax.yaxis)):
            locs, labels, offset = ax.ticks(axis)
            rec[f"{name}ticks"], rec[f"{name}labels"], rec[f"{name}offset"] = locs, labels, offset
        arts = ax.artists
        rec["lines"] = [(np.asarray(a.x, np.float64), np.asarray(a.y, np.float64), a.color,
                         a.alpha, a.lw, a.label) for a in arts if a.kind == "line"]
        rec["rects"] = [r for a in arts if a.kind == "bars"
                        for r in zip(a.x, a.y, a.w, a.h)]
        rec["rects"] += [(a.patch.xy[0], a.patch.xy[1], a.patch.width, a.patch.height)
                         for a in arts if a.kind == "rect"]
        rec["meshes"] = [(a.counts.T, a.xedges, a.yedges) for a in arts if a.kind == "mesh"]
        rec["scatters"] = [a.offsets for a in arts if a.kind == "scatter"]
        rec["images"] = [a.array for a in arts if a.kind == "image"]
        out["axes"].append(rec)
    return out


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, f"{what}: shapes {a.shape} != {b.shape}"
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=what)


def _compare(saved: dict):
    assert len(saved["jax"]) == len(saved["port"]) > 0
    for (mfig, mpath, mdpi), (pfig, ppath, pdpi) in zip(saved["jax"], saved["port"]):
        assert mdpi == pdpi == 120
        want, got = _mpl_record(mfig, mdpi), _port_record(pfig, pdpi)
        assert got["size"] == want["size"]
        assert imread(ppath).shape[:2] == want["size"]
        assert len(got["axes"]) == len(want["axes"])
        for i, (w, g) in enumerate(zip(want["axes"], got["axes"])):
            tag = f"{ppath} axes {i}"
            for k in ("title", "xlabel", "ylabel", "visible_axis", "xoffset", "yoffset"):
                assert g[k] == w[k], f"{tag} {k}: {g[k]!r} != {w[k]!r}"
            if not w["visible_axis"]:
                continue
            for k in ("xlim", "ylim", "xticks", "yticks"):
                _close(g[k], w[k], f"{tag} {k}")
            for k in ("xlabels", "ylabels"):
                assert g[k] == w[k], f"{tag} {k}: {g[k]} != {w[k]}"
            assert len(g["lines"]) == len(w["lines"]), tag
            for j, (gl, wl) in enumerate(zip(g["lines"], w["lines"])):
                _close(gl[0], wl[0], f"{tag} line {j} x")
                _close(gl[1], wl[1], f"{tag} line {j} y")
                _close(gl[2], wl[2], f"{tag} line {j} colour")
                assert gl[3:] == wl[3:], f"{tag} line {j}: {gl[3:]} != {wl[3:]}"
            _close(g["rects"], w["rects"], f"{tag} rectangles")
            assert len(g["meshes"]) == len(w["meshes"]), tag
            for gm, wm in zip(g["meshes"], w["meshes"]):
                for k in range(3):
                    _close(gm[k], wm[k], f"{tag} hist2d")
            assert len(g["scatters"]) == len(w["scatters"]), tag
            for gs, ws in zip(g["scatters"], w["scatters"]):
                _close(gs, ws, f"{tag} scatter offsets")
            assert len(g["images"]) == len(w["images"]), tag
            for gi, wi in zip(g["images"], w["images"]):
                _close(gi, wi, f"{tag} image")
        _check_raster(pfig)


def _check_raster(fig):
    """(e): the port's pixels agree with its data."""
    px = fig.pixels.astype(np.int64)
    H, W = px.shape[:2]
    cells = 0
    for ax in fig.axes:
        cbar = getattr(ax, "colorbar_of", None)
        for a in ax.artists:
            if a.kind == "image":
                v = chart._norm(a.array, a.vmin, a.vmax)
                xe, ye = np.arange(v.shape[1] + 1) - 0.5, np.arange(v.shape[0] + 1) - 0.5
            elif a.kind == "mesh":
                v = chart._norm(a.counts.T, a.vmin, a.vmax)
                xe, ye = a.xedges, a.yedges
            else:
                continue
            xc, yc = np.meshgrid((xe[1:] + xe[:-1]) / 2, (ye[1:] + ye[:-1]) / 2)
            cx, cy = fig.to_pixels(ax, xc, yc)
            want = chart.BLUES_U8[chart.cmap_index(v)]
            got = px[np.floor(cy).astype(int), np.floor(cx).astype(int)]
            np.testing.assert_array_equal(got, want)
            cells += v.size
        if cbar is not None:
            vals = (np.arange(chart.CMAP_N) + 0.5) / chart.CMAP_N
            cx, cy = fig.to_pixels(ax, np.full(chart.CMAP_N, 0.5),
                                   cbar.vmin + vals * (cbar.vmax - cbar.vmin))
            got = px[np.floor(cy).astype(int), np.floor(cx).astype(int)]
            np.testing.assert_array_equal(got, chart.BLUES_U8)
        lines = [a for a in ax.artists if a.kind == "line"]
        c0, r0, c1, r1 = chart._box_px(ax, W, H)
        covered = np.zeros((H, W), bool)  # pixels of the lines drawn later, and the legend
        if getattr(ax, "legend_box", None) is not None:
            lc0, lr0, lc1, lr1 = ax.legend_box
            covered[max(int(lr0) - 1, 0):int(lr1) + 2, max(int(lc0) - 1, 0):int(lc1) + 2] = True
        for k in range(len(lines) - 1, -1, -1):
            a = lines[k]
            x, y = fig.to_pixels(ax, np.asarray(a.x, np.float64), np.asarray(a.y, np.float64))
            ok = np.isfinite(x) & np.isfinite(y) & (x >= c0 + 2) & (x < c1 - 2) & \
                (y >= r0 + 2) & (y < r1 - 2)
            ok[ok] &= ~covered[np.floor(y[ok]).astype(int), np.floor(x[ok]).astype(int)]
            got = px[np.floor(y[ok]).astype(int), np.floor(x[ok]).astype(int)]
            half = max(a.lw * fig.dpi / 72 / 2, 0.5, chart.MARKER_SIZE * fig.dpi / 72 / 4) + 1.5
            rs, cs, m = chart._stroke_mask((H, W), x, y, half, (0, 0, W, H))
            covered[rs, cs] |= m
            c = np.rint(np.asarray(a.color) * 255)
            alpha = 1.0 if a.alpha is None else a.alpha
            if k == len(lines) - 1 and alpha == 1.0:
                assert (got == c).all(), f"line {k}: vertices off its colour"
            else:  # alpha * c + (1 - alpha) * u for some u in [0, 255]
                lo, hi = alpha * c - 1, alpha * c + (1 - alpha) * 255 + 1
                assert ((got >= lo) & (got <= hi)).all(), f"line {k}: vertices off its colour"
    return cells


# ---- (a-c, e) the four charts ------------------------------------------------------------------

def _write_csv(path, rows: list):
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


RESULTS_KEYS = ["train/box", "train/cls", "train/dfl", "train/clr", "train/state",
                "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)", "fitness", "speed/ms_per_image", "lr"]


def _results_rows(n_epochs: int, seed: int, keys=RESULTS_KEYS) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(n_epochs):
        row = {"epoch": e}
        for k in keys:
            if k.startswith("train/"):
                row[k] = f"{3.0 * np.exp(-0.1 * e) + rng.random():.6g}"
            elif k == "lr":
                row[k] = f"{0.01 * (1 - e / max(n_epochs, 1)) + 1e-5:.6g}"
            elif k == "speed/ms_per_image":
                row[k] = f"{40 + 5 * rng.random():.6g}"
            else:
                row[k] = f"{min(1.0, 0.05 * e + 0.1 * rng.random()):.6g}"
        rows.append(row)
    return rows


@pytest.mark.parametrize("case", ["one_epoch", "three_epochs", "thirty_epochs", "gaps",
                                  "constant", "two_keys", "tiny_values", "large_values"])
def test_plot_results_matches_jax(case, figures, tmp_path):
    n = {"one_epoch": 1, "three_epochs": 3, "thirty_epochs": 30}.get(case, 6)
    keys = RESULTS_KEYS[:2] if case == "two_keys" else RESULTS_KEYS
    rows = _results_rows(n, seed=len(case), keys=keys)
    if case == "gaps":
        rows[0]["metrics/mAP50(B)"] = ""
        rows[2]["fitness"] = "None"
        for r in rows:
            r["train/state"] = "None"
    elif case == "constant":
        for r in rows:
            r["metrics/recall(B)"] = "0"
            r["fitness"] = "0.5"
    elif case == "tiny_values":
        for i, r in enumerate(rows):
            r["lr"] = f"{1e-7 * (i + 1):.6g}"
            r["fitness"] = f"{-1e-3 * i:.6g}"
    elif case == "large_values":
        for i, r in enumerate(rows):
            r["speed/ms_per_image"] = f"{1.2e7 + 3e4 * i:.6g}"
            r["train/box"] = f"{1000.5 + 0.01 * i:.6g}"
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        _write_csv(tmp_path / d / "results.csv", rows)
    assert jax_plotting.plot_results(tmp_path / "jax" / "results.csv").name == "results.png"
    assert plotting.plot_results(tmp_path / "port" / "results.csv").name == "results.png"
    _compare(figures)


def test_plot_results_without_rows(tmp_path):
    assert plotting.plot_results(tmp_path / "missing.csv") is None
    (tmp_path / "results.csv").write_text("epoch,train/box\n")
    assert plotting.plot_results(tmp_path / "results.csv") is None
    assert not (tmp_path / "results.png").exists()


@pytest.mark.parametrize("n_cls", [1, 3, 12, 13])
def test_plot_pr_curve_matches_jax(n_cls, figures, tmp_path):
    rng = np.random.default_rng(n_cls)
    grid = np.linspace(0, 1, 101)
    prec = np.sort(rng.random((n_cls, 101)), axis=1)[:, ::-1]
    names = {i: f"class{i}" for i in range(0, n_cls, 2)}
    if n_cls == 1:
        prec = prec[0]
    jax_plotting.plot_pr_curve(grid, prec, names=names, save_path=str(tmp_path / "j.png"))
    plotting.plot_pr_curve(grid, prec, names=names, save_path=str(tmp_path / "p.png"))
    _compare(figures)


@pytest.mark.parametrize("nc,names", [(1, None), (3, {0: "person", 1: "car", 2: "boat"}),
                                      (10, None), (0, None)])
def test_confusion_matrix_plot_matches_jax(nc, names, figures, tmp_path):
    rng = np.random.default_rng(nc)
    j, p = jax_plotting.ConfusionMatrix(nc), plotting.ConfusionMatrix(nc)
    j.matrix[:] = p.matrix[:] = rng.integers(0, 20, (nc + 1, nc + 1))
    if nc == 3:
        j.matrix[:, 1] = p.matrix[:, 1] = 0  # a class never seen: a column of zeros
    j.plot(tmp_path / "j.png", names=names)
    p.plot(tmp_path / "p.png", names=names)
    _compare(figures)


def _label_set(case: str, seed: int):
    rng = np.random.default_rng(seed)
    n = {"few": 3, "many": 2000, "one": 1}.get(case, 300)
    boxes = np.column_stack([rng.uniform(0.05, 0.95, (n, 2)), rng.uniform(0.01, 0.4, (n, 2))])
    cls = rng.integers(0, 5 if case != "single_class" else 1, n)
    if case == "skewed":
        boxes[:, 2:] = rng.exponential(0.02, (n, 2)) + 0.001
    if case == "one":
        boxes = np.array([[0.5, 0.5, 0.2, 0.3]])
    return boxes.astype(np.float32), cls


@pytest.mark.parametrize("case,names", [("default", {0: "person", 1: "car", 2: "boat",
                                                     3: "dog", 4: "cat"}),
                                        ("many", None), ("few", {0: "person"}),
                                        ("skewed", None), ("single_class", {0: "person"}),
                                        ("one", None)])
def test_plot_labels_matches_jax(case, names, figures, tmp_path):
    boxes, cls = _label_set(case, seed=len(case))
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_plotting.plot_labels(boxes, cls, names=names, save_dir=tmp_path / "jax")
    plotting.plot_labels(boxes, cls, names=names, save_dir=tmp_path / "port")
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == \
        sorted(f.name for f in (tmp_path / "jax").iterdir()) == \
        ["labels.jpg", "labels_correlogram.jpg"]
    _compare(figures)


def test_plot_labels_without_boxes(figures, tmp_path):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_plotting.plot_labels(np.zeros((0, 4)), np.zeros(0), save_dir=tmp_path / "jax")
    plotting.plot_labels(np.zeros((0, 4)), np.zeros(0), save_dir=tmp_path / "port")
    assert [f.name for f in (tmp_path / "port").iterdir()] == ["labels.jpg"]
    _compare(figures)


# ---- (d) tables -------------------------------------------------------------------------------

def test_blues_and_tab10_equal_matplotlib():
    want = colormaps["Blues"](np.arange(256), bytes=True)[:, :3]
    np.testing.assert_array_equal(chart.BLUES_U8, want)
    v = np.linspace(-0.1, 1.1, 1001)
    np.testing.assert_array_equal(chart.BLUES_U8[chart.cmap_index(np.clip(v, 0, 1))],
                                  colormaps["Blues"](np.clip(v, 0, 1), bytes=True)[:, :3])
    tab = np.array([chart.hex_rgb(c) for c in chart.TAB10])
    np.testing.assert_array_equal(tab, np.array(colormaps["tab10"].colors))
    np.testing.assert_array_equal((tab * 255).round().astype(np.uint8),
                                  colormaps["tab10"](np.arange(10), bytes=True)[:, :3])


def test_text_metrics_equal_dejavu_sans():
    f = ft2font.FT2Font(font_manager.findfont(font_manager.FontProperties(family="DejaVu Sans")))
    adv = [f.load_char(c, flags=ft2font.LoadFlags.NO_SCALE).horiAdvance for c in range(32, 127)]
    assert adv == chart._ADVANCE
    assert f.load_char(0x2212, flags=ft2font.LoadFlags.NO_SCALE).horiAdvance == \
        chart._MINUS_ADVANCE
    assert f.load_char(ord("l"), flags=ft2font.LoadFlags.NO_SCALE).bbox[3] == chart._ASCENT_L
    assert -f.load_char(ord("p"), flags=ft2font.LoadFlags.NO_SCALE).bbox[1] == chart._DESCENT_P
    # matplotlib's own measurement of tick labels and titles, within a pixel and a half
    from matplotlib.backends.backend_agg import RendererAgg
    r = RendererAgg(100, 100, chart.LAYOUT_DPI)
    for s, size in [("0.0", 10), ("−0.04", 10), ("background", 7), ("metrics/mAP50(B)", 9),
                    ("instances", 10), ("12", 6)]:
        w, h, d = r.get_text_width_height_descent(s, font_manager.FontProperties(size=size),
                                                  False)
        lw, lh, ld = r.get_text_width_height_descent("lp", font_manager.FontProperties(
            size=size), False)
        gw, gh, gd = chart.text_extent(s, size, chart.LAYOUT_DPI)
        assert abs(gw - w) <= 1.5 and (gh, gd) == (max(h, lh), max(d, ld)), (s, size)


def test_scalar_formatter_and_locator_equal_matplotlib():
    """AutoLocator and ScalarFormatter on their own, over many intervals and lengths."""
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(0)
    fig, ax = plt.subplots()
    try:
        for k in range(300):
            lo = rng.choice([0.0, -1.0, 1e-7, 3.2, 1e4, 1.2e7, -0.003]) * rng.random()
            hi = lo + 10.0 ** rng.integers(-9, 8) * rng.random()
            if k % 7 == 0:
                hi = lo
            ax.set_ylim(lo, hi)
            h = rng.uniform(0.5, 6)
            fig.set_size_inches(4, h)
            space = ax.yaxis.get_tick_space()
            vlo, vhi = ax.get_ylim()
            locs = ax.yaxis.get_major_locator()()
            want = ax.yaxis.get_major_formatter().format_ticks(locs)
            off = ax.yaxis.get_major_formatter().get_offset()
            got = chart.auto_ticks(vlo, vhi, space)
            _close(got, locs, f"ticks of ({vlo}, {vhi}) space {space}")
            labels, offset = chart.scalar_labels(got, vlo, vhi)
            assert (labels, offset) == (want, off), (vlo, vhi)
    finally:
        plt.close(fig)
