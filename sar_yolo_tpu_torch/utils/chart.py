"""A numpy chart layer: the part of matplotlib's figures (Agg, default style) that the
training and validation charts of `utils/plotting.py` draw. The machine that trains has no
matplotlib; this module plays the part for those charts that `data/cv.py` plays for cv2.

What equals matplotlib 3.x's figure for the same calls:

* the figure's pixel size (`figsize` x `dpi`, white background);
* each axes' view limits: autoscaling of the data limits with 5% margins, sticky edges
  (bars' base, `hist2d`'s and `imshow`'s extents), `nonsingular` expansion of a single
  value, explicit `set_xlim`/`set_ylim`, and the view grown to `set_xticks`' ticks;
* the ticks: `AutoLocator` (`MaxNLocator`, steps 1, 2, 2.5, 5, 10, at most 9 bins and as
  many as the axis' length over its label size allows) or fixed ticks, and their labels
  (`ScalarFormatter` with its offset and power-of-ten rules and the Unicode minus sign,
  or fixed labels);
* the artists' data: line vertices, bar and `hist` rectangles in matplotlib's arithmetic,
  `hist2d` counts and edges (`np.histogram2d`), scatter offsets, image arrays and
  rectangles;
* the `Blues` colormap as its 256-entry table and the `tab10` colour cycle;
* the placement: `subplots`' grid, `tight_layout` (its margins measured from the tick
  labels, axis labels and titles), `colorbar`'s grid and box aspect, `imshow`'s equal
  aspect.

What does not: the pixels of the strokes and of the text. Text is measured with the
advance widths of DejaVu Sans (matplotlib's default font; the table below), so that the
layout and the number of ticks come out as matplotlib's, and drawn in the Hershey simplex
strokes of `data/cv.py::put_text`, scaled to the same advance. Lines are drawn without
antialiasing: a pixel belongs to a line when its centre lies within half the line width
(at least half a pixel) of the line; fills cover the pixels whose centres lie inside.

Examples:
    >>> fig, axes = subplots(1, 2, figsize=(8, 3), squeeze=False)
    >>> axes[0][0].plot([0, 1, 2], [0.5, 0.2, 0.1], marker=".")
    >>> fig.tight_layout()
    >>> fig.savefig("out.png", dpi=120)
"""

from __future__ import annotations

import itertools
import math
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.data import cv
from sar_yolo_tpu_torch.data.hershey import GLYPHS
from sar_yolo_tpu_torch.data.imageio import imwrite

LAYOUT_DPI = 100.0        # matplotlib's figure.dpi: tight_layout measures the text at it
FONT_SIZE = 10.0          # font.size, points: tick and axis labels
TITLE_SIZE = 12.0         # axes.titlesize 'large'
TICK_SIZE, TICK_PAD = 3.5, 3.5  # major tick length and label pad, points
LABEL_PAD = 4.0           # axes.labelpad
TITLE_PAD = 6.0           # axes.titlepad
OFFSET_PAD = 3.0          # the axis offset text's pad
LAYOUT_PAD = 1.08         # tight_layout's pad, in font sizes
SUBPLOT = (0.125, 0.9, 0.11, 0.88, 0.2, 0.2)  # left, right, bottom, top, wspace, hspace
MARGIN = 0.05             # axes.xmargin / ymargin
LINE_WIDTH = 1.5          # lines.linewidth, points
MARKER_SIZE = 6.0         # lines.markersize, points ('.' draws half of it)
SPINE_WIDTH = 0.8         # axes.linewidth and the ticks' width
GRID_COLOR = (176 / 255, 176 / 255, 176 / 255)  # grid.color '#b0b0b0'
GRID_WIDTH = 0.8

TAB10 = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf"]
# ColorBrewer's Blues, the anchors of matplotlib's 'Blues' (evenly spaced)
BLUES_ANCHORS = ["#f7fbff", "#deebf7", "#c6dbef", "#9ecae1", "#6baed6", "#4292c6", "#2171b5",
                 "#08519c", "#08306b"]
CMAP_N = 256

# DejaVu Sans: advance widths of ' ' .. '~' (font units, 2048 an em), the minus sign's, the
# ascent of 'l' and the descent of 'p' (matplotlib sizes every line of text to "lp")
_ADVANCE = [
    651, 821, 942, 1716, 1303, 1946, 1597, 563, 799, 799, 1024, 1716, 651, 739, 651, 690,
    1303, 1303, 1303, 1303, 1303, 1303, 1303, 1303, 1303, 1303, 690, 690, 1716, 1716, 1716,
    1087, 2048, 1401, 1405, 1430, 1577, 1294, 1178, 1587, 1540, 604, 604, 1343, 1141, 1767,
    1532, 1612, 1235, 1612, 1423, 1300, 1251, 1499, 1401, 2025, 1403, 1251, 1403, 799, 690,
    799, 1716, 1024, 1024, 1255, 1300, 1126, 1300, 1260, 721, 1300, 1298, 569, 569, 1186,
    569, 1995, 1298, 1253, 1300, 1300, 842, 1067, 803, 1298, 1212, 1675, 1212, 1212, 1075,
    1303, 690, 1303, 1716]
_MINUS_ADVANCE = 1716
_UNITS_PER_EM = 2048
_ASCENT_L, _DESCENT_P = 1556, 426
MINUS = "−"
_HERSHEY_DIGIT = 20       # a Hershey digit's advance, font units


def hex_rgb(h: str) -> tuple:
    """'#rrggbb' -> (r, g, b) floats in [0, 1], as matplotlib.colors.to_rgb."""
    return tuple(int(h[i:i + 2], 16) / 255 for i in (1, 3, 5))


def _lut(anchors: list, n: int = CMAP_N) -> np.ndarray:
    """(n, 3) float table of a colormap through evenly spaced anchors: matplotlib's
    `LinearSegmentedColormap.from_list` and `_create_lookup_table`."""
    rgb = np.array([hex_rgb(a) for a in anchors])
    x = np.linspace(0, 1, len(anchors)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([rgb[:1], dist[:, None] * (rgb[ind] - rgb[ind - 1]) + rgb[ind - 1],
                          rgb[-1:]])
    return np.clip(lut, 0.0, 1.0)


BLUES = _lut(BLUES_ANCHORS)
BLUES_U8 = (BLUES * 255).astype(np.uint8)  # cmap(x, bytes=True): truncated
CMAPS = {"Blues": BLUES_U8}


def cmap_index(v) -> np.ndarray:
    """Table rows of normalized values: matplotlib's Colormap.__call__ on floats (x N,
    1.0 -> N - 1, truncated, clipped to the table)."""
    xa = np.array(v, np.float64) * CMAP_N
    xa[xa == CMAP_N] = CMAP_N - 1
    return np.clip(np.nan_to_num(xa, nan=0.0), -1, CMAP_N).astype(int).clip(0, CMAP_N - 1)


_LETTERS = {"b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0),
            "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0)}


def to_rgb(c) -> tuple:
    """A colour given as '#rrggbb', a matplotlib single-letter colour, a grey level string
    or an RGB(A) sequence of floats -> (r, g, b)."""
    if isinstance(c, str):
        if c.startswith("#"):
            return hex_rgb(c)
        return _LETTERS[c] if c in _LETTERS else (float(c),) * 3
    return tuple(float(x) for x in np.asarray(c, np.float64).ravel()[:3])


# ---- text -------------------------------------------------------------------------------------

def text_extent(s: str, size: float, dpi: float) -> tuple:
    """(width, height, descent) in pixels of one line of text at `size` points: the sum of
    DejaVu Sans' advances, and the line height of "lp" as matplotlib lays text out."""
    em = size * dpi / 72
    adv = sum(_MINUS_ADVANCE if ch == MINUS else
              _ADVANCE[ord(ch) - 32] if 32 <= ord(ch) < 127 else _ADVANCE[31] for ch in s)
    d = round(_DESCENT_P / _UNITS_PER_EM * em)
    return adv / _UNITS_PER_EM * em, math.ceil(_ASCENT_L / _UNITS_PER_EM * em) + d, d


def _hershey_scale(size: float, dpi: float) -> float:
    """put_text's scale whose digit advance equals DejaVu Sans' at `size` points."""
    return size * dpi / 72 * (1303 / _UNITS_PER_EM) / _HERSHEY_DIGIT


def _hershey_width(s: str, scale: float) -> float:
    return sum(ord(GLYPHS.get(ch, GLYPHS["?"])[1]) - ord(GLYPHS.get(ch, GLYPHS["?"])[0])
               for ch in s) * scale


def _text_mask(s: str, size: float, dpi: float, rotation: int = 0) -> tuple:
    """(mask, x of the box's left edge in the mask, baseline y) of the Hershey rendering:
    a boolean patch with the text's strokes."""
    s = s.replace(MINUS, "-")
    scale = _hershey_scale(size, dpi)
    w = int(math.ceil(_hershey_width(s, scale))) + 4
    top, bottom = int(math.ceil(21 * scale)) + 2, int(math.ceil(7 * scale)) + 2
    patch = np.full((top + bottom, w), 255, np.uint8)
    cv.put_text(patch, s, (2, top), scale, 0, 1)
    mask = patch != 255
    return (np.rot90(mask) if rotation == 90 else mask), 2, top


# ---- ticks ------------------------------------------------------------------------------------

def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """matplotlib.transforms.nonsingular (increasing)."""
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


_STEPS = np.array([0.1, 0.2, 0.25, 0.5, 1, 2, 2.5, 5, 10, 20])  # MaxNLocator's staircase


def _edge_close(ms, edge, step, offset) -> bool:
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def auto_ticks(vmin: float, vmax: float, tick_space: int) -> np.ndarray:
    """AutoLocator's ticks of the view interval: MaxNLocator(nbins='auto', steps=[1, 2,
    2.5, 5, 10]) with `tick_space` bins allowed (clipped to 1..9), min_n_ticks 2."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    nbins = int(np.clip(tick_space, 1, 9))
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0 if abs(meanv) / dv < 100 else math.copysign(
        10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    off = abs(offset)
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _edge_close(m / step, 1, step, off) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _edge_close(m / step, 0, step, off) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def _fix_minus(s: str) -> str:
    return s.replace("-", MINUS)


def _format_data(value: float) -> str:
    e = math.floor(math.log10(abs(value)))
    s = round(value / 10 ** e, 10)
    significand = _fix_minus("%d" % s if s % 1 == 0 else "%1.10g" % s)
    return significand if e == 0 else f"{significand}e{_fix_minus('%d' % e)}"


def scalar_labels(locs: np.ndarray, vmin: float, vmax: float) -> tuple:
    """(tick label strings, offset text) of ScalarFormatter (useOffset, offset threshold 4,
    power limits (-5, 6), Unicode minus) for ticks `locs` of the view (vmin, vmax)."""
    locs = np.asarray(locs, np.float64)
    if not len(locs):
        return [], ""
    vmin, vmax = sorted((vmin, vmax))
    inside = locs[(vmin <= locs) & (locs <= vmax)]
    offset = 0
    if len(inside):
        lmin, lmax = inside.min(), inside.max()
        if not (lmin == lmax or lmin <= 0 <= lmax):
            abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
            sign = math.copysign(1, lmin)
            oom_max = np.ceil(math.log10(abs_max))
            oom = 1 + next(o for o in itertools.count(oom_max, -1)
                           if abs_min // 10 ** o != abs_max // 10 ** o)
            if (abs_max - abs_min) / 10 ** oom <= 1e-2:
                oom = 1 + next(o for o in itertools.count(oom_max, -1)
                               if abs_max // 10 ** o - abs_min // 10 ** o > 1)
            offset = sign * (abs_max // 10 ** oom) * 10 ** oom \
                if abs_max // 10 ** oom >= 10 ** 3 else 0
    oom_mag = 0
    a = np.abs(inside)
    if len(a):
        if offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            oom = 0 if a.max() == 0 else math.floor(math.log10(a.max()))
        oom_mag = oom if oom <= -5 or oom >= 6 else 0
    _locs = list(locs) + ([vmin, vmax] if len(locs) < 2 else [])
    v = (np.asarray(_locs) - offset) / 10. ** oom_mag
    loc_range = np.ptp(v)
    if loc_range == 0:
        loc_range = np.max(np.abs(v))
    if loc_range == 0:
        loc_range = 1
    if len(locs) < 2:
        v = v[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(v - np.round(v, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    fmt = f"%1.{sigfigs + 1}f"
    labels = []
    for x in locs:
        xp = (x - offset) / (10. ** oom_mag)
        labels.append(_fix_minus(fmt % (0 if abs(xp) < 1e-8 else xp)))
    text = ""
    if oom_mag or offset:
        off_s = ("+" if offset > 0 else "") + _format_data(offset) if offset else ""
        text = _fix_minus(("1e%d" % oom_mag if oom_mag else "") + off_s)
    return labels, text


def _contains_close(lo: float, hi: float, v: float, rtol: float = 1e-10) -> bool:
    lo, hi = sorted((lo, hi))
    r = (hi - lo) * rtol
    return lo - r <= v <= hi + r


# ---- artists ----------------------------------------------------------------------------------

class Artist:
    """Data of one drawn artist; `kind` is 'line', 'bars', 'rect', 'mesh', 'scatter' or
    'image'."""

    def __init__(self, kind: str, **data):
        self.kind = kind
        self.__dict__.update(data)


class Rectangle:
    """matplotlib.patches.Rectangle((x, y), width, height, fill=False, edgecolor, lw, alpha):
    an outline (filled rectangles are `bar`'s)."""

    def __init__(self, xy, width, height, fill=False, edgecolor="k", lw=1.0, alpha=None):
        if fill:
            raise NotImplementedError("filled Rectangle patches (use bar)")
        self.xy, self.width, self.height = (xy[0], xy[1]), width, height
        self.edgecolor, self.lw, self.alpha = edgecolor, lw, alpha


class _Axis:
    def __init__(self, name: str):
        self.name = name
        self.fixed = None            # set_xticks' locations
        self.fixed_labels = None     # set_xticklabels' strings
        self.label_size = FONT_SIZE  # tick_params(labelsize=): also the tick space's size
        self.text_size = None        # set_xticklabels(fontsize=)
        self.rotation = 0
        self.side = "bottom" if name == "x" else "left"
        self.on = True
        self.label, self.label_fontsize = "", FONT_SIZE


class Axes:
    """One axes of a `Figure`; methods named and behaving as matplotlib's for the calls
    the charts make."""

    def __init__(self, fig: "Figure", cell: tuple):
        self.fig, self.cell = fig, cell     # cell: (row, col) of the figure's grid
        self.orig = self.active = (0.0, 0.0, 1.0, 1.0)  # (left, bottom, width, height)
        self.artists: list[Artist] = []
        self._data = [math.inf, -math.inf, math.inf, -math.inf]
        self._sticky = {"x": [], "y": []}
        self._scaled = False                 # whether an artist asked for autoscaling
        self._lim = {"x": None, "y": None}   # explicit limits
        self._grow = {"x": [], "y": []}      # set_xticks' ticks the view must hold
        self.xaxis, self.yaxis = _Axis("x"), _Axis("y")
        self.title, self.title_size = "", TITLE_SIZE
        self.axison = True
        self.grid_alpha = None
        self.legend_ = None
        self.equal = False                   # imshow's aspect
        self.box_aspect = None               # the colorbar's
        self.anchor = (0.5, 0.5)
        self._cycle = 0
        self._patch_cycle = 0

    # -- data limits
    def _update_data(self, x, y):
        self._scaled = True
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        ok = np.isfinite(x) & np.isfinite(y)
        if ok.any():
            d = self._data
            d[0], d[1] = min(d[0], x[ok].min()), max(d[1], x[ok].max())
            d[2], d[3] = min(d[2], y[ok].min()), max(d[3], y[ok].max())

    def _next_color(self) -> tuple:
        c = hex_rgb(TAB10[self._cycle % len(TAB10)])
        self._cycle += 1
        return c

    # -- plotting calls
    def plot(self, x, y, fmt: str | None = None, *, marker=None, lw=None, linewidth=None,
             alpha=None, label=None, color=None):
        x, y = np.asarray(x), np.asarray(y)
        if fmt:
            color = color or fmt[0]
        rgb = to_rgb(color) if color is not None else self._next_color()
        self.artists.append(Artist("line", x=x, y=y, color=rgb, alpha=alpha, marker=marker,
                                   lw=float(lw or linewidth or LINE_WIDTH), label=label))
        self._update_data(x, y)

    def bar(self, x, height, width=0.8, color=None):
        x, height = np.asarray(x), np.asarray(height)
        left = x - width / 2
        colors = list(color) if color is not None and np.ndim(color) == 2 else \
            [color] * len(left) if color is not None else [hex_rgb(TAB10[0])] * len(left)
        self.artists.append(Artist("bars", x=left, y=np.zeros(len(left)),
                                   w=np.broadcast_to(width, left.shape),
                                   h=height, colors=[to_rgb(c) for c in colors]))
        for lx, w, h in zip(left, np.broadcast_to(width, left.shape), height):
            self._update_data([lx, lx + w], [0, h])
        self._sticky["y"].append(0.0)

    def hist(self, x, bins=10, color=None):
        x = np.asarray(x)
        rng = (np.nanmin(x), np.nanmax(x)) if len(x) else None
        n, edges = np.histogram(x, bins, range=rng)
        edges = np.asarray(edges, np.float64)  # counted on the data's dtype, placed in float64
        tot = np.diff(edges)
        width = 1.0 * tot / 1
        boffset = -0.5 * 1.0 * tot * (1 - 1 / 1)
        boffset += 0.5 * tot
        self.bar(edges[:-1] + boffset, np.asarray(n, float), width,
                 color=[to_rgb(color)] * len(n) if color else None)
        self.artists[-1].counts, self.artists[-1].edges = n, edges
        return n, edges

    def hist2d(self, x, y, bins=10, cmap="Blues"):
        h, xe, ye = np.histogram2d(x, y, bins=bins)
        self.artists.append(Artist("mesh", counts=h, xedges=xe, yedges=ye, cmap=cmap,
                                   vmin=h.min(), vmax=h.max()))
        self._update_data(xe[[0, -1]], ye[[0, -1]])
        self.set_xlim(xe[0], xe[-1])
        self.set_ylim(ye[0], ye[-1])
        return h, xe, ye

    def scatter(self, x, y, s=None, alpha=None, color=None):
        off = np.column_stack([np.asarray(x, np.float64), np.asarray(y, np.float64)])
        rgb = to_rgb(color) if color is not None else hex_rgb(TAB10[self._patch_cycle % 10])
        self._patch_cycle += 1
        self.artists.append(Artist("scatter", offsets=off, s=float(s or MARKER_SIZE ** 2),
                                   alpha=alpha, color=rgb))
        self._update_data(off[:, 0], off[:, 1])

    def imshow(self, a, cmap="Blues", vmin=None, vmax=None):
        a = np.asarray(a)
        im = Artist("image", array=a, cmap=cmap, vmin=float(a.min() if vmin is None else vmin),
                    vmax=float(a.max() if vmax is None else vmax), axes=self)
        self.artists.append(im)
        n_r, n_c = a.shape[:2]
        self._update_data([-0.5, n_c - 0.5], [-0.5, n_r - 0.5])
        self.set_xlim(-0.5, n_c - 0.5)
        self.set_ylim(n_r - 0.5, -0.5)
        self.equal = True
        return im

    def add_patch(self, p: Rectangle):
        self.artists.append(Artist("rect", patch=p, color=to_rgb(p.edgecolor)))
        self._update_data([p.xy[0], p.xy[0] + p.width], [p.xy[1], p.xy[1] + p.height])

    # -- decorations
    def set_title(self, s, fontsize=None):
        self.title, self.title_size = str(s), float(fontsize or TITLE_SIZE)

    def set_xlabel(self, s, fontsize=None):
        self.xaxis.label, self.xaxis.label_fontsize = str(s), float(fontsize or FONT_SIZE)

    def set_ylabel(self, s, fontsize=None):
        self.yaxis.label, self.yaxis.label_fontsize = str(s), float(fontsize or FONT_SIZE)

    def get_xlabel(self):
        return self.xaxis.label

    def get_ylabel(self):
        return self.yaxis.label

    def get_title(self):
        return self.title

    def set_xlim(self, lo, hi):
        self._lim["x"] = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self._lim["y"] = (float(lo), float(hi))

    def _set_ticks(self, axis: _Axis, ticks):
        ticks = [float(t) for t in ticks]
        axis.fixed = ticks
        if ticks:
            self._grow[axis.name].append((min(ticks), max(ticks)))

    def set_xticks(self, ticks):
        self._set_ticks(self.xaxis, ticks)

    def set_yticks(self, ticks):
        self._set_ticks(self.yaxis, ticks)

    def set_xticklabels(self, labels, rotation=0, fontsize=None):
        self.xaxis.fixed_labels = [str(s) for s in labels]
        self.xaxis.rotation, self.xaxis.text_size = int(rotation), fontsize

    def set_yticklabels(self, labels, rotation=0, fontsize=None):
        self.yaxis.fixed_labels = [str(s) for s in labels]
        self.yaxis.rotation, self.yaxis.text_size = int(rotation), fontsize

    def tick_params(self, labelsize=None):
        if labelsize is not None:
            self.xaxis.label_size = self.yaxis.label_size = float(labelsize)

    def grid(self, alpha=None):
        self.grid_alpha = 1.0 if alpha is None else float(alpha)

    def axis(self, mode: str):
        if mode != "off":
            raise NotImplementedError(f"axis({mode!r})")
        self.axison = False

    def legend(self, fontsize=None):
        self.legend_ = float(fontsize or FONT_SIZE)

    # -- limits
    def _autoscale(self, name: str) -> tuple:
        """autoscale_view's handle_single_axis for a linear axis with margins 0.05."""
        d = self._data[:2] if name == "x" else self._data[2:]
        x0, x1 = (d[0], d[1]) if math.isfinite(d[0]) else (-math.inf, math.inf)
        x0, x1 = nonsingular(x0, x1, expander=0.05)
        st = np.sort(np.asarray(self._sticky[name], np.float64))
        tol = 1e-5 * max(abs(x0), abs(x1), abs(x1 - x0))
        i0 = st.searchsorted(x0 + tol) - 1
        b0 = st[i0] if i0 != -1 else None
        i1 = st.searchsorted(x1 - tol)
        b1 = st[i1] if i1 != len(st) else None
        delta = (x1 - x0) * MARGIN
        if not np.isfinite(delta):
            delta = 0
        x0, x1 = x0 - delta, x1 + delta
        if b0 is not None:
            x0 = max(x0, b0)
        if b1 is not None:
            x1 = min(x1, b1)
        return nonsingular(x0, x1)

    def _limits(self, name: str) -> tuple:
        lo, hi = self._lim[name] if self._lim[name] is not None else \
            self._autoscale(name) if self._scaled else (0.0, 1.0)
        for a, b in self._grow[name]:
            if lo < hi:
                lo, hi = min(a, b, lo), max(a, b, hi)
            else:
                lo, hi = max(a, b, lo), min(a, b, hi)
        return lo, hi

    def get_xlim(self):
        return self._limits("x")

    def get_ylim(self):
        return self._limits("y")

    # -- ticks
    def _tick_space(self, axis: _Axis) -> int:
        fw, fh = self.fig.figsize
        length = (self.active[2] * fw if axis.name == "x" else self.active[3] * fh) * 72
        return int(np.floor(length / (axis.label_size * (3 if axis.name == "x" else 2))))

    def ticks(self, axis: _Axis) -> tuple:
        """(locations, label strings, offset text) of an axis as it stands."""
        if not axis.on:
            return np.zeros(0), [], ""
        lo, hi = self._limits(axis.name)
        if axis.fixed is not None:
            locs = np.asarray(axis.fixed, np.float64)
            labels = list(axis.fixed_labels or [])[:len(locs)]
            if axis.fixed_labels is None:
                return (locs,) + scalar_labels(locs, lo, hi)
            return locs, labels + [""] * (len(locs) - len(labels)), ""
        locs = auto_ticks(lo, hi, self._tick_space(axis))
        return (locs,) + scalar_labels(locs, lo, hi)

    # -- geometry (y up, figure fractions)
    def _apply_aspect(self):
        l, b, w, h = self.orig
        fw, fh = self.fig.figsize
        fig_aspect = fh / fw
        if self.equal:
            (x0, x1), (y0, y1) = self._limits("x"), self._limits("y")
            box_aspect = abs(y1 - y0) / abs(x1 - x0)
        elif self.box_aspect is not None:
            box_aspect = self.box_aspect
        else:
            self.active = self.orig
            return
        H = w * box_aspect / fig_aspect
        if H <= h:
            W = w
        else:
            W, H = h * fig_aspect / box_aspect, h
        cx, cy = self.anchor
        self.active = (l + cx * (w - W), b + cy * (h - H), W, H)

    def _tight_box(self, dpi: float) -> tuple:
        """matplotlib's get_tightbbox(for_layout_only=True) in pixels at `dpi` (x0, y0, x1,
        y1; y up): the axes box, tick labels, axis labels (collapsed along their axis),
        title (collapsed) and offset texts."""
        W, H = self.fig.figsize[0] * dpi, self.fig.figsize[1] * dpi
        l, b, w, h = self.active
        bx0, by0, bx1, by1 = l * W, b * H, (l + w) * W, (b + h) * H
        boxes = [(bx0, by0, bx1, by1)]
        if self.axison:
            for axis in (self.xaxis, self.yaxis):
                boxes += self._axis_boxes(axis, dpi, (bx0, by0, bx1, by1))
        if self.title:
            tw, th, td = text_extent(self.title, self.title_size, dpi)
            base = by1 + TITLE_PAD * dpi / 72
            c = (bx0 + bx1) / 2
            boxes.append((c - 0.5, base - td, c + 0.5, base - td + th))
        x0 = min(bb[0] for bb in boxes)
        y0 = min(bb[1] for bb in boxes)
        return x0, y0, max(bb[2] for bb in boxes), max(bb[3] for bb in boxes)

    def _tick_label_boxes(self, axis: _Axis, dpi: float, box: tuple) -> list:
        """((x0, y0, x1, y1), text, anchor point) of each drawn tick label, pixels y up."""
        bx0, by0, bx1, by1 = box
        locs, labels, _ = self.ticks(axis)
        lo, hi = self._limits(axis.name)
        size = axis.text_size or axis.label_size
        out = []
        pad = (TICK_SIZE + TICK_PAD) * dpi / 72
        for v, s in zip(locs, labels):
            if not _contains_close(lo, hi, v) or not s:
                continue
            tw, th, td = text_extent(s, size, dpi)
            f = (v - lo) / (hi - lo)
            if axis.name == "x":
                x = bx0 + f * (bx1 - bx0)
                top = by0 - pad
                w_, h_ = (th, tw) if axis.rotation == 90 else (tw, th)
                out.append(((x - w_ / 2, top - h_, x + w_ / 2, top), s, (x, top)))
            else:
                y = by0 + f * (by1 - by0)
                y_lo, y_hi = y - (th - td) / 2 - td, y + (th - td) / 2
                if axis.side == "right":
                    out.append(((bx1 + pad, y_lo, bx1 + pad + tw, y_hi), s, (bx1 + pad, y)))
                else:
                    out.append(((bx0 - pad - tw, y_lo, bx0 - pad, y_hi), s, (bx0 - pad, y)))
        return out

    def _axis_boxes(self, axis: _Axis, dpi: float, box: tuple) -> list:
        bx0, by0, bx1, by1 = box
        tl = [b for b, _, _ in self._tick_label_boxes(axis, dpi, box)]
        out = list(tl)
        _, _, offset = self.ticks(axis)
        if axis.name == "x":
            bottom = min([b[1] for b in tl] + [by0])
            if axis.label:
                tw, th, td = text_extent(axis.label, axis.label_fontsize, dpi)
                top = bottom - LABEL_PAD * dpi / 72
                c = (bx0 + bx1) / 2
                out.append((c - 0.5, top - th, c + 0.5, top))
            if offset:
                tw, th, td = text_extent(offset, axis.label_size, dpi)
                top = bottom - OFFSET_PAD * dpi / 72
                out.append((bx1 - tw, top - th, bx1, top))
        else:
            if axis.side == "right":
                right = max([b[2] for b in tl] + [bx1])
            left = min([b[0] for b in tl] + [bx0])
            if axis.label:
                tw, th, td = text_extent(axis.label, axis.label_fontsize, dpi)
                x1 = left - LABEL_PAD * dpi / 72
                c = (by0 + by1) / 2
                out.append((x1 - th, c - 0.5, x1, c + 0.5))
            if offset:
                tw, th, td = text_extent(offset, axis.label_size, dpi)
                base = max([b[3] for b in tl] + [by1]) + OFFSET_PAD * dpi / 72
                out.append((bx0, base - td, bx0 + tw, base - td + th))
        return out


class Figure:
    """A figure of `figsize` inches; `savefig` renders it at `dpi` and writes it by the
    file's suffix (`data/imageio.py::imwrite`: .png, or .jpg at quality 95)."""

    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.axes: list[Axes] = []
        self.shape = (1, 1)
        self.pars = SUBPLOT
        self.colorbars = []   # (parent axes, colorbar axes, image)

    # -- the grid
    def _grid(self, pars) -> list:
        """Per cell (row, col) of the subplot grid: (left, bottom, width, height)."""
        rows, cols = self.shape
        left, right, bottom, top, wspace, hspace = pars
        cell_h = (top - bottom) / (rows + hspace * (rows - 1))
        cell_w = (right - left) / (cols + wspace * (cols - 1))
        return {(r, c): (left + c * cell_w * (1 + wspace),
                         top - r * cell_h * (1 + hspace) - cell_h, cell_w, cell_h)
                for r in range(rows) for c in range(cols)}

    def _place(self, pars):
        cells = self._grid(pars)
        for ax in self.axes:
            ax.orig = cells[ax.cell]
        for parent, cax, _ in self.colorbars:  # the colorbar's grid in the parent's cell
            l, b, w, h = cells[parent.cell]
            ws = 2 * 0.05 / (1 - 0.05)
            cell_w = w / (2 + ws)
            norm = cell_w * 2 / 0.95
            parent.orig = (l, b, 0.8 * norm, h)
            cax.orig = (l + 0.8 * norm + ws * cell_w, b, 0.15 * norm, h)
        for ax in self.axes:
            ax._apply_aspect()

    def colorbar(self, im: Artist):
        parent = im.axes
        cax = Axes(self, parent.cell)
        cax.box_aspect, cax.anchor, parent.anchor = 20.0, (0.0, 0.5), (1.0, 0.5)
        cax.set_xlim(0, 1)
        cax.set_ylim(im.vmin, im.vmax)
        cax.xaxis.on = False
        cax.yaxis.side = "right"
        cax.colorbar_of = im
        self.axes.append(cax)
        self.colorbars.append((parent, cax, im))
        return cax

    def tight_layout(self):
        """matplotlib's tight_layout: the margins and spacings that fit each cell's
        decorations measured at the current placement, with a pad of 1.08 font sizes."""
        self._place(self.pars)
        rows, cols = self.shape
        dpi = LAYOUT_DPI
        fw, fh = self.figsize
        W, H = fw * dpi, fh * dpi
        vspaces, hspaces = np.zeros((rows + 1, cols)), np.zeros((rows, cols + 1))
        cells = self._grid(self.pars)
        for (r, c), cb in cells.items():
            members = [ax for ax in self.axes if ax.cell == (r, c)]
            if not members:
                continue
            tb = [ax._tight_box(dpi) for ax in members]
            tx0, ty0 = min(t[0] for t in tb) / W, min(t[1] for t in tb) / H
            tx1, ty1 = max(t[2] for t in tb) / W, max(t[3] for t in tb) / H
            l, b, w, h = cb
            hspaces[r, c] += l - tx0
            hspaces[r, c + 1] += tx1 - (l + w)
            vspaces[r, c] += ty1 - (b + h)
            vspaces[r + 1, c] += b - ty0
        pad = LAYOUT_PAD * FONT_SIZE / 72
        ml = max(hspaces[:, 0].max(), 0) + pad / fw
        mr = max(hspaces[:, -1].max(), 0) + pad / fw
        mt = max(vspaces[0, :].max(), 0) + pad / fh
        mb = max(vspaces[-1, :].max(), 0) + pad / fh
        if ml + mr >= 1 or mb + mt >= 1:
            return
        left, right, bottom, top = ml, 1 - mr, mb, 1 - mt
        wspace, hspace = self.pars[4:]
        if cols > 1:
            hs = hspaces[:, 1:-1].max() + pad / fw
            h_axes = (1 - mr - ml - hs * (cols - 1)) / cols
            if h_axes < 0:
                return
            wspace = hs / h_axes
        if rows > 1:
            vs = vspaces[1:-1, :].max() + pad / fh
            v_axes = (1 - mt - mb - vs * (rows - 1)) / rows
            if v_axes < 0:
                return
            hspace = vs / v_axes
        self.pars = (left, right, bottom, top, wspace, hspace)
        self._place(self.pars)

    # -- rendering
    def render(self, dpi: float = 120.0) -> np.ndarray:
        """The figure as a (H, W, 3) uint8 RGB image at `dpi`."""
        self._place(self.pars)
        W, H = int(round(self.figsize[0] * dpi)), int(round(self.figsize[1] * dpi))
        canvas = np.ones((H, W, 3), np.float32)
        for ax in self.axes:
            _draw_axes(canvas, ax, dpi)
        self.pixels = np.rint(canvas * 255).astype(np.uint8)
        self.dpi = dpi
        return self.pixels

    def savefig(self, path, dpi: float = 120.0):
        rgb = self.render(dpi)
        imwrite(Path(path), np.ascontiguousarray(rgb[..., ::-1]))
        return path

    def to_pixels(self, ax: Axes, x, y) -> tuple:
        """Pixel coordinates (columns, rows; rows down) of data points of `ax` in the last
        render."""
        return _transform(ax, self.dpi, np.asarray(x, np.float64), np.asarray(y, np.float64),
                          self.pixels.shape[1], self.pixels.shape[0])


def subplots(nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8), squeeze: bool = True):
    """(figure, axes): the axes as a nested list [row][col] (squeeze=False), a single
    Axes for 1 x 1 with squeeze."""
    fig = Figure(figsize)
    fig.shape = (nrows, ncols)
    grid = [[Axes(fig, (r, c)) for c in range(ncols)] for r in range(nrows)]
    fig.axes = [a for row in grid for a in row]
    fig._place(fig.pars)
    if squeeze and nrows == ncols == 1:
        return fig, grid[0][0]
    return fig, grid


# ---- drawing ----------------------------------------------------------------------------------

def _transform(ax: Axes, dpi, x, y, W: int, H: int) -> tuple:
    l, b, w, h = ax.active
    (x0, x1), (y0, y1) = ax._limits("x"), ax._limits("y")
    px = (l + (x - x0) / (x1 - x0) * w) * W
    py = H - (b + (y - y0) / (y1 - y0) * h) * H
    return px, py


def _box_px(ax: Axes, W: int, H: int) -> tuple:
    """(c0, r0, c1, r1) pixel edges of the axes box, rows down."""
    l, b, w, h = ax.active
    return l * W, H - (b + h) * H, (l + w) * W, H - b * H


def _clip_range(lo: float, hi: float, n: int) -> tuple:
    """Indices of the pixels whose centres lie in [lo, hi)."""
    return max(int(math.ceil(lo - 0.5)), 0), min(int(math.ceil(hi - 0.5)), n)


def _composite(region: np.ndarray, mask: np.ndarray, rgb, alpha) -> None:
    a = 1.0 if alpha is None else float(alpha)
    c = np.asarray(rgb, np.float32)
    region[mask] = a * c + (1 - a) * region[mask]


def _fill_rect(canvas, c0, r0, c1, r1, rgb, alpha=None, clip=None):
    if clip is not None:
        c0, r0, c1, r1 = max(c0, clip[0]), max(r0, clip[1]), min(c1, clip[2]), min(r1, clip[3])
    j0, j1 = _clip_range(c0, c1, canvas.shape[1])
    i0, i1 = _clip_range(r0, r1, canvas.shape[0])
    if j1 > j0 and i1 > i0:
        region = canvas[i0:i1, j0:j1]
        _composite(region, np.ones(region.shape[:2], bool), rgb, alpha)


def _stroke_mask(shape, xs, ys, half: float, clip) -> tuple:
    """(row slice, col slice, mask) of the pixels within `half` of the polyline, inside
    `clip` (c0, r0, c1, r1)."""
    ok = np.isfinite(xs) & np.isfinite(ys)
    c0, r0, c1, r1 = clip
    if ok.any():  # the polyline's own box within the clip
        c0, c1 = max(c0, xs[ok].min() - half - 1), min(c1, xs[ok].max() + half + 1)
        r0, r1 = max(r0, ys[ok].min() - half - 1), min(r1, ys[ok].max() + half + 1)
    j0, j1 = _clip_range(c0, c1, shape[1])
    i0, i1 = _clip_range(r0, r1, shape[0])
    mask = np.zeros((max(i1 - i0, 0), max(j1 - j0, 0)), bool)
    for k in range(len(xs) - 1):
        if not (ok[k] and ok[k + 1]):
            continue
        ax_, ay, bx, by = xs[k], ys[k], xs[k + 1], ys[k + 1]
        ja, jb = _clip_range(min(ax_, bx) - half, max(ax_, bx) + half + 1, shape[1])
        ia, ib = _clip_range(min(ay, by) - half, max(ay, by) + half + 1, shape[0])
        ja, jb, ia, ib = max(ja, j0), min(jb, j1), max(ia, i0), min(ib, i1)
        if jb <= ja or ib <= ia:
            continue
        cx = np.arange(ja, jb) + 0.5
        cy = (np.arange(ia, ib) + 0.5)[:, None]
        dx, dy = bx - ax_, by - ay
        ll = dx * dx + dy * dy
        t = np.clip(((cx - ax_) * dx + (cy - ay) * dy) / ll, 0, 1) if ll > 0 else 0.0
        d2 = (cx - ax_ - t * dx) ** 2 + (cy - ay - t * dy) ** 2
        mask[ia - i0:ib - i0, ja - j0:jb - j0] |= d2 <= half * half
    return slice(i0, i1), slice(j0, j1), mask


def _stroke(canvas, xs, ys, lw_px: float, rgb, alpha, clip):
    rs, cs, mask = _stroke_mask(canvas.shape, np.asarray(xs, np.float64),
                                np.asarray(ys, np.float64), max(lw_px / 2, 0.5), clip)
    _composite(canvas[rs, cs], mask, rgb, alpha)


def _disc_offsets(r: float) -> np.ndarray:
    k = int(math.ceil(r)) + 1
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    keep = dx * dx + dy * dy <= max(r, 0.5) ** 2
    return np.column_stack([dy[keep], dx[keep]])


def _stamp_counts(shape, xs, ys, r: float, clip) -> np.ndarray:
    """How many discs of radius r at (xs, ys) cover each pixel inside `clip`."""
    counts = np.zeros(shape[:2], np.int32)
    ok = np.isfinite(xs) & np.isfinite(ys)
    ci, cj = np.floor(ys[ok]).astype(np.int64), np.floor(xs[ok]).astype(np.int64)
    i0, i1 = _clip_range(clip[1], clip[3], shape[0])
    j0, j1 = _clip_range(clip[0], clip[2], shape[1])
    for di, dj in _disc_offsets(r):
        i, j = ci + di, cj + dj
        keep = (i >= i0) & (i < i1) & (j >= j0) & (j < j1)
        np.add.at(counts, (i[keep], j[keep]), 1)
    return counts


def _draw_text(canvas, s: str, x: float, y: float, size: float, dpi: float, ha: str, va: str,
               rotation: int = 0, rgb=(0.0, 0.0, 0.0)):
    """Text at pixel (x, y) (rows down), aligned by ha ('left', 'center', 'right') and va
    ('top', 'bottom', 'center', 'baseline'), the box measured as matplotlib lays it out;
    rotation 90 turns it counter-clockwise."""
    if not s:
        return
    mask, x_left, base = _text_mask(s, size, dpi, rotation)
    tw, th, td = text_extent(s, size, dpi)
    hw = _hershey_width(s.replace(MINUS, "-"), _hershey_scale(size, dpi))
    if rotation == 90:  # the box is (th wide, tw tall); the baseline runs up its right side
        w_box, h_box = th, tw
        x_box = x - {"left": 0, "center": w_box / 2, "right": w_box}[ha]
        y_box = y - {"top": 0, "center": h_box / 2, "bottom": h_box}.get(va, 0)
        # the mask's columns: patch rows turned; baseline column = base
        c0 = int(round(x_box + (th - td) - base))
        r0 = int(round(y_box + (h_box - hw) / 2 - (mask.shape[0] - x_left - hw)))
    else:
        x_box = x - {"left": 0, "center": hw / 2, "right": hw}[ha]
        base_y = {"top": y + (th - td), "bottom": y - td, "baseline": y,
                  "center": y + (th - td) / 2, "center_baseline": y + (th - td) / 2}[va]
        c0, r0 = int(round(x_box - x_left)), int(round(base_y - base))
    h, w = mask.shape
    i0, j0 = max(r0, 0), max(c0, 0)
    i1, j1 = min(r0 + h, canvas.shape[0]), min(c0 + w, canvas.shape[1])
    if i1 > i0 and j1 > j0:
        _composite(canvas[i0:i1, j0:j1], mask[i0 - r0:i1 - r0, j0 - c0:j1 - c0], rgb, None)


def _cells(canvas, ax: Axes, W: int, H: int, xedges, yedges, colors: np.ndarray, clip):
    """Fill a mesh of cells (colors (ny, nx, 3) uint8, row k between yedges[k], [k+1])."""
    c0, r0, c1, r1 = clip
    j0, j1 = _clip_range(c0, c1, W)
    i0, i1 = _clip_range(r0, r1, H)
    if j1 <= j0 or i1 <= i0:
        return
    (x0, x1), (y0, y1) = ax._limits("x"), ax._limits("y")
    l, b, w, h = ax.active
    xs = x0 + ((np.arange(j0, j1) + 0.5) / W - l) / w * (x1 - x0)
    ys = y0 + ((H - (np.arange(i0, i1) + 0.5)) / H - b) / h * (y1 - y0)
    ix = np.searchsorted(xedges, xs, side="right") - 1
    iy = np.searchsorted(yedges, ys, side="right") - 1
    okx = (ix >= 0) & (ix < len(xedges) - 1)
    oky = (iy >= 0) & (iy < len(yedges) - 1)
    region = canvas[i0:i1, j0:j1]
    sel = oky[:, None] & okx[None, :]
    vals = colors[np.clip(iy, 0, colors.shape[0] - 1)[:, None],
                  np.clip(ix, 0, colors.shape[1] - 1)[None, :]].astype(np.float32) / 255
    region[sel] = vals[sel]


def _norm(v, vmin, vmax) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return np.zeros_like(v) if vmin == vmax else (v - vmin) / (vmax - vmin)


def _draw_axes(canvas: np.ndarray, ax: Axes, dpi: float):
    H, W = canvas.shape[:2]
    box = _box_px(ax, W, H)
    pt = dpi / 72
    cbar = getattr(ax, "colorbar_of", None)
    if cbar is not None:  # the colormap's 256 bands, bottom to top
        edges = np.linspace(cbar.vmin, cbar.vmax, CMAP_N + 1)
        colors = CMAPS[cbar.cmap][None, :, :]
        c0, r0, c1, r1 = box
        (y0, y1) = ax._limits("y")
        i0, i1 = _clip_range(r0, r1, H)
        j0, j1 = _clip_range(c0, c1, W)
        ys = y0 + (r1 - (np.arange(i0, i1) + 0.5)) / (r1 - r0) * (y1 - y0)
        k = np.clip(np.searchsorted(edges, ys, side="right") - 1, 0, CMAP_N - 1)
        canvas[i0:i1, j0:j1] = (colors[0, k][:, None, :] / 255).astype(np.float32)
    order = {"image": 0, "bars": 1, "rect": 1, "mesh": 1, "scatter": 1, "line": 2}
    arts = sorted(ax.artists, key=lambda a: order[a.kind])  # stable: insertion order
    for art in (a for a in arts if order[a.kind] < 2):
        _draw_artist(canvas, ax, art, box, dpi, W, H)
    if ax.grid_alpha is not None and ax.axison:
        for axis in (ax.xaxis, ax.yaxis):
            locs, _, _ = ax.ticks(axis)
            lo, hi = ax._limits(axis.name)
            for v in locs:
                if not _contains_close(lo, hi, v):
                    continue
                if axis.name == "x":
                    px, _ = _transform(ax, dpi, np.array([v]), np.array([0.0]), W, H)
                    _stroke(canvas, [px[0], px[0]], [box[1], box[3]], GRID_WIDTH * pt,
                            GRID_COLOR, ax.grid_alpha, box)
                else:
                    _, py = _transform(ax, dpi, np.array([0.0]), np.array([v]), W, H)
                    _stroke(canvas, [box[0], box[2]], [py[0], py[0]], GRID_WIDTH * pt,
                            GRID_COLOR, ax.grid_alpha, box)
    for art in (a for a in arts if order[a.kind] == 2):
        _draw_artist(canvas, ax, art, box, dpi, W, H)
    if ax.axison:
        _draw_frame(canvas, ax, box, dpi, W, H)
    if ax.legend_ is not None:
        _draw_legend(canvas, ax, box, dpi, W, H)
    if ax.title:
        _draw_text(canvas, ax.title, (box[0] + box[2]) / 2, box[1] - TITLE_PAD * pt,
                   ax.title_size, dpi, "center", "baseline")


def _draw_artist(canvas, ax: Axes, art: Artist, box, dpi, W, H):
    pt = dpi / 72
    if art.kind == "image":
        a = _norm(art.array, art.vmin, art.vmax)
        colors = CMAPS[art.cmap][cmap_index(a)]
        n_r, n_c = a.shape
        _cells(canvas, ax, W, H, np.arange(n_c + 1) - 0.5, np.arange(n_r + 1) - 0.5,
               colors, box)
    elif art.kind == "mesh":
        colors = CMAPS[art.cmap][cmap_index(_norm(art.counts.T, art.vmin, art.vmax))]
        _cells(canvas, ax, W, H, art.xedges, art.yedges, colors, box)
    elif art.kind == "bars":
        for x, y, w, h, c in zip(art.x, art.y, art.w, art.h, art.colors):
            px, py = _transform(ax, dpi, np.array([x, x + w]), np.array([y, y + h]), W, H)
            _fill_rect(canvas, px.min(), py.min(), px.max(), py.max(), c, None, box)
    elif art.kind == "rect":
        p = art.patch
        x, y = p.xy
        px, py = _transform(ax, dpi, np.array([x, x + p.width, x + p.width, x, x]),
                            np.array([y, y, y + p.height, y + p.height, y]), W, H)
        _stroke(canvas, px, py, p.lw * pt, art.color, p.alpha, box)
    elif art.kind == "scatter":
        px, py = _transform(ax, dpi, art.offsets[:, 0], art.offsets[:, 1], W, H)
        counts = _stamp_counts(canvas.shape, px, py, math.sqrt(art.s) * pt / 2, box)
        a = 1.0 if art.alpha is None else art.alpha
        keep = 1 - (1 - a) ** counts[..., None].astype(np.float32)
        c = np.asarray(art.color, np.float32)
        canvas[:] = np.where(counts[..., None] > 0, keep * c + (1 - keep) * canvas, canvas)
    elif art.kind == "line":
        px, py = _transform(ax, dpi, np.asarray(art.x, np.float64),
                            np.asarray(art.y, np.float64), W, H)
        _stroke(canvas, px, py, art.lw * pt, art.color, art.alpha, box)
        if art.marker == ".":
            r = MARKER_SIZE * 0.5 * pt / 2
            rs, cs, mask = _stroke_mask(canvas.shape, px, py, 0.0, box)  # the markers' box
            rs = slice(max(rs.start - 2, 0), rs.stop + 2)
            cs = slice(max(cs.start - 2, 0), cs.stop + 2)
            counts = _stamp_counts(canvas.shape, px, py, r, box)[rs, cs]
            _composite(canvas[rs, cs], counts > 0, art.color, art.alpha)


def _draw_frame(canvas, ax: Axes, box, dpi, W, H):
    """Spines, ticks, tick labels, offset texts and axis labels."""
    pt = dpi / 72
    c0, r0, c1, r1 = box
    half = SPINE_WIDTH * pt / 2
    full = (0, 0, W, H)
    for x0, y0, x1, y1 in ((c0, r0, c1, r0), (c0, r1, c1, r1), (c0, r0, c0, r1),
                           (c1, r0, c1, r1)):
        _fill_rect(canvas, min(x0, x1) - half, min(y0, y1) - half, max(x0, x1) + half,
                   max(y0, y1) + half, (0.0, 0.0, 0.0), None, full)
    lay = (c0, H - r1, c1, H - r0)  # y up
    for axis in (ax.xaxis, ax.yaxis):
        if not axis.on:
            continue
        size = axis.text_size or axis.label_size
        tl = ax._tick_label_boxes(axis, dpi, lay)
        for (bx0, by0, bx1, by1), s, (x, y) in tl:
            if axis.name == "x":
                _fill_rect(canvas, x - half, r1, x + half, r1 + TICK_SIZE * pt,
                           (0.0, 0.0, 0.0), None, full)
                _draw_text(canvas, s, x, H - y, size, dpi, "center", "top", axis.rotation)
            else:
                yy = H - y
                if axis.side == "right":
                    _fill_rect(canvas, c1, yy - half, c1 + TICK_SIZE * pt, yy + half,
                               (0.0, 0.0, 0.0), None, full)
                    _draw_text(canvas, s, x, yy, size, dpi, "left", "center_baseline")
                else:
                    _fill_rect(canvas, c0 - TICK_SIZE * pt, yy - half, c0, yy + half,
                               (0.0, 0.0, 0.0), None, full)
                    _draw_text(canvas, s, x, yy, size, dpi, "right", "center_baseline")
        boxes = [b for b, _, _ in tl]
        _, _, offset = ax.ticks(axis)
        if axis.name == "x":
            bottom = H - min([b[1] for b in boxes] + [lay[1]])
            if axis.label:
                _draw_text(canvas, axis.label, (c0 + c1) / 2, bottom + LABEL_PAD * pt,
                           axis.label_fontsize, dpi, "center", "top")
            if offset:
                _draw_text(canvas, offset, c1, bottom + OFFSET_PAD * pt, axis.label_size, dpi,
                           "right", "top")
        else:
            left = min([b[0] for b in boxes] + [lay[0]])
            if axis.label:
                _draw_text(canvas, axis.label, left - LABEL_PAD * pt, (r0 + r1) / 2,
                           axis.label_fontsize, dpi, "right", "center", 90)
            if offset:
                top = H - max([b[3] for b in boxes] + [lay[3]])
                _draw_text(canvas, offset, c0, top - OFFSET_PAD * pt, axis.label_size, dpi,
                           "left", "baseline")


_LEGEND_ANCHORS = {1: (1, 1), 2: (0, 1), 3: (0, 0), 4: (1, 0), 5: (1, 0.5), 6: (0, 0.5),
                   7: (1, 0.5), 8: (0.5, 0), 9: (0.5, 1), 10: (0.5, 0.5)}


def _segments_hit(xs, ys, x0, y0, x1, y1) -> bool:
    """Whether a polyline (pixel coordinates) passes through the box."""
    for k in range(len(xs) - 1):
        ax_, ay, bx, by = xs[k], ys[k], xs[k + 1], ys[k + 1]
        if not np.isfinite([ax_, ay, bx, by]).all():
            continue
        if max(ax_, bx) < x0 or min(ax_, bx) > x1 or max(ay, by) < y0 or min(ay, by) > y1:
            continue
        dx, dy = bx - ax_, by - ay
        corners = [(x0, y0), (x1, y0), (x0, y1), (x1, y1)]
        sides = [dx * (cy - ay) - dy * (cx - ax_) for cx, cy in corners]
        if min(sides) <= 0 <= max(sides):
            return True
    return False


def _draw_legend(canvas, ax: Axes, box, dpi, W, H):
    """The legend of the labelled lines: loc 'best' (the first of matplotlib's nine
    places, upper right first, that covers the fewest line vertices and crossings)."""
    lines = [a for a in ax.artists if a.kind == "line" and a.label]
    if not lines:
        return
    f = ax.legend_ * dpi / 72
    exts = [text_extent(a.label, ax.legend_, dpi) for a in lines]
    th = max(e[1] for e in exts)
    bw = 0.4 * f * 2 + 2.0 * f + 0.8 * f + max(e[0] for e in exts)
    bh = 0.4 * f * 2 + len(lines) * th + (len(lines) - 1) * 0.5 * f
    c0, r0, c1, r1 = box
    pad = 0.5 * f
    pts = [_transform(ax, dpi, np.asarray(a.x, np.float64), np.asarray(a.y, np.float64), W, H)
           for a in ax.artists if a.kind == "line"]
    best = None
    for code in range(1, 11):
        cx, cy = _LEGEND_ANCHORS[code]
        lx = c0 + pad + cx * (c1 - c0 - 2 * pad - bw)
        ty = r1 - pad - cy * (r1 - r0 - 2 * pad - bh) - bh
        bad = sum(int(((px > lx) & (px < lx + bw) & (py > ty) & (py < ty + bh)).sum()) +
                  _segments_hit(px, py, lx, ty, lx + bw, ty + bh) for px, py in pts)
        if best is None or bad < best[0]:
            best = (bad, lx, ty)
        if bad == 0:
            break
    _, lx, ty = best
    ax.legend_box = (lx, ty, lx + bw, ty + bh)
    _fill_rect(canvas, lx, ty, lx + bw, ty + bh, (1.0, 1.0, 1.0), 0.8, (0, 0, W, H))
    _stroke(canvas, [lx, lx + bw, lx + bw, lx, lx], [ty, ty, ty + bh, ty + bh, ty],
            1.0 * dpi / 72, (0.8, 0.8, 0.8), None, (0, 0, W, H))
    y = ty + 0.4 * f
    for a, (tw, h_, d) in zip(lines, exts):
        mid = y + th / 2
        x = lx + 0.4 * f
        _stroke(canvas, [x, x + 2.0 * f], [mid, mid], a.lw * dpi / 72, a.color, a.alpha,
                (0, 0, W, H))
        _draw_text(canvas, a.label, x + 2.8 * f, mid, ax.legend_, dpi, "left",
                   "center_baseline")
        y += th + 0.5 * f
