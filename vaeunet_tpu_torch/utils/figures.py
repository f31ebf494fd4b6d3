"""Figures of the analysis: matplotlib where it is installed, else a small
PIL renderer of the same calls.  New in the port: the JAX package draws
with matplotlib, which the card's machine does not have, while PIL is
there.  :func:`pyplot`, :func:`gridspec` and :func:`colormap` return
matplotlib's objects when it imports, and this module's otherwise; the
renderer in use is logged once.

The renderer covers the calls that ``analysis/plots.py``,
``analysis/visualize.py``, ``uncertainty.py`` and the CLIs make: grids of
axes (``subplots``, ``subplot``, ``GridSpec``), ``twinx``, ``plot``,
``scatter``, ``bar``, ``hist``, ``fill_between``, ``boxplot``, ``axhline``,
``imshow`` (gray, hot, viridis), titles, axis labels, limits and a legend.
It draws each axes' data, frame, end ticks and text at up to 100 dpi;
options it has no use for (grid, tick rotation, colorbars, layout) are
accepted and ignored.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_RENDERER_LOGGED = []


def _matplotlib():
    try:
        import matplotlib
    except ImportError:
        if not _RENDERER_LOGGED:
            log.info("matplotlib is not installed: figures are drawn by the PIL renderer of "
                     "vaeunet_tpu_torch.utils.figures")
            _RENDERER_LOGGED.append(True)
        return None
    matplotlib.use("Agg")
    return matplotlib


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or the PIL renderer."""
    if _matplotlib() is None:
        return LITE
    import matplotlib.pyplot as plt
    return plt


def gridspec():
    """``matplotlib.gridspec``, or the PIL renderer's."""
    if _matplotlib() is None:
        return LITE
    from matplotlib import gridspec as gs
    return gs


def colormap(name: str):
    """A colormap: values in [0, 1] -> RGBA floats [..., 4]."""
    if _matplotlib() is not None:
        from matplotlib import colormaps
        return colormaps[name]
    return _Colormap(name)


# ----- the PIL renderer -----------------------------------------------------

# matplotlib's segment data for 'hot', and 'viridis' sampled at 17 points
_CMAPS = {
    "gray": ([0.0, 1.0], [[0, 1], [0, 1], [0, 1]]),
    "hot": (None, [([0, 0.365079, 1], [0.0416, 1, 1]),
                   ([0, 0.365079, 0.746032, 1], [0, 0, 1, 1]),
                   ([0, 0.746032, 1], [0, 0, 1])]),
    "viridis": (np.linspace(0, 1, 17).tolist(), [
        [0.267, 0.282, 0.279, 0.259, 0.230, 0.199, 0.173, 0.149, 0.128, 0.121, 0.158, 0.246,
         0.369, 0.516, 0.678, 0.846, 0.993],
        [0.005, 0.095, 0.175, 0.252, 0.322, 0.388, 0.449, 0.508, 0.567, 0.626, 0.684, 0.739,
         0.789, 0.831, 0.864, 0.887, 0.906],
        [0.329, 0.417, 0.483, 0.525, 0.546, 0.555, 0.558, 0.557, 0.551, 0.533, 0.502, 0.452,
         0.383, 0.294, 0.190, 0.100, 0.144]]),
}
_CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b"]
_SHORT = {"b": "blue", "g": "green", "r": "red", "k": "black", "c": "cyan", "m": "magenta",
          "y": "yellow", "w": "white"}
_DASH = {"-": None, "--": (6, 4), ":": (2, 3), "-.": (6, 3, 2, 3)}


class _Colormap:
    def __init__(self, name: str):
        if name not in _CMAPS:
            raise ValueError(f"colormap {name!r}: the PIL renderer has {sorted(_CMAPS)}")
        self.name = name

    def __call__(self, values) -> np.ndarray:
        v = np.clip(np.asarray(values, np.float64), 0, 1)
        xs, channels = _CMAPS[self.name]
        rgb = [np.interp(v, *c) if xs is None else np.interp(v, xs, c) for c in channels]
        return np.stack([*rgb, np.ones_like(v)], axis=-1)


def _rgb(color) -> Tuple[int, int, int]:
    from PIL import ImageColor
    if color is None:
        color = "black"
    if isinstance(color, (tuple, list, np.ndarray)):
        return tuple(int(round(float(c) * 255)) for c in color[:3])
    return ImageColor.getrgb(_SHORT.get(color, color))[:3]


def _fmt(fmt: str) -> Tuple[Optional[str], str]:
    """'k--' -> ('k', '--')."""
    color = fmt[0] if fmt and fmt[0] in _SHORT else None
    style = fmt[1:] if color else fmt
    return color, style or "-"


class _Axes:
    def __init__(self, figure: "_Figure", cell: Tuple[int, int, int, int],
                 twin_of: "Optional[_Axes]" = None):
        self.figure = figure
        self.cell = cell                      # rows, cols, row, col
        self.ops: List[tuple] = []
        self.title = self.xlabel = self.ylabel = ""
        self.xlim = self.ylim = None
        self.xticks: Optional[List[str]] = None
        self.visible = True
        self.legend_on = False
        self.entries: List[Tuple[str, Tuple[int, int, int]]] = []    # legend labels
        self.twin_of = twin_of
        self._next = 0

    def _color(self, color):
        if color is None:
            color = _CYCLE[self._next % len(_CYCLE)]
            self._next += 1
        return _rgb(color)

    def _x(self, x):
        arr = np.asarray(x)
        if arr.dtype.kind in "UO" and arr.size and isinstance(arr.reshape(-1)[0], str):
            self.xticks = [str(t) for t in arr.reshape(-1)]
            return np.arange(arr.size, dtype=np.float64)
        return arr.astype(np.float64).reshape(-1)

    def _entry(self, label, color):
        if label:
            self.entries.append((str(label), color))
        return color

    # data
    def plot(self, *args, color=None, label=None, marker=None, lw=None, linewidth=None,
             alpha=1.0, **_):
        fmt = args[-1] if args and isinstance(args[-1], str) else ""
        data = args[:-1] if fmt else args
        x, y = (np.arange(len(data[0])), data[0]) if len(data) == 1 else data[:2]
        fc, style = _fmt(fmt)
        self.ops.append(("line", self._x(x), np.asarray(y, np.float64).reshape(-1),
                         self._entry(label, self._color(color or fc)), style,
                         lw or linewidth or 1.5, alpha, marker))

    def scatter(self, x, y, s=20, color=None, alpha=1.0, label=None, **_):
        self.ops.append(("scatter", self._x(x), np.asarray(y, np.float64).reshape(-1),
                         self._entry(label, self._color(color)), float(s), alpha))

    def bar(self, x, height, width=0.8, color=None, alpha=1.0, label=None, **_):
        xs = self._x(x)
        colors = ([_rgb(c) for c in color] if isinstance(color, list) and len(color) == len(xs)
                  else [self._color(color)] * len(xs))
        self._entry(label, colors[0])
        self.ops.append(("bars", xs, np.asarray(height, np.float64).reshape(-1),
                         np.broadcast_to(np.asarray(width, np.float64), xs.shape), colors,
                         alpha))

    def hist(self, data, bins=10, density=False, color=None, alpha=1.0, label=None, **_):
        counts, edges = np.histogram(np.asarray(data, np.float64).reshape(-1), bins=bins,
                                     density=density)
        self.bar((edges[:-1] + edges[1:]) / 2, counts, width=np.diff(edges), color=color,
                 alpha=alpha, label=label)

    def fill_between(self, x, y1, y2, color=None, alpha=1.0, **_):
        self.ops.append(("fill", self._x(x), np.asarray(y1, np.float64).reshape(-1),
                         np.asarray(y2, np.float64).reshape(-1), self._color(color), alpha))

    def boxplot(self, data, tick_labels=None, **_):
        """Quartile boxes with 1.5 IQR whiskers; no fliers."""
        stats = []
        for d in data:
            d = np.asarray(d, np.float64).reshape(-1)
            q1, med, q3 = np.percentile(d, [25, 50, 75]) if d.size else (np.nan,) * 3
            iqr = q3 - q1
            inside = d[(d >= q1 - 1.5 * iqr) & (d <= q3 + 1.5 * iqr)] if d.size else d
            lo, hi = (inside.min(), inside.max()) if inside.size else (q1, q3)
            stats.append((q1, med, q3, lo, hi))
        if tick_labels is not None:
            self.xticks = list(tick_labels)
        self.ops.append(("box", np.arange(len(stats), dtype=np.float64), stats))

    def axhline(self, y=0.0, color=None, linestyle="-", alpha=1.0, label=None, lw=1.0, **_):
        self.ops.append(("hline", float(y), self._entry(label, _rgb(color)), linestyle, lw,
                         alpha))

    def imshow(self, image, cmap=None, **_):
        arr = np.asarray(image)
        if arr.ndim == 2:
            a = arr.astype(np.float64)
            lo, hi = float(a.min()), float(a.max())
            a = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
            arr = _Colormap(cmap or "viridis")(a)[..., :3]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr.astype(np.float64), 0, 1) * 255).astype(np.uint8)
        self.ops.append(("image", arr[..., :3]))
        return self

    # text, limits, switches
    def set_title(self, text, **_):
        self.title = str(text)

    def set_xlabel(self, text, **_):
        self.xlabel = str(text)

    def set_ylabel(self, text, **_):
        self.ylabel = str(text)

    def set_xlim(self, lo, hi=None):
        self.xlim = (float(lo), float(hi))

    def set_ylim(self, lo, hi=None):
        self.ylim = (float(lo), float(hi))

    def legend(self, *_, **__):
        self.legend_on = True

    def axis(self, mode):
        if mode == "off":
            self.visible = False

    def grid(self, *_, **__):
        pass

    def tick_params(self, *_, **__):
        pass

    def twinx(self) -> "_Axes":
        twin = _Axes(self.figure, self.cell, twin_of=self)
        self.figure.axes.append(twin)
        return twin

    # drawing
    def _limits(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        xs, ys = [], []
        for op in self.ops:
            kind = op[0]
            if kind in ("line", "scatter"):
                xs.append(op[1])
                ys.append(op[2])
            elif kind == "bars":
                xs += [op[1] - op[3] / 2, op[1] + op[3] / 2]
                ys += [op[2], np.zeros(1)]
            elif kind == "fill":
                xs.append(op[1])
                ys += [op[2], op[3]]
            elif kind == "box":
                xs.append(np.array([-0.5, len(op[2]) - 0.5]))
                ys += [np.array([s[3], s[4]]) for s in op[2]]
            elif kind == "hline":
                ys.append(np.array([op[1]]))

        def span(parts, given):
            if given is not None:
                return given
            v = np.concatenate([np.asarray(p, np.float64).reshape(-1) for p in parts]) \
                if parts else np.zeros(1)
            v = v[np.isfinite(v)]
            lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
            pad = (hi - lo) * 0.05 or 0.5
            return lo - pad, hi + pad

        xlim = self.twin_of._limits()[0] if self.twin_of is not None else span(xs, self.xlim)
        return xlim, span(ys, self.ylim)

    def draw(self, canvas, box: Tuple[int, int, int, int]) -> None:
        from PIL import Image, ImageDraw

        x0, y0, x1, y1 = box
        draw = ImageDraw.Draw(canvas)
        if self.title and self.twin_of is None:
            _text(draw, ((x0 + x1) // 2, y0 - 4), self.title, anchor="md")
        images = [op for op in self.ops if op[0] == "image"]
        if images:
            img = Image.fromarray(images[-1][1])
            scale = min((x1 - x0) / img.width, (y1 - y0) / img.height)
            img = img.resize((max(1, int(img.width * scale)), max(1, int(img.height * scale))),
                             Image.NEAREST)
            canvas.paste(img, (x0 + (x1 - x0 - img.width) // 2, y0 + (y1 - y0 - img.height) // 2))
            return
        if not self.ops and not self.visible:
            return
        (xa, xb), (ya, yb) = self._limits()

        def px(x):
            return x0 + (np.asarray(x, np.float64) - xa) / ((xb - xa) or 1.0) * (x1 - x0)

        def py(y):
            return y1 - (np.asarray(y, np.float64) - ya) / ((yb - ya) or 1.0) * (y1 - y0)

        layer = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
        for op in self.ops:
            kind = op[0]
            over = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
            d = ImageDraw.Draw(over)
            if kind == "line":
                _, x, y, color, style, width, alpha, marker = op
                pts = _polyline(px(x), py(y))
                _dashed(d, pts, _rgba(color, alpha), int(round(width)), _DASH.get(style))
                if marker:
                    for u, v in pts[:: max(1, len(pts) // 50)]:
                        d.ellipse([u - 3, v - 3, u + 3, v + 3], fill=_rgba(color, alpha))
            elif kind == "scatter":
                _, x, y, color, s, alpha = op
                r = max(1.5, np.sqrt(s) / 2)
                for u, v in zip(px(x), py(y)):
                    if np.isfinite(u) and np.isfinite(v):
                        d.ellipse([u - r, v - r, u + r, v + r], fill=_rgba(color, alpha))
            elif kind == "bars":
                _, x, h, w, colors, alpha = op
                for xi, hi, wi, c in zip(x, h, w, colors):
                    a, b = sorted((float(py(0)), float(py(hi))))
                    d.rectangle([float(px(xi - wi / 2)), a, float(px(xi + wi / 2)), b],
                                fill=_rgba(c, alpha))
            elif kind == "fill":
                _, x, ya_, yb_, color, alpha = op
                poly = _polyline(np.r_[px(x), px(x)[::-1]], np.r_[py(ya_), py(yb_)[::-1]])
                if len(poly) > 2:
                    d.polygon(poly, fill=_rgba(color, alpha))
            elif kind == "box":
                for xi, (q1, med, q3, lo, hi) in zip(op[1], op[2]):
                    u0, u1, uc = float(px(xi - 0.25)), float(px(xi + 0.25)), float(px(xi))
                    d.rectangle([u0, float(py(q3)), u1, float(py(q1))], outline=(0, 0, 0, 255))
                    d.line([u0, float(py(med)), u1, float(py(med))], fill=(255, 127, 14, 255),
                           width=2)
                    d.line([uc, float(py(q3)), uc, float(py(hi))], fill=(0, 0, 0, 255))
                    d.line([uc, float(py(q1)), uc, float(py(lo))], fill=(0, 0, 0, 255))
            elif kind == "hline":
                _, y, color, style, width, alpha = op
                _dashed(d, [(x0, float(py(y))), (x1, float(py(y)))], _rgba(color, alpha),
                        int(round(width)), _DASH.get(style))
            layer = Image.alpha_composite(layer, over)
        inside = layer.crop((x0, y0, x1 + 1, y1 + 1))          # data outside the box is cut
        canvas.paste(inside, (x0, y0), inside)
        draw = ImageDraw.Draw(canvas)
        if not self.visible:
            return
        draw.rectangle([x0, y0, x1, y1], outline=(0, 0, 0))
        right = self.twin_of is not None
        for v, label in ((ya, f"{ya:.3g}"), (yb, f"{yb:.3g}")):
            _text(draw, (x1 + 4 if right else x0 - 4, float(py(v))), label,
                  anchor="lm" if right else "rm")
        if self.twin_of is None:
            if self.xticks is not None:
                for i, t in enumerate(self.xticks):
                    _text(draw, (float(px(i)), y1 + 4), str(t), anchor="ma")
            else:
                for v in (xa, xb):
                    _text(draw, (float(px(v)), y1 + 4), f"{v:.3g}", anchor="ma")
            _text(draw, ((x0 + x1) // 2, y1 + 18), self.xlabel, anchor="ma")
        if self.ylabel:
            _vertical_text(canvas, (x1 + 40 if right else x0 - 40, (y0 + y1) // 2), self.ylabel)
        if self.legend_on:
            for i, (t, color) in enumerate(self.entries):
                u, v = x0 + 8, y0 + 8 + 14 * i
                draw.rectangle([u, v, u + 10, v + 10], fill=color)
                _text(draw, (u + 14, v + 5), t, anchor="lm")


def _rgba(color, alpha) -> Tuple[int, int, int, int]:
    return (*color, int(round(255 * float(alpha if alpha is not None else 1.0))))


def _polyline(u: np.ndarray, v: np.ndarray) -> List[Tuple[float, float]]:
    """Pixel points of a curve, consecutive repeats at pixel resolution
    dropped (an ROC curve of millions of points draws as a few thousand)."""
    ok = np.isfinite(u) & np.isfinite(v)
    p = np.stack([u[ok], v[ok]], axis=1)
    if len(p) > 2:
        q = np.round(p)
        keep = np.r_[True, np.any(np.diff(q, axis=0) != 0, axis=1)]
        keep[-1] = True
        p = p[keep]
    return [(float(a), float(b)) for a, b in p]


def _dashed(draw, pts, fill, width: int, dash) -> None:
    if len(pts) < 2:
        return
    if dash is None:
        draw.line(pts, fill=fill, width=max(1, width))
        return
    pattern, k, left, on = list(dash), 0, float(dash[0]), True
    for (ua, va), (ub, vb) in zip(pts[:-1], pts[1:]):
        seg = float(np.hypot(ub - ua, vb - va))
        t = 0.0
        while t < seg:
            step = min(left, seg - t)
            if on:
                a, b = t / seg, (t + step) / seg
                draw.line([(ua + (ub - ua) * a, va + (vb - va) * a),
                           (ua + (ub - ua) * b, va + (vb - va) * b)], fill=fill,
                          width=max(1, width))
            t += step
            left -= step
            if left <= 0:
                k = (k + 1) % len(pattern)
                left, on = float(pattern[k]), not on


def _text(draw, xy, text: str, anchor: str = "la") -> None:
    """Text at `xy` by a two-letter anchor, as PIL's: l/m/r horizontally,
    a/m/d (top, middle, bottom) vertically; placed by its measured box, so
    any font PIL has (the bitmap default too) will do."""
    if not text:
        return
    left, top, right, bottom = draw.textbbox((0, 0), text)
    w, h = right - left, bottom - top
    u = float(xy[0]) - {"l": 0, "m": w / 2, "r": w}[anchor[0]] - left
    v = float(xy[1]) - {"a": 0, "m": h / 2, "d": h}[anchor[1]] - top
    draw.text((u, v), text, fill=(0, 0, 0))


def _vertical_text(canvas, center, text: str) -> None:
    from PIL import Image, ImageDraw
    w = 7 * len(text) + 4
    img = Image.new("RGBA", (w, 14), (255, 255, 255, 0))
    ImageDraw.Draw(img).text((2, 1), text, fill=(0, 0, 0, 255))
    img = img.rotate(90, expand=True)
    canvas.paste(img, (int(center[0] - img.width // 2), int(center[1] - img.height // 2)), img)


class _Figure:
    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = tuple(float(f) for f in figsize)
        self.axes: List[_Axes] = []
        self.suptitle_text = ""

    def _axes_at(self, rows: int, cols: int, row: int, col: int) -> _Axes:
        for ax in self.axes:
            if ax.cell == (rows, cols, row, col) and ax.twin_of is None:
                return ax
        ax = _Axes(self, (rows, cols, row, col))
        self.axes.append(ax)
        return ax

    def add_subplot(self, spec) -> _Axes:
        return self._axes_at(*spec)

    def suptitle(self, text, **_):
        self.suptitle_text = str(text)

    def tight_layout(self, *_, **__):
        pass

    def savefig(self, path, dpi: float = 100, **_) -> None:
        from PIL import Image, ImageDraw

        dpi = min(float(dpi), 100.0)
        w, h = int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)
        canvas = Image.new("RGB", (w, h), (255, 255, 255))
        top = 24 if self.suptitle_text else 0
        if top:
            _text(ImageDraw.Draw(canvas), (w // 2, 6), self.suptitle_text, anchor="ma")
        for ax in self.axes:
            rows, cols, row, col = ax.cell
            cw, ch = w / cols, (h - top) / rows
            box = (int(col * cw + 0.13 * cw), int(top + row * ch + 0.12 * ch),
                   int((col + 1) * cw - 0.09 * cw), int(top + (row + 1) * ch - 0.16 * ch))
            ax.draw(canvas, box)
        canvas.save(Path(path), format="PNG")


class _GridSpec:
    def __init__(self, nrows: int, ncols: int, figure=None, **_):
        self.shape = (nrows, ncols)

    def update(self, **_):
        pass

    def __getitem__(self, key) -> Tuple[int, int, int, int]:
        return (*self.shape, *key)


class _Lite:
    """The subset of ``matplotlib.pyplot`` (and ``gridspec``) the port calls."""

    GridSpec = _GridSpec

    def __init__(self):
        self._current: Optional[_Figure] = None

    def figure(self, figsize=(6.4, 4.8), **_) -> _Figure:
        self._current = _Figure(figsize)
        return self._current

    def subplots(self, nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8), **_):
        fig = self.figure(figsize)
        axes = np.empty((nrows, ncols), dtype=object)
        for i in range(nrows):
            for j in range(ncols):
                axes[i, j] = fig._axes_at(nrows, ncols, i, j)
        if nrows == ncols == 1:
            return fig, axes[0, 0]
        return fig, (axes.reshape(-1) if nrows == 1 or ncols == 1 else axes)

    def subplot(self, nrows: int, ncols: int, index: int) -> _Axes:
        fig = self._current or self.figure()
        return fig._axes_at(nrows, ncols, (index - 1) // ncols, (index - 1) % ncols)

    def colorbar(self, *_, **__):
        pass

    def close(self, *_):
        self._current = None


LITE = _Lite()
