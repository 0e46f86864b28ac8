"""A small Pillow renderer for the three kinds of figure the evaluation
tools draw: line panels side by side, a scatter coloured by class, and an
image grid. The JAX package draws them with matplotlib, which the port
does not use (the card's machine has none); each figure here has the
pixel size of the JAX figure, figsize x dpi.

Text uses Pillow's built-in font (scalable where Pillow has FreeType).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's tab10 cycle (line colours) and tab20 (class colours)
TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
         (188, 189, 34), (23, 190, 207))
TAB20 = ((31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120),
         (44, 160, 44), (152, 223, 138), (214, 39, 40), (255, 152, 150),
         (148, 103, 189), (197, 176, 213), (140, 86, 75), (196, 156, 148),
         (227, 119, 194), (247, 182, 210), (127, 127, 127), (199, 199, 199),
         (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229))
WHITE, BLACK, GREY = (255, 255, 255), (0, 0, 0), (204, 204, 204)

def figure_size(width_in: float, height_in: float, dpi: int
                ) -> Tuple[int, int]:
    """Pixels of a matplotlib figure of that size saved at ``dpi``."""
    return int(round(width_in * dpi)), int(round(height_in * dpi))


def _font(px: int):
    return ImageFont.load_default(size=px)  # Pillow >= 10.1


def _text(draw, xy, text, font, fill=BLACK, align="center", valign="top"):
    """Draw ``text`` placed at ``xy`` by its left / center / right edge and
    its top / middle / bottom."""
    x0, y0, x1, y1 = draw.textbbox((0, 0), text, font=font)
    w, h = x1 - x0, y1 - y0
    x = {"left": xy[0], "center": xy[0] - w / 2, "right": xy[0] - w}[align]
    y = {"top": xy[1], "middle": xy[1] - h / 2, "bottom": xy[1] - h}[valign]
    draw.text((x - x0, y - y0), text, font=font, fill=fill)


def nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """About ``n`` round tick values within [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo]
    raw = (hi - lo) / max(n - 1, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    count = int((hi - first) / step + 1e-9) + 1
    return [first + i * step for i in range(count)]


def _fmt(v: float) -> str:
    return f"{v:.6g}" if abs(v) >= 1e-12 else "0"


def _limits(values: np.ndarray) -> Tuple[float, float]:
    """Data limits with matplotlib's 5% margins."""
    values = values[np.isfinite(values)]
    if values.size == 0:
        return 0.0, 1.0
    lo, hi = float(values.min()), float(values.max())
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


class _Axes:
    """One panel: a frame with ticks, a title and axis labels, mapping
    data to pixels."""

    def __init__(self, img, box, xlim, ylim, font, title="", xlabel="",
                 ylabel=""):
        self.draw = draw = ImageDraw.Draw(img)
        self.font = font
        left, top, right, bottom = box
        fh = font.size if hasattr(font, "size") else 11
        self.x0 = left + int(4.5 * fh) + (fh + 4 if ylabel else 0)
        self.x1 = right - fh
        self.y0 = top + int(2.2 * fh)
        self.y1 = bottom - int(2.2 * fh) - (fh + 4 if xlabel else 0)
        self.xlim, self.ylim = xlim, ylim
        draw.rectangle((self.x0, self.y0, self.x1, self.y1), outline=BLACK)
        for v in nice_ticks(*xlim):
            px = self.px(v, ylim[0])[0]
            draw.line((px, self.y1, px, self.y1 + 4), fill=BLACK)
            _text(draw, (px, self.y1 + 6), _fmt(v), font)
        for v in nice_ticks(*ylim):
            py = self.px(xlim[0], v)[1]
            draw.line((self.x0 - 4, py, self.x0, py), fill=BLACK)
            _text(draw, (self.x0 - 6, py), _fmt(v), font, align="right",
                  valign="middle")
        _text(draw, ((self.x0 + self.x1) / 2, top + fh // 2), title, font)
        if xlabel:
            _text(draw, ((self.x0 + self.x1) / 2, bottom - 4), xlabel, font,
                  valign="bottom")
        if ylabel:
            x0, y0, x1, y1 = draw.textbbox((0, 0), ylabel, font=font)
            label = Image.new("RGB", (x1 - x0 + 2, y1 - y0 + 2), WHITE)
            ImageDraw.Draw(label).text((-x0 + 1, -y0 + 1), ylabel, font=font,
                                       fill=BLACK)
            label = label.rotate(90, expand=True)
            img.paste(label, (left + 2, int((self.y0 + self.y1) / 2
                                                     - label.height / 2)))

    def px(self, x: float, y: float) -> Tuple[float, float]:
        (xa, xb), (ya, yb) = self.xlim, self.ylim
        return (self.x0 + (x - xa) / (xb - xa) * (self.x1 - self.x0),
                self.y1 - (y - ya) / (yb - ya) * (self.y1 - self.y0))

    def legend(self, entries, ncol: int = 1, marker: bool = False):
        """Boxed legend in the upper right: (label, colour) entries."""
        if not entries:
            return
        d, f = self.draw, self.font
        fh = f.size if hasattr(f, "size") else 11
        widths = [d.textbbox((0, 0), lab, font=f)[2] for lab, _ in entries]
        col_w = max(widths) + 3 * fh
        rows = math.ceil(len(entries) / ncol)
        w, h = ncol * col_w + fh // 2, rows * (fh + 4) + fh // 2
        x, y = self.x1 - w - 6, self.y0 + 6
        d.rectangle((x, y, x + w, y + h), fill=WHITE, outline=GREY)
        for i, (lab, col) in enumerate(entries):
            cx = x + fh // 2 + (i // rows) * col_w
            cy = y + fh // 4 + (i % rows) * (fh + 4) + (fh + 4) // 2
            if marker:
                r = max(fh // 4, 2)
                d.ellipse((cx + fh - r, cy - r, cx + fh + r, cy + r), fill=col)
            else:
                d.line((cx, cy, cx + 2 * fh, cy), fill=col, width=2)
            _text(d, (cx + 2.5 * fh, cy), lab, f, align="left",
                  valign="middle")


def line_panels(panels: Sequence[dict], size: Tuple[int, int],
                out_path: str) -> str:
    """Side-by-side line plots. Each panel: {"series": [(x, y, label)],
    "title", "xlabel", "ylabel"}; a panel with labelled series gets a
    legend. Series take the tab10 colours in turn, per panel."""
    img = Image.new("RGB", size, WHITE)
    draw = ImageDraw.Draw(img)
    font = _font(max(10, size[1] // 40))
    width = size[0] / max(len(panels), 1)
    for i, panel in enumerate(panels):
        series = [(np.asarray(x, np.float64), np.asarray(y, np.float64), lab)
                  for x, y, lab in panel["series"]]
        xs = np.concatenate([s[0] for s in series] or [np.zeros(0)])
        ys = np.concatenate([s[1] for s in series] or [np.zeros(0)])
        ax = _Axes(img, (int(i * width), 0, int((i + 1) * width), size[1]),
                   _limits(xs), _limits(ys), font, panel.get("title", ""),
                   panel.get("xlabel", ""), panel.get("ylabel", ""))
        entries = []
        for j, (x, y, lab) in enumerate(series):
            col = TAB10[j % len(TAB10)]
            pts = [ax.px(a, b) for a, b in zip(x, y)
                   if math.isfinite(a) and math.isfinite(b)]
            if len(pts) > 1:
                draw.line(pts, fill=col, width=2)
            elif pts:
                draw.ellipse((pts[0][0] - 2, pts[0][1] - 2, pts[0][0] + 2,
                              pts[0][1] + 2), fill=col)
            if lab:
                entries.append((lab, col))
        ax.legend(entries)
    return _save(img, out_path)


def scatter_classes(points: np.ndarray, labels: np.ndarray,
                    classes: Sequence, names: Sequence[str],
                    size: Tuple[int, int], out_path: str,
                    title: str = "") -> str:
    """2-D points coloured by class (tab20 in the order of ``classes``),
    with a two-column legend of ``names``."""
    img = Image.new("RGB", size, WHITE)
    draw = ImageDraw.Draw(img)
    font = _font(max(10, size[1] // 60))
    pts = np.asarray(points, np.float64)
    ax = _Axes(img, (0, 0) + size, _limits(pts[:, 0]), _limits(pts[:, 1]),
               font, title)
    r = max(2, size[1] // 400)
    entries = []
    for i, (cls, name) in enumerate(zip(classes, names)):
        col = TAB20[i % 20]
        for x, y in pts[labels == cls]:
            px, py = ax.px(x, y)
            draw.ellipse((px - r, py - r, px + r, py + r), fill=col)
        entries.append((name, col))
    ax.legend(entries, ncol=2, marker=True)
    return _save(img, out_path)


def image_grid(rows: Sequence[Sequence[np.ndarray]], size: Tuple[int, int],
               out_path: str, titles: Sequence[Optional[str]] = ()) -> str:
    """A grid of uint8 (H, W, 3) images, each scaled into its cell with its
    aspect kept; ``titles[c]`` goes above column c's cells."""
    img = Image.new("RGB", size, WHITE)
    draw = ImageDraw.Draw(img)
    n_rows, n_cols = len(rows), max(len(r) for r in rows)
    cw, ch = size[0] / n_cols, size[1] / n_rows
    font = _font(max(10, int(ch) // 16))
    pad = int(ch * 0.12)
    for r, row in enumerate(rows):
        for c, frame in enumerate(row):
            tile = Image.fromarray(np.asarray(frame, np.uint8)).convert("RGB")
            scale = min((cw - 8) / tile.width, (ch - pad - 8) / tile.height)
            tile = tile.resize((max(1, int(tile.width * scale)),
                                max(1, int(tile.height * scale))),
                               Image.BILINEAR)
            x = int(c * cw + (cw - tile.width) / 2)
            y = int(r * ch + pad + (ch - pad - tile.height) / 2)
            img.paste(tile, (x, y))
            if c < len(titles) and titles[c]:
                _text(draw, (c * cw + cw / 2, y - 2), titles[c], font,
                      valign="bottom")
    return _save(img, out_path)


def _save(img: Image.Image, out_path: str) -> str:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    img.save(out_path, format="PNG")
    return out_path
