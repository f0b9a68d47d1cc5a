"""2D overlays for reconstruction video frames: captions, histogram, bar.

Counterpart of acezero_tpu/viz/overlay.py in numpy. The panels and bars
are PIL's filled rectangles, pixel for pixel: a rectangle with float
corners covers the columns int(x0)..int(x1) and the rows int(y0)..int(y1),
both ends included, the corners truncated toward zero and clipped to the
image. Text is the 5x7 bitmap font of viz/font.py, each glyph pixel a
block of `(size + 4) // 10` pixels; the JAX package's anti-aliased DejaVu glyphs
are not reproduced, and the port's stay inside the panel they label.
"""

from __future__ import annotations

import numpy as np

from acezero_tpu_torch.viz.font import text_mask


def _rectangle(img: np.ndarray, xy, fill) -> None:
    """PIL's `ImageDraw.rectangle(xy, fill=fill)`, in place."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    h, w = img.shape[:2]
    ys, ye, xs, xe = max(y0, 0), min(y1, h - 1) + 1, max(x0, 0), min(x1, w - 1) + 1
    if ye > ys and xe > xs:
        img[ys:ye, xs:xe] = fill


def _text(img: np.ndarray, xy, text: str, fill, size: int) -> None:
    """`text` with its top-left corner a glyph pixel below `xy`, in place."""
    scale = max(1, (size + 4) // 10)
    mask = text_mask(text, scale)
    x, y = int(xy[0]), int(xy[1]) + scale
    h, w = img.shape[:2]
    ys, ye, xs, xe = max(y, 0), min(y + mask.shape[0], h), max(x, 0), min(x + mask.shape[1], w)
    if ye > ys and xe > xs:
        img[ys:ye, xs:xe][mask[ys - y: ye - y, xs - x: xe - x]] = fill


def draw_caption(img: np.ndarray, title: str, subtitle: str | None = None) -> np.ndarray:
    """Phase caption, top-left (reference captions, ace_visualizer.py:452+)."""
    out = np.array(img)
    _rectangle(out, [16, 14, 16 + 620, 14 + (66 if subtitle else 42)], (20, 20, 30))
    _text(out, (28, 20), title, (240, 240, 240), 24)
    if subtitle:
        _text(out, (28, 48), subtitle, (170, 200, 255), 24)
    return out


def draw_loading_bar(img: np.ndarray, fraction: float, label: str = "") -> np.ndarray:
    """Training-progress bar along the bottom (ace_visualizer.py:641-696)."""
    h, w = img.shape[:2]
    out = np.array(img)
    x0, x1, y0, y1 = 16, w - 16, h - 38, h - 16
    _rectangle(out, [x0, y0, x1, y1], (20, 20, 30))
    fx = x0 + 2 + (x1 - x0 - 4) * float(np.clip(fraction, 0.0, 1.0))
    _rectangle(out, [x0 + 2, y0 + 2, fx, y1 - 2], (90, 170, 90))
    if label:
        _text(out, (x0 + 10, y0 - 1), label, (245, 245, 245), 18)
    return out


def draw_conf_histogram(
    img: np.ndarray,
    confidences: np.ndarray,
    threshold: float,
    conf_max: float = 4000.0,
    bins: int = 20,
) -> np.ndarray:
    """Confidence histogram, bottom-right, green above / red below threshold
    (the reloc-phase histogram, ace_visualizer.py:452-561)."""
    h, w = img.shape[:2]
    bw, bh = 300, 120
    x0, y0 = w - bw - 16, h - bh - 48
    out = np.array(img)
    _rectangle(out, [x0, y0, x0 + bw, y0 + bh], (20, 20, 30))

    if confidences.size:
        edges = np.linspace(0.0, conf_max, bins + 1)
        counts, _ = np.histogram(np.clip(confidences, 0, conf_max), bins=edges)
        peak = max(int(counts.max()), 1)
        bar_w = (bw - 20) / bins
        for i, c in enumerate(counts):
            bx0 = x0 + 10 + i * bar_w
            bar_h = (bh - 36) * c / peak
            color = (90, 190, 90) if edges[i] >= threshold else (200, 80, 80)
            _rectangle(out, [bx0, y0 + bh - 12 - bar_h, bx0 + bar_w - 2, y0 + bh - 12], color)
    _text(out, (x0 + 10, y0 + 4), "registration confidence", (230, 230, 230), 16)
    return out
