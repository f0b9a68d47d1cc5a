"""Canvas-content geometry: content of size (h, w) sits on the (H, W)
canvas at integer offsets y0 = (H - h) // 2, x0 = (W - w) // 2."""

from __future__ import annotations

import torch


def content_mask(H: int, W: int, sizes: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool masks of the centred content rectangles; sizes (B, 2)."""
    hh = sizes[:, 0][:, None, None]
    ww = sizes[:, 1][:, None, None]
    y0 = torch.div(H - hh, 2, rounding_mode="floor")
    x0 = torch.div(W - ww, 2, rounding_mode="floor")
    yy = torch.arange(H, dtype=sizes.dtype, device=sizes.device)[None, :, None]
    xx = torch.arange(W, dtype=sizes.dtype, device=sizes.device)[None, None, :]
    return (yy >= y0) & (yy < y0 + hh) & (xx >= x0) & (xx < x0 + ww)
