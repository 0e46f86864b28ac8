"""Plain reference of the train loader's decode of one RGB clip with its
RandomResizedCrop: every frame decoded by PIL at full resolution (a
missing trailing frame repeats the last one read), the crop box's window
(rows round(top) to round(top + height), columns likewise) cut out, and
resized to size x size bilinearly with half-pixel centres and no
antialiasing, as OpenCV's INTER_LINEAR does."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def decode_clip(video_dir: str, frame_indices, box, size: int) -> np.ndarray:
    from PIL import Image

    frames = []
    for i in frame_indices:
        path = os.path.join(video_dir, f"image_{i:05d}.jpg")
        if os.path.exists(path):
            with Image.open(path) as im:
                frames.append(np.asarray(im.convert("RGB")))
        else:
            frames.append(frames[-1])
    x = np.stack(frames)
    top, left, ch, cw = box
    y0, x0 = int(round(top)), int(round(left))
    y1, x1 = int(round(top + ch)), int(round(left + cw))
    win = x[:, max(0, y0):max(y0 + 1, y1), max(0, x0):max(x0 + 1, x1)]
    t = torch.from_numpy(np.ascontiguousarray(win)).permute(0, 3, 1, 2)
    out = F.interpolate(t.float(), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).numpy()
