"""Temporal similarity heat map (port of the JAX package's
``evaluation/heatmap.py``; reference evaluate.py:402-483).

Slides a ``SAMPLE_DURATION`` window (stride duration // 2) across an
exemplar video, embeds every window and one center clip of a test video in
one batch, and writes each window's embedding distance to the test clip as
a curve PNG (8 x 3 inches at 120 dpi, the JAX figure's 960 x 360 pixels),
drawn with ``plotting.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.augment import normalize_only
from ..losses.triplet import pairwise_dist
from ..train.steps import make_embed_step
from ..utils.device import resolve_device
from .plotting import figure_size, line_panels


def temporal_heat_map(model, cfg, dataset, *, exemplar_idx: int,
                      test_idx: int, out_png: Optional[str] = None,
                      metric: str = "euclidean", device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frame_positions, distances); writes ``out_png`` if given.

    ``dataset`` is a VideoDataset (its reader loads fixed-size eval clips).
    Window i covers exemplar frames [i - D, i) for i in
    range(D, num_frames, D//2) — the reference's TemporalSpecificCrop loop
    (evaluate.py:433-452)."""
    dev = resolve_device(device)
    d = cfg.DATA.SAMPLE_DURATION
    stride = max(d // 2, 1)
    reader = dataset.reader
    ex_sample = dataset.samples[exemplar_idx]
    test_sample = dataset.samples[test_idx]

    # one fixed test clip: center window
    n_test = test_sample["num_frames"]
    t0 = max((n_test - d) // 2, 0)
    test_clip = reader.load(test_sample,
                            [min(t0 + i + 1, n_test) for i in range(d)])

    positions = list(range(d, ex_sample["num_frames"], stride))
    windows = [reader.load(ex_sample, list(range(i - d + 1, i + 1)))
               for i in positions]

    embed = make_embed_step(cfg, model, device=dev)
    batch = torch.from_numpy(np.stack(windows + [test_clip])).to(dev)
    emb = embed(normalize_only(batch, dataset=cfg.TRAIN.DATASET))
    ex_emb, test_emb = emb[:-1], emb[-1:]
    dists = pairwise_dist(ex_emb, test_emb.expand_as(ex_emb),
                          metric).cpu().numpy()

    if out_png:
        line_panels([{
            "series": [(positions, dists, None)],
            "title": f"temporal heat map: exemplar {exemplar_idx} vs "
                     f"test {test_idx}",
            "xlabel": "exemplar frame",
            "ylabel": f"{metric} distance to test clip"}],
            figure_size(8, 3, 120), out_png)
    return np.asarray(positions), dists
