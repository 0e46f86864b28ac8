"""Training-curve report from txt metric logs (port of the JAX package's
``evaluation/report.py``; reference misc/generate_report.py:44-186).

Parses the append-only logs (train_loss_and_acc.txt, val_loss_and_acc.txt,
NMIs.txt, AMIs.txt) and renders a multi-panel PNG with ``plotting.py``
(Pillow) at the JAX figure's pixel size: (4 x panels) x 3.5 inches at 150
dpi.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from .plotting import figure_size, line_panels


def parse_train_log(path: str) -> Dict[str, List[float]]:
    """Lines like 'epoch:3 runtime:0.02 1.2345'."""
    epochs, losses, runtimes = [], [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                m = re.match(r"epoch:(\d+)\s+runtime:([\d.eE+-]+)\s+"
                             r"([\d.eE+-]+)", line)
                if m:
                    epochs.append(int(m.group(1)))
                    runtimes.append(float(m.group(2)))
                    losses.append(float(m.group(3)))
    return {"epoch": epochs, "runtime": runtimes, "loss": losses}


def parse_val_log(path: str) -> Dict[str, List[float]]:
    """Lines like 'epoch:3 0.9 0.5 0.41 0.77'."""
    out = {"epoch": [], "loss": [], "acc": [], "top1": [], "top5": []}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or not parts[0].startswith("epoch:"):
                    continue
                out["epoch"].append(int(parts[0].split(":")[1]))
                vals = [float(v) for v in parts[1:5]]
                for key, v in zip(("loss", "acc", "top1", "top5"), vals):
                    out[key].append(v)
    return out


def parse_scalar_log(path: str) -> List[float]:
    """One float per line (NMIs.txt / AMIs.txt)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [float(line.strip()) for line in f if line.strip()]


def plot_training_progress(output_path: str,
                           out_png: Optional[str] = None) -> Optional[str]:
    """Render loss / triplet-acc / retrieval / NMI / AMI panels."""
    log_dir = os.path.join(output_path, "tnet_checkpoints")
    train = parse_train_log(os.path.join(log_dir, "train_loss_and_acc.txt"))
    val = parse_val_log(os.path.join(log_dir, "val_loss_and_acc.txt"))
    nmis = parse_scalar_log(os.path.join(log_dir, "NMIs.txt"))
    amis = parse_scalar_log(os.path.join(log_dir, "AMIs.txt"))

    loss = [(train["epoch"], train["loss"], "train")]
    if val["loss"]:
        loss.append((val["epoch"], val["loss"], "val"))
    panels = [{"title": "loss", "series": loss},
              {"title": "triplet accuracy",
               "series": [(val["epoch"], val["acc"], None)]}]
    if val["top1"]:
        panels.append({"title": "retrieval", "series": [
            (val["epoch"], val["top1"], "top1"),
            (val["epoch"], val["top5"], "top5")]})
    for name, values in (("NMI", nmis), ("AMI", amis)):
        if values:
            panels.append({"title": name, "series": [
                (range(len(values)), values, None)]})
    out_png = out_png or os.path.join(log_dir, "training_progress.png")
    return line_panels(panels, figure_size(4 * len(panels), 3.5, 150),
                       out_png)
