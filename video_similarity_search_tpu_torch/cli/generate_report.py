"""Training-curve report entry point of the port (mirrors the JAX
package's ``cli/generate_report.py``; reference
misc/generate_report.py:113-186).

    python -m video_similarity_search_tpu_torch.cli.generate_report \\
        --output_path <run OUTPUT_PATH> [--out_png <png>]

Reads ``<output_path>/tnet_checkpoints/*.txt`` and writes
``training_progress.png`` there (or ``--out_png``), drawn with Pillow.
Runs on the host only.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..evaluation.report import plot_training_progress


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    parser = argparse.ArgumentParser("generate_report")
    parser.add_argument("--output_path", required=True,
                        help="run OUTPUT_PATH containing tnet_checkpoints/")
    parser.add_argument("--out_png", default=None)
    args = parser.parse_args(argv)
    out = plot_training_progress(args.output_path, args.out_png)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
