"""Plain IFCB sample reader: ``.adc`` rows and the ``.roi`` payload.

Per ``.adc`` row, column 15 is the ROI width, 16 its height and 17 its start
byte in the ``.roi`` file. Rows with a width or height under 1 are empty
triggers and carry no ROI, but ROI ids stay the 1-based row numbers.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

COL_WIDTH, COL_HEIGHT, COL_START = 15, 16, 17


def read_sample(sample_path) -> list[tuple[int, np.ndarray]]:
    """``[(roi_id, (h, w) uint8 image), ...]`` of one sample, in row
    order."""
    sample_path = Path(sample_path)
    rows = sample_path.with_suffix(".adc").read_text().splitlines()
    payload = np.fromfile(sample_path.with_suffix(".roi"), dtype=np.uint8)
    out = []
    for i, line in enumerate(rows):
        if not line:
            continue
        cols = line.split(",")
        w, h = int(cols[COL_WIDTH]), int(cols[COL_HEIGHT])
        start = int(float(cols[COL_START]))
        if w < 1 or h < 1:
            continue
        if start < 0 or start + h * w > payload.size:
            raise ValueError(f"{sample_path.name}: row {i + 1} points "
                             "outside the .roi payload")
        out.append((i + 1, payload[start:start + h * w].reshape(h, w)))
    return out
