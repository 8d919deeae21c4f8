"""16-segment AHA bull's-eye plot (``cardiac_utils.py:1540-1613``).

The port's copy of ``ukbb_cardiac_tpu/phenotype/bullseye.py``.
"""

from __future__ import annotations

import numpy as np

_R1, _R2, _R3, _R4 = 1, 0.65, 0.3, 0.0
_RAD_DEG = {
    1: (_R1, _R2, 60, 120), 2: (_R1, _R2, 120, 180),
    3: (_R1, _R2, -180, -120), 4: (_R1, _R2, -120, -60),
    5: (_R1, _R2, -60, 0), 6: (_R1, _R2, 0, 60),
    7: (_R2, _R3, 60, 120), 8: (_R2, _R3, 120, 180),
    9: (_R2, _R3, -180, -120), 10: (_R2, _R3, -120, -60),
    11: (_R2, _R3, -60, 0), 12: (_R2, _R3, 0, 60),
    13: (_R3, _R4, 45, 135), 14: (_R3, _R4, 135, -135),
    15: (_R3, _R4, -135, -45), 16: (_R3, _R4, -45, 45),
}


def bulls_eye_canvas(data, size: int = 201) -> np.ndarray:
    """Rasterise 16 segment values into the polar-mask canvas the
    reference draws (``cardiac_utils.py:1548-1588``)."""
    if len(data) != 16:
        raise ValueError("len(data) != 16")
    x = np.linspace(-1, 1, size)
    y = np.linspace(-1, 1, size)
    xx, yy = np.meshgrid(x, y)
    r = np.sqrt(xx * xx + yy * yy)
    theta = np.degrees(np.arctan2(yy, xx))
    canvas = np.zeros(xx.shape)
    for i in range(1, 17):
        val = data[i - 1]
        r1, r2, theta1, theta2 = _RAD_DEG[i]
        radial = (r < r1) & (r >= r2)
        if theta2 > theta1:
            mask = radial & (theta >= theta1) & (theta < theta2)
        else:
            mask = radial & ((theta >= theta1) | (theta < theta2))
        canvas[mask] = val
    return canvas


def plot_bulls_eye(data, vmin, vmax, cmap="Reds", color_line="black"):
    """Draw the bull's eye on the current matplotlib axes, with segment
    boundaries and RV-insertion markers (``cardiac_utils.py:1589-1613``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    canvas = bulls_eye_canvas(data)
    cx = cy = (canvas.shape[0] - 1) / 2
    sz = cx

    plt.imshow(canvas, cmap=cmap, vmin=vmin, vmax=vmax)
    plt.colorbar()
    plt.axis("off")
    plt.gca().invert_yaxis()

    for r in (_R1, _R2, _R3):
        deg = np.linspace(0, 2 * np.pi, 201)
        plt.plot(cx + sz * r * np.cos(deg), cy + sz * r * np.sin(deg),
                 color=color_line)
    for i in range(1, 17):
        r1, r2, theta1, _ = _RAD_DEG[i]
        plt.plot(cx + sz * np.array([r1, r2]) * np.cos(np.radians(theta1)),
                 cy + sz * np.array([r1, r2]) * np.sin(np.radians(theta1)),
                 color=color_line)
    for i in (2, 4):
        r1, _, theta1, _ = _RAD_DEG[i]
        x0 = cx + sz * r1 * np.cos(np.radians(theta1))
        y0 = cy + sz * r1 * np.sin(np.radians(theta1))
        plt.plot([x0, x0 - sz * 0.2], [y0, y0], color=color_line)
