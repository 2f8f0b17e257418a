"""Procedural frames of the synthetic corpus: `scene` and `shift_frame`
are verbatim copies of scripts/make_synth_data.py:20-51 (pinned by
tests/test_torch_eval_tools.py), which the BD-rate gate
(eval/bd_gate.py, as run_bd_gate.py) draws its stand-in sequence from.
numpy and scipy only.
"""

import numpy as np


def scene(rng, h, w):
    """Procedural image with structure at several scales: gradients,
    shapes, band-limited texture."""
    from scipy.ndimage import gaussian_filter
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    # smooth background gradient
    for c in range(3):
        a, b, ph = rng.uniform(-1, 1, 3)
        img[:, :, c] = 0.5 + 0.25 * (a * yy / h + b * xx / w + ph)
    # random soft shapes
    for _ in range(rng.integers(4, 10)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(6, h / 3)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        color = rng.uniform(0, 1, 3).astype(np.float32)
        alpha = rng.uniform(0.3, 0.9)
        img[mask] = (1 - alpha) * img[mask] + alpha * color
    # band-limited texture at 2 scales
    for sigma, amp in ((2.0, 0.10), (6.0, 0.08)):
        tex = gaussian_filter(rng.normal(0, 1, (h, w)), sigma)
        tex /= max(np.abs(tex).max(), 1e-6)
        img += amp * tex[:, :, None]
    return np.clip(img, 0, 1)


def shift_frame(img, dy, dx):
    """Subpixel global translation (wrap) — cheap coherent motion."""
    from scipy.ndimage import shift
    return np.clip(shift(img, (dy, dx, 0), order=1, mode="wrap"), 0, 1)
