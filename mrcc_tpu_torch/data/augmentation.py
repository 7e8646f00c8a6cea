"""Point-cloud augmentations, numpy and scipy on the host (the port's copy
of ``mrcc_tpu/data/augmentation.py``, after the reference's
``utils/augmentation.py``): elastic distortion, gaussian noise, a
conjugated random shift, an x flip, a rotation about the gravity axis and
a background colour swap, each applied with probability p.

Every draw comes from the caller's ``np.random.Generator`` in the JAX
package's order, so one seed gives the same cloud.

Ported as written, trap included (ROADMAP C23): ``augment_segmentation``
sizes the elastic noise grid in voxel units (``gran = 6 * scale // 50``,
``mag = 40 * scale / 50``) and applies it to points in metres, which moves
them by metres at ``scale=100``.  It is off unless a ``DataConfig``
lists ``"elastic"`` in ``augmentation``.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


def distort_elastic(x, gran, mag, rng):
    """Elastic distortion via tri-axis blurred noise grids (augmentation.py:14)."""
    blur0 = np.ones((3, 1, 1), np.float32) / 3
    blur1 = np.ones((1, 3, 1), np.float32) / 3
    blur2 = np.ones((1, 1, 3), np.float32) / 3
    bb = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = [rng.standard_normal(size=tuple(bb)).astype(np.float32)
             for _ in range(3)]
    for blur in (blur0, blur1, blur2, blur0, blur1, blur2):
        noise = [scipy.ndimage.convolve(n, blur, mode="constant", cval=0)
                 for n in noise]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    interp = [scipy.interpolate.RegularGridInterpolator(ax, n, bounds_error=False,
                                                        fill_value=0)
              for n in noise]
    g = np.hstack([i(x)[:, None] for i in interp])
    return x + g * mag


def add_noise(x, rng, sigma=0.0016, clip=0.005):
    """(augmentation.py:49)"""
    return x + np.clip(sigma * rng.standard_normal(size=x.shape), -clip, clip)


def transform_random(pc, rng):
    """Conjugated random x-shift: rot @ shift @ rot.T (augmentation.py:54)."""
    from scipy.stats import special_ortho_group

    tr = rng.random() * 0.04
    rot = special_ortho_group.rvs(3, random_state=rng)
    pc = pc @ rot
    pc = pc + np.array([[tr, 0, 0]])
    return pc @ rot.T


def flip_random(pc, rng):
    """Randomly flip x (augmentation.py:64)."""
    m = np.eye(3)
    m[0, 0] *= rng.integers(0, 2) * 2 - 1
    return pc @ m


def rotate_along_gravity(pc, rng):
    """Random rotation about the y (gravity) axis (augmentation.py:70)."""
    a = rng.random() * 2 * np.pi
    rot = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                    [np.sin(a), 0, np.cos(a)]])
    return pc @ rot.T


def change_background(rgb, labels, bg_rgb, rng):
    """Replace background point colors with samples from an image's pixels
    (augmentation.py:36); ``bg_rgb`` is an [M,3] pixel array in [0,1]."""
    bg = labels == 0
    sel = rng.integers(0, len(bg_rgb), int(bg.sum()))
    rgb = rgb.copy()
    rgb[bg] = bg_rgb[sel]
    return rgb


def augment(points, rng, probability=0.2, elastic=False, noise=False,
            transform=False, flip=False, gravity=False):
    """Pose-regression augmentation composition (augmentation.py:78)."""
    if elastic and rng.random() < probability:
        points = distort_elastic(points, 1, 4, rng)
    if noise and rng.random() < probability:
        points = add_noise(points, rng)
    if transform and rng.random() < probability:
        points = transform_random(points, rng)
    if flip and rng.random() < probability:
        points = flip_random(points, rng)
    if gravity and rng.random() < probability:
        points = rotate_along_gravity(points, rng)
    return points


def augment_segmentation(points, rng, scale=200, probability=0.2,
                         elastic=False, noise=False, transform=False,
                         flip=False, gravity=False):
    """Scale-aware variant used by the dataset (augmentation.py:108)."""
    if elastic and rng.random() < probability:
        points = distort_elastic(points, 6 * scale // 50, 40 * scale / 50, rng)
        points = distort_elastic(points, 20 * scale // 50, 160 * scale / 50, rng)
    if noise and rng.random() < probability:
        points = add_noise(points, rng)
    if transform and rng.random() < probability:
        points = transform_random(points, rng)
    if flip and rng.random() < probability:
        points = flip_random(points, rng)
    if gravity and rng.random() < probability:
        points = rotate_along_gravity(points, rng)
    return points
