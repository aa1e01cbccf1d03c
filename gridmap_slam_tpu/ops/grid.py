"""Occupancy-grid numerics: log-odds transforms and the likelihood field.

Reference behavior: app/Util.java:31-58 (logOdds/invLogOdds),
slam/GridMap.java:233-250 (threshold + separable Gaussian blur),
app/Util.java:378-474 (separable blur with zero boundary, kernel generator).

Design: the blur is a pair of 1-D convolutions expressed as unrolled
shift-multiply-adds over a zero-padded array — XLA fuses the whole likelihood
field build (threshold + two blur passes) into a few vectorized memory
passes, and it batches cleanly under vmap over particles.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def log_odds(p):
    return math.log(p / (1.0 - p)) if isinstance(p, float) else jnp.log(p / (1.0 - p))


def inv_log_odds(l):
    """logodds -> probability: 1 - 1/(1+e^l) (app/Util.java:42-48)."""
    return 1.0 - 1.0 / (1.0 + jnp.exp(l))


def gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    """Normalized 1-D Gaussian kernel with `radius` taps on either side
    (app/Util.java:428-456)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma)) / (np.sqrt(2 * np.pi) * sigma)
    g /= g.sum()
    return g.astype(np.float32)


def blur_separable(img, kernel: np.ndarray):
    """Separable blur with zero boundary handling (app/Util.java:378-426):
    out-of-bounds taps contribute 0.  img: (..., H, W)."""
    k = (len(kernel) - 1) // 2
    # Horizontal pass.
    pad = [(0, 0)] * (img.ndim - 1) + [(k, k)]
    px = jnp.pad(img, pad)
    h = jnp.zeros_like(img)
    w = img.shape[-1]
    for i, kv in enumerate(kernel):
        h = h + kv * jax_slice_last(px, i, w)
    # Vertical pass.
    pad = [(0, 0)] * (img.ndim - 2) + [(k, k), (0, 0)]
    py = jnp.pad(h, pad)
    out = jnp.zeros_like(img)
    hh = img.shape[-2]
    for i, kv in enumerate(kernel):
        out = out + kv * jax_slice_secondlast(py, i, hh)
    return out


def jax_slice_last(x, start, size):
    return x[..., start:start + size]


def jax_slice_secondlast(x, start, size):
    return x[..., start:start + size, :]


def threshold_occupancy(logodds):
    """Round probabilities to {0, 0.5, 1} by log-odds sign
    (slam/GridMap.java:238-245)."""
    return jnp.where(logodds > 0.0, 1.0,
                     jnp.where(logodds < 0.0, 0.0, 0.5)).astype(logodds.dtype)


def likelihood_field(logodds, kernel: np.ndarray):
    """Build the Gaussian-blurred likelihood field from a log-odds map
    (slam/GridMap.java:233-250).  Returns (field, unknown_mask) where
    `unknown_mask` marks cells whose entire blur neighborhood is unexplored —
    the reference detects these by the exact value 0.5
    (slam/GridMap.java:285), which is not robust in f32; we blur the
    "explored" indicator with the same kernel instead, which is exact."""
    p = threshold_occupancy(logodds)
    field = blur_separable(p, kernel)
    explored = jnp.abs(p - 0.5) > 0.25   # cells with any evidence
    evidence = blur_separable(explored.astype(logodds.dtype), kernel)
    unknown = evidence <= 0.0
    return field, unknown


def beam_log_likelihood(field_vals, unknown, z_hit: float, max_range: float):
    """Per-beam log p(z_b | x, m) from likelihood-field lookups
    (slam/GridMap.java:261-294): uniform 1/max_range for unexplored cells,
    else z_hit*field + (1-z_hit)/max_range."""
    uniform = 1.0 / max_range
    known_p = z_hit * field_vals + (1.0 - z_hit) * uniform
    p = jnp.where(unknown, uniform, known_p)
    return jnp.log(jnp.maximum(p, 1e-30))
