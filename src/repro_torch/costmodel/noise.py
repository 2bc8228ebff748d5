"""Counter-based (dispatch-invariant) measurement noise (a copy of
``repro.costmodel.noise``).

The batched evaluation engine serves a whole proposal batch in one call;
the sequential driver serves the same configs one at a time.  For the two
paths to produce *identical* noisy observations — which is what makes
batched-vs-sequential parity auditable on the cost-model backend — the
noise for sample ``i`` of a stream must depend only on ``(seed, i)``, never
on how many samples shared a dispatch.

numpy's stateful Generators cannot provide that (a size-n draw consumes a
different amount of state than n size-1 draws), so we derive uniforms from
a splitmix64 hash of the sample counter and push them through Box-Muller.
Everything is vectorized; a batch of n samples costs four hashed uniforms
per sample with no Python-level loop.
"""

from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 -> uint64).

    Wrapping uint64 arithmetic is the algorithm; numpy's overflow warning is
    suppressed for exactly that reason.
    """
    with np.errstate(over="ignore"):
        x = (np.asarray(x, dtype=np.uint64) + _GOLDEN) & _MASK
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
        return x ^ (x >> np.uint64(31))


def hashed_uniform(key: int, idx: np.ndarray, stream: int) -> np.ndarray:
    """u[i] in [0, 1) depending only on (key, idx[i], stream)."""
    k = splitmix64(np.uint64(key & 0xFFFFFFFFFFFFFFFF))
    base = (np.asarray(idx, dtype=np.uint64) * np.uint64(4)
            + np.uint64(stream)) & _MASK
    h = splitmix64((base + k) & _MASK)
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def lognormal_noise(
    key: int,
    start: int,
    n: int,
    sigma: float,
    straggler_p: float = 0.01,
    straggler_lo: float = 1.1,
    straggler_hi: float = 1.5,
) -> np.ndarray:
    """Multiplicative noise factors for samples [start, start+n).

    Log-normal (mean 0, ``sigma``) runtime variance with a rare OS-jitter
    straggler tail — the model the paper's per-sample measurements assume.
    """
    idx = np.arange(start, start + n, dtype=np.uint64)
    u1 = hashed_uniform(key, idx, 0)
    u2 = hashed_uniform(key, idx, 1)
    u3 = hashed_uniform(key, idx, 2)
    u4 = hashed_uniform(key, idx, 3)
    z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
    f = np.exp(sigma * z)
    straggler = u3 < straggler_p
    return np.where(
        straggler, f * (straggler_lo + (straggler_hi - straggler_lo) * u4), f
    )
