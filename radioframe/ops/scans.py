"""Block-scan formulations of per-sample recursions (SURVEY.md §7 hard-part #1).

The reference runs per-sample state machines (AGC envelopes, DC blockers,
IIR biquads, squelch) in tiny ISR blocks; here those recursions become
O(log T) ``jax.lax.associative_scan`` over semiring elements, vectorized
across channels. This module holds the two workhorse scans:

  - affine:   s[n] = a[n] * s[n-1] + b[n]        (first-order IIR et al.)
  - max-decay: s[n] = max(a[n] * s[n-1], b[n])   (peak envelopes / AGC)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _affine_combine(l, r):
    al, bl = l
    ar, br = r
    return al * ar, bl * ar + br


def affine_scan(a, b, s0):
    """s[n] = a[n]*s[n-1] + b[n] along the last axis, s[-1] = s0.

    a, b: (..., T); s0: (...,). Returns s (..., T).
    """
    aa, bb = lax.associative_scan(_affine_combine, (a, b), axis=-1)
    return bb + aa * s0[..., None]


def _maxdecay_combine(l, r):
    al, vl = l
    ar, vr = r
    return al * ar, jnp.maximum(vl * ar, vr)


def maxdecay_scan(a, v, s0):
    """s[n] = max(a[n]*s[n-1], v[n]) along the last axis, s[-1] = s0."""
    aa, vv = lax.associative_scan(_maxdecay_combine, (a, v), axis=-1)
    return jnp.maximum(vv, aa * s0[..., None])


def first_order_iir(x, pole, zero_num, s0):
    """y[n] = pole*y[n-1] + zero_num[n]; convenience over affine_scan."""
    a = jnp.full_like(x, pole)
    return affine_scan(a, zero_num, s0)


# ---------------------------------------------------------------------------
# Fast paths for CONSTANT-coefficient scans.
#
# lax.associative_scan makes O(log T) full-array passes over BOTH semiring
# operands — at channelizer rates (4096 x 2048 f32) that is the single
# biggest HBM consumer in the audio stages. When the coefficient is constant
# along time (every chain use: DC-block pole, AGC release/attack constants,
# spectrum EMA), two exact reformulations cut the traffic 3-4x:
#
#   affine:   within-chunk prefix by ONE triangular-ones matmul after
#             an a^{-j} rescale, cross-chunk carries by a tiny scan;
#   maxdecay: global a^{-n} rescale turns the semiring into a plain cummax
#             (one operand instead of two).
#
# Both are numerically safe only while the rescale factors stay bounded —
# the *_ok helpers check the static coefficient tables; callers fall back
# to the associative form otherwise. Verified ~1e-5-relative-exact vs the
# associative scans (tests/test_ops.py::TestFastScans).
# ---------------------------------------------------------------------------

import numpy as np

_AFFINE_CHUNK = 128
_AFFINE_AMIN = 0.93          # a^-(G-1) <= ~1e4 at G=128
_MAXDECAY_RESCALE_LIMIT = 64.0  # max allowed a^-(T-1)


def affine_const_ok(a_values) -> bool:
    """Static check: may affine_scan_const use the chunked-matmul path for
    coefficients drawn from this table? (zeros allowed — handled exactly)."""
    a = np.asarray(a_values, np.float64).ravel()
    a = a[a != 0.0]
    return bool(a.size == 0 or (a.min() >= _AFFINE_AMIN and a.max() < 1.0))


def maxdecay_const_ok(a_values, T: int) -> bool:
    """Static check: is the global a^{-n} rescale bounded for block length T?"""
    amin = float(np.asarray(a_values, np.float64).min())
    return 0.0 < amin < 1.0 and amin ** -(T - 1) <= _MAXDECAY_RESCALE_LIMIT


def affine_scan_const(a_ch, b, s0, chunk: int = _AFFINE_CHUNK):
    """s[n] = a*s[n-1] + b[n] with a CONSTANT along time: a_ch (...,) per
    channel (may include exact zeros), b (..., T). Exact chunked form; the
    caller must have verified ``affine_const_ok`` on the coefficient table.
    Falls back to affine_scan when T doesn't chunk."""
    T = b.shape[-1]
    G = chunk
    if T % G != 0 or T < 2 * G:
        return affine_scan(jnp.broadcast_to(a_ch[..., None], b.shape), b, s0)
    nC = T // G
    sh = b.shape[:-1]
    j = jnp.arange(G, dtype=jnp.float32)
    a_safe = jnp.maximum(a_ch, jnp.float32(_AFFINE_AMIN))[..., None]  # (...,1)
    aji = a_safe ** (-j)     # (..., G)
    ajp = a_safe ** j
    bc = b.reshape(sh + (nC, G)) * aji[..., None, :]
    ones_lt = np.tril(np.ones((G, G), np.float32))
    pref = lax.dot_general(bc, ones_lt, (((bc.ndim - 1,), (1,)), ((), ())),
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
    p = pref * ajp[..., None, :]
    aG = a_safe[..., 0] ** G  # (...,)
    carries = affine_scan(jnp.broadcast_to(aG[..., None], sh + (nC,)),
                          p[..., -1], s0)
    prev = jnp.concatenate([s0[..., None], carries[..., :-1]], axis=-1)
    s = p + prev[..., None] * (a_safe[..., 0, None] * ajp)[..., None, :]
    s = s.reshape(sh + (T,))
    # exact zero coefficients: s[n] = b[n] (instant) — restore after the
    # clamped compute so mixed zero/nonzero channel populations stay exact
    return jnp.where((a_ch == 0.0)[..., None], b, s)


def maxdecay_scan_const(a_ch, v, s0):
    """s[n] = max(a*s[n-1], v[n]) with a CONSTANT along time (a_ch (...,)).
    Global-rescale form: s = a^n * cummax(v * a^{-n}), the s0 seed folded
    into n=0. Caller must have verified ``maxdecay_const_ok`` for this T."""
    T = v.shape[-1]
    n = jnp.arange(T, dtype=jnp.float32)
    a = a_ch[..., None]
    an = a ** n
    w = v * (a ** (-n))
    w = w.at[..., 0].set(jnp.maximum(w[..., 0], s0 * a_ch))
    return lax.cummax(w, axis=w.ndim - 1) * an  # lax.cummax: no negative axes
