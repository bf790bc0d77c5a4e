"""IIR biquad cascades as associative scans (SURVEY.md §2.1 #7, §7 #1).

The reference's CMSIS-DSP `arm_biquad_cascade_df1` channel filters are
per-sample recursions; the OLS FFT engine replaces them for channel
filtering, but IIR parity matters for tone controls / de-emphasis and for
recalibrating against firmware coefficient tables. Block formulation:
direct-form-II-transposed state space

    s[n] = A s[n-1] + B u[n],   y[n] = C s[n] + D u[n]

with 2x2 A — the affine recurrence composes associatively over
(matrix, vector) pairs, so a whole block runs in O(log T) depth.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def _compose(left, right):
    Al, bl = left
    Ar, br = right
    # state maps: s -> Ar @ (Al @ s + bl) + br
    # HIGHEST: a default-precision einsum may run in TF32 (bf16 on some
    # accelerators) — composed 2x2 state maps feed an
    # IIR whose poles sit near |z|=1, where mantissa loss turns into drift
    return (jnp.einsum("...ij,...jk->...ik", Ar, Al, precision="highest"),
            jnp.einsum("...ij,...j->...i", Ar, bl, precision="highest") + br)


class Biquad:
    """One biquad section (b0,b1,b2,a1,a2), batched over channels.

    Transposed direct form II:
        y[n]  = b0 x[n] + s1[n-1]
        s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
        s2[n] = b2 x[n] - a2 y[n]
    State s = (s1, s2) follows s[n] = A s[n-1] + B x[n] with
        A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0, b2 - a2 b0].
    """

    def __init__(self, b, a):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        assert b.shape == (3,) and a.shape == (3,)
        b = b / a[0]
        a = a / a[0]
        self.b0 = float(b[0])
        self.A = np.array([[-a[1], 1.0], [-a[2], 0.0]], dtype=np.float32)
        self.B = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]], dtype=np.float32)
        self.C = np.array([1.0, 0.0], dtype=np.float32)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, 2), dtype=jnp.float32)

    def __call__(self, s0, x):
        """(s0 (C, 2), x (C, T) f32) -> (y, s_end)."""
        C_, T = x.shape
        A = jnp.broadcast_to(jnp.asarray(self.A), (C_, T, 2, 2))
        bvec = x[..., None] * jnp.asarray(self.B)  # (C, T, 2)
        As, bs = lax.associative_scan(_compose, (A, bvec), axis=1)
        # s[n] = As[n] @ s0 + bs[n]
        s = jnp.einsum("ctij,cj->cti", As, s0, precision="highest") + bs
        s_prev = jnp.concatenate([s0[:, None, :], s[:, :-1, :]], axis=1)
        y = self.b0 * x + s_prev[..., 0]
        return y, s[:, -1, :]


class BiquadCascade:
    """Cascade of sections (scipy sos layout, shape (n_sections, 6))."""

    def __init__(self, sos):
        sos = np.asarray(sos, dtype=np.float64)
        self.sections = [Biquad(s[:3], s[3:]) for s in sos]

    def init_state(self, num_channels: int):
        return tuple(b.init_state(num_channels) for b in self.sections)

    def __call__(self, state, x):
        new_states = []
        for bq, st in zip(self.sections, state):
            x, st2 = bq(st, x)
            new_states.append(st2)
        return x, tuple(new_states)
