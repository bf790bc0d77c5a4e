"""Streaming FIR interpolator (zero-stuff by L + anti-image FIR) — the DUC
upsampling stage (SURVEY.md §2.1 #10), adjoint of ops/fir.FirDecimator.

Semantics match golden ``interpolate``: u[mL] = x[m] (else 0),
y[n] = sum_k h[k] u[n-k]; a block of T inputs yields T*L outputs
y[n0 .. n0+T*L-1]. State = last ceil((Lh-1)/L) input samples.

Formulation (round 3): EXPLICIT polyphase y[qL + p] = sum_j h[jL + p]
x[q - j] as ONE contraction — the J+1 shifted INPUT-rate views are
stacked (1/L the output bytes, ~free) and contracted against the (J+1, L)
polyphase tap matrix, so the output-rate array is written exactly once.
Two variants were rejected: the ``lhs_dilation`` conv runs all Lh taps at
the DILATED rate (XLA does not polyphase-optimize transposed convs), and
a J+1-term broadcast-accumulate makes XLA materialize the (C, T, L)
accumulator once per term.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


class FirInterpolator:
    def __init__(self, taps: np.ndarray, L: int):
        taps = np.asarray(taps)
        assert not np.iscomplexobj(taps), "interpolator taps are real"
        self.L = int(L)
        self.Lh = len(taps)
        self.tin = -(-(self.Lh - 1) // self.L)  # ceil((Lh-1)/L) carried inputs
        # polyphase components: w[j, p] = h[jL + p], zero-padded
        J1 = self.tin + 1
        wp = np.zeros((J1 * self.L,), np.float64)
        wp[: self.Lh] = np.asarray(taps, np.float64)
        self._w = np.ascontiguousarray(wp.reshape(J1, self.L).astype(np.float32))

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, self.tin), dtype=jnp.complex64)

    def __call__(self, tail, x):
        """(tail (C, tin), x (C, T)) -> (y (C, T*L), new_tail)."""
        C, T = x.shape
        xp = jnp.concatenate([tail, x], axis=-1)  # (C, tin + T)
        # one (J+1)-deep contraction: gathering the J+1 shifted
        # INPUT-rate views costs ~nothing (input is 1/L the output bytes),
        # and the matmul writes the output-rate array exactly once — the
        # K-term broadcast-accumulate variant made XLA materialize the
        # (C, T, L) accumulator once per term
        cols = [xp[:, self.tin - j: self.tin - j + T] for j in range(self.tin + 1)]
        X = jnp.stack(cols, axis=-1)  # (C, T, J+1)
        w = jnp.asarray(self._w)      # (J+1, L)
        dn = (((2,), (0,)), ((), ()))
        yr = lax.dot_general(jnp.real(X), w, dn,
                             precision=lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        yi = lax.dot_general(jnp.imag(X), w, dn,
                             precision=lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        y = lax.complex(yr, yi).reshape(C, T * self.L)
        new_tail = xp[:, xp.shape[-1] - self.tin :]
        return y, new_tail


def cic_interpolator(L: int, N: int, M: int = 1) -> FirInterpolator:
    """CIC interpolator in its FIR-equivalent block form — the DUC's bulk
    interpolation stage, exact adjoint of ``ops.fir.cic_decimator``
    (SURVEY.md §2.1 #10, the FPGA DUC's comb->zero-stuff->integrator chain).

    Zero-stuff by L then boxcar^N ((1-z^-LM)/(1-z^-1))^N — same operator as
    the comb/integrator structure, bounded state (no fp32 integrator growth).
    Taps are scaled to DC gain L so a unit-amplitude baseband stays unit
    amplitude at the DAC rate; passband sinc^N droop is pre-compensated in
    the preceding FIR stage (filter_design.compensated_interp_taps).
    """
    from radioframe.ops.filter_design import cic_equivalent_taps

    return FirInterpolator(cic_equivalent_taps(L, N, M, norm=True) * L, L)
