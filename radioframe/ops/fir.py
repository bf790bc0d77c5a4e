"""Streaming FIR filtering/decimation on (channels, time) complex blocks.

Replaces the reference's FPGA polyphase/compensation FIR stages and
CMSIS-DSP arm_fir calls (SURVEY.md §2.1 #3/#4). Complex arithmetic is
decomposed into real convolutions so XLA lowers them to its convolution
path; the Triton front end (radioframe/kernels) swaps in underneath the first
stages without changing this op's contract.

Semantics match golden ``fir_decimate`` (radioframe/golden/model.py): causal
y_full[n] = sum_k h[k] x[n-k], emitted at n = 0, R, 2R, ...; block length
must be a multiple of R so the decimation phase is static (enforced at trace
time) and the carried state is just the last L-1 input samples.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


class FirDecimator:
    """Host-side parameter container; apply() is traceable/jittable."""

    def __init__(self, taps: np.ndarray, R: int = 1):
        taps = np.asarray(taps)
        self.R = int(R)
        self.L = len(taps)
        self.tail_len = self.L - 1  # carried input samples == halo size
        self.complex_taps = np.iscomplexobj(taps)
        w = taps[::-1]  # correlation kernel: y[m] = sum_k w[k] xp[mR + k]
        if self.complex_taps:
            wr = np.real(w).astype(np.float32)
            wi = np.imag(w).astype(np.float32)
            # rhs[o, i, k]: out_r = xr*wr - xi*wi ; out_i = xr*wi + xi*wr
            self._rhs = np.stack(
                [np.stack([wr, -wi]), np.stack([wi, wr])]
            )  # (2, 2, L)
        else:
            # grouped conv: re/im as 2 feature groups sharing the same taps —
            # keeps channels as the (shardable) batch axis, no reshapes
            wr = w.astype(np.float32)
            self._rhs = np.stack([wr, wr])[:, None, :]  # (2, 1, L)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, self.L - 1), dtype=jnp.complex64)

    def __call__(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (C, T//R), new_tail)."""
        C, T = x.shape
        assert T % self.R == 0, f"block length {T} must be a multiple of R={self.R}"
        xp = jnp.concatenate([tail, x], axis=-1)  # (C, T + L - 1)
        rhs = jnp.asarray(self._rhs)
        dn = ("NCH", "OIH", "NCH")
        if self.complex_taps:
            lhs = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=1)  # (C, 2, Tp)
            out = lax.conv_general_dilated(
                lhs, rhs, window_strides=(self.R,), padding="VALID",
                dimension_numbers=dn, preferred_element_type=jnp.float32,
                # default precision may drop to TF32/bf16 on an
                # accelerator; DSP accuracy needs f32
                precision=lax.Precision.HIGHEST,
            )  # (C, 2, M)
            y = lax.complex(out[:, 0, :], out[:, 1, :])
        else:
            lhs = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=1)  # (C, 2, Tp)
            out = lax.conv_general_dilated(
                lhs, rhs, window_strides=(self.R,), padding="VALID",
                dimension_numbers=dn, feature_group_count=2,
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST,  # see above: f32, not bf16
            )  # (C, 2, M)
            y = lax.complex(out[:, 0, :], out[:, 1, :])
        new_tail = xp[:, xp.shape[-1] - (self.L - 1):] if self.L > 1 else xp[:, :0]
        return y, new_tail


def cic_decimator(R: int, N: int, M: int = 1) -> FirDecimator:
    """CIC decimator in its normative FIR-equivalent block form.

    See golden ``cic_decimate`` and SURVEY.md §7 hard-part #2: boxcar^N
    convolution + downsample is the same operator as the integrator/comb
    chain, without unbounded fp32 integrator growth; carried state is the
    N*(R*M-1)-sample tail, which is also the halo payload under time sharding.
    """
    from radioframe.ops.filter_design import cic_equivalent_taps

    return FirDecimator(cic_equivalent_taps(R, N, M, norm=True), R)
