"""Polyphase filterbank channelizer (SURVEY.md §7 P6; BASELINE config 5).

The batched answer to "thousands of channels": instead of N independent
NCO+decimator chains (N x input-rate work), an M-channel critically-sampled
PFB does one depthwise polyphase FIR over frames plus one batched M-point
DFT per frame — O(K + log M) work per input sample regardless of channel
count, all of it XLA-friendly (grouped conv + batched FFT).

Channel c (0..M-1) is centered at +c*fs/M, output rate fs/M. Matches golden
``pfb_channelize`` (DFT across type-1 polyphase components).

Streaming state: the last K-1 input frames (flattened, (B, (K-1)*M)).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from radioframe.ops.filter_design import pfb_prototype_taps


class PfbChannelizer:
    def __init__(self, num_channels: int, taps_per_channel: int = 8, window: str = "hamming"):
        self.M = int(num_channels)
        self.K = int(taps_per_channel)
        proto = pfb_prototype_taps(self.M, self.K, window)
        # (K, M) tap rows, frame t of the polyphase accumulation
        self._h = np.ascontiguousarray(proto.reshape(self.K, self.M).astype(np.float32))

    def init_state(self, batch: int = 1):
        return jnp.zeros((batch, (self.K - 1) * self.M), dtype=jnp.complex64)

    def __call__(self, tail, x):
        """(tail (B, (K-1)*M), x (B, T)) -> (y (B, M, F), new_tail).

        T must be a multiple of M; F = T // M output frames per channel.
        y[b, c, f] is channel c's stream at rate fs/M.

        Formulation: the polyphase accumulation runs as K shifted
        multiply-adds on separate f32 re/im planes in frame-major (B, F, M)
        layout — XLA fuses all K terms into one pass — and the M-point FFT
        (cuFFT on a GPU) then runs on the CONTIGUOUS last axis. One
        (B, M, F) transpose at the end keeps the channel-major contract for
        the demod bank.
        """
        B, T = x.shape
        assert T % self.M == 0, f"block length {T} must be a multiple of M={self.M}"
        F = T // self.M
        K, M = self.K, self.M
        # split planes BEFORE the concat: when the caller built x from f32
        # planes (the bench/ingest path), real(complex(a,b)) simplifies to a
        # and the big block never materializes as interleaved c64
        frr = jnp.concatenate([jnp.real(tail), jnp.real(x)], axis=-1
                              ).reshape(B, F + K - 1, M)
        fri = jnp.concatenate([jnp.imag(tail), jnp.imag(x)], axis=-1
                              ).reshape(B, F + K - 1, M)
        h = self._h
        ur = jnp.zeros((B, F, M), jnp.float32)
        ui = jnp.zeros((B, F, M), jnp.float32)
        # u[f, p] = sum_t h[t, p] * frames[f + K-1-t, p] (type-1 polyphase)
        for t in range(K):
            w = h[t][None, None, :]
            ur = ur + w * frr[:, K - 1 - t: K - 1 - t + F]
            ui = ui + w * fri[:, K - 1 - t: K - 1 - t + F]
        # DFT across phases (type-1 polyphase -> channel c at +c*fs/M)
        y = jnp.fft.fft(lax.complex(ur, ui), axis=-1)  # (B, F, M), contiguous
        y = jnp.moveaxis(y, -1, 1).astype(jnp.complex64)  # (B, M, F)
        # tail = last (K-1)*M input samples, complexified from the SLICED
        # frames only (complexifying the whole block would re-materialize
        # the interleaved c64 array the planes split exists to avoid)
        new_tail = lax.complex(frr[:, F:], fri[:, F:]).reshape(
            B, (self.K - 1) * self.M)
        return y, new_tail
