"""Overlap-save FFT convolution engine (SURVEY.md §2.1 #7).

The reference's per-mode channel filters (CMSIS-DSP FIR/biquad cascades,
`[U:audio_filters.c]`) become one frequency-domain engine: FFT frames of the
IQ stream, multiply by the filter's frequency response, IFFT, discard the
wrap-around prefix. Golden semantics = plain streaming convolution
(golden ``ols_filter``). XLA's batched FFT (cuFFT on a GPU) runs it;
frames across channels batch into one FFT call.

Also the substrate for FFT-domain noise reduction (ops/nr.py), which shares
the same frames.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _overlapped_frames(xp, F: int, S: int, nfft: int):
    """(C, F*S + nfft - S) -> (C, F, nfft) frames at hop S.

    When S divides nfft the overlap factor m = nfft/S is an integer and the
    frames are a concatenation of m hop-strided segment views — pure
    reshapes/slices, no gather. Falls back to a gather for irregular
    geometries.
    """
    C = xp.shape[0]
    if nfft % S == 0:
        m = nfft // S
        n_seg = F + m - 1
        segs = xp[:, : n_seg * S].reshape(C, n_seg, S)
        return jnp.concatenate([segs[:, i : i + F, :] for i in range(m)], axis=-1)
    idx = (jnp.arange(F)[:, None] * S + jnp.arange(nfft)[None, :])
    return xp[:, idx]


class OverlapSave:
    """Streaming OLS filter. State = last L-1 input samples per channel.

    hop S = nfft - (L-1) output samples come out of each frame; block length
    T must be a multiple of S (checked at trace time; pick nfft so S | T).
    """

    def __init__(self, taps: np.ndarray, nfft: int | None = None, hop: int | None = None):
        taps = np.asarray(taps)
        self.L = len(taps)
        if nfft is None:
            if hop is None:
                hop = 1 << int(np.ceil(np.log2(max(4 * self.L, 256))))
            # power-of-2 FFT only: round up and widen the hop instead
            nfft = 1 << int(np.ceil(np.log2(hop + self.L - 1)))
        self.nfft = int(nfft)
        self.hop = self.nfft - (self.L - 1)
        assert self.hop > 0, "nfft must exceed taps length"
        self._H = np.fft.fft(taps.astype(np.complex128), self.nfft).astype(np.complex64)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, self.L - 1), dtype=jnp.complex64)

    def __call__(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (C, T), new_tail)."""
        C, T = x.shape
        S = self.hop
        assert T % S == 0, f"block length {T} must be a multiple of OLS hop {S}"
        F = T // S
        xp = jnp.concatenate([tail, x], axis=-1)  # (C, T + L - 1)
        # frame f covers xp[f*S : f*S + nfft]; need F*S + (nfft - S) samples
        pad = F * S + self.nfft - S - xp.shape[-1]
        if pad > 0:
            xp_f = jnp.pad(xp, ((0, 0), (0, pad)))
        else:
            xp_f = xp
        frames = _overlapped_frames(xp_f, F, S, self.nfft)  # (C, F, nfft)
        Y = jnp.fft.fft(frames, axis=-1) * jnp.asarray(self._H)
        y = jnp.fft.ifft(Y, axis=-1)[:, :, self.L - 1:]  # (C, F, S)
        y = y.reshape(C, T).astype(jnp.complex64)
        new_tail = xp[:, xp.shape[-1] - (self.L - 1):] if self.L > 1 else xp[:, :0]
        return y, new_tail


class OverlapSaveBank:
    """K filters over the same stream, one forward FFT (mode-filter bank).

    The RX chain runs the per-mode channel filters (SSB/CW/AM/NFM bandwidths)
    as one bank: frames are FFT'd once, multiplied by K responses, IFFT'd
    batched. State = single shared input tail. Output (K, C, T).
    """

    def __init__(self, taps_list, nfft: int | None = None, hop: int | None = None):
        L = max(len(t) for t in taps_list)
        self.L = L
        if nfft is None:
            if hop is None:
                hop = 1 << int(np.ceil(np.log2(max(4 * L, 256))))
            nfft = 1 << int(np.ceil(np.log2(hop + L - 1)))  # pow2 (see OverlapSave)
        self.nfft = int(nfft)
        self.hop = self.nfft - (L - 1)
        assert self.hop > 0
        H = [np.fft.fft(np.asarray(t).astype(np.complex128), self.nfft) for t in taps_list]
        self._H = np.stack(H).astype(np.complex64)  # (K, nfft)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, self.L - 1), dtype=jnp.complex64)

    def _frames(self, tail, x):
        C, T = x.shape
        S = self.hop
        assert T % S == 0, f"block length {T} must be a multiple of OLS hop {S}"
        F = T // S
        xp = jnp.concatenate([tail, x], axis=-1)
        pad = F * S + self.nfft - S - xp.shape[-1]
        xp_f = jnp.pad(xp, ((0, 0), (0, pad))) if pad > 0 else xp
        frames = jnp.fft.fft(_overlapped_frames(xp_f, F, S, self.nfft), axis=-1)  # (C, F, nfft)
        new_tail = xp[:, xp.shape[-1] - (self.L - 1):] if self.L > 1 else xp[:, :0]
        return frames, new_tail

    def __call__(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (K, C, T), new_tail)."""
        C, T = x.shape
        frames, new_tail = self._frames(tail, x)
        Y = frames[None] * jnp.asarray(self._H)[:, None, None, :]  # (K, C, F, nfft)
        y = jnp.fft.ifft(Y, axis=-1)[..., self.L - 1:]
        y = y.reshape(self._H.shape[0], C, T).astype(jnp.complex64)
        return y, new_tail

    def apply_selected(self, tail, x, row):
        """One filter per channel: (tail, x (C, T), row (C,) int32) -> (y (C, T), tail').

        Selects each channel's frequency response BEFORE the inverse FFT, so
        the bank costs one forward + ONE inverse FFT instead of K — the K-fold
        (K, C, F, nfft) intermediate never exists. Identical numerics to
        ``__call__`` followed by take_along_axis (the gather commutes with
        the linear IFFT).
        """
        C, T = x.shape
        frames, new_tail = self._frames(tail, x)
        Hc = jnp.take(jnp.asarray(self._H), row, axis=0)  # (C, nfft)
        y = jnp.fft.ifft(frames * Hc[:, None, :], axis=-1)[..., self.L - 1:]
        return y.reshape(C, T).astype(jnp.complex64), new_tail
