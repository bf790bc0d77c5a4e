"""NCO / complex mixer — int32 DDS phase accumulator, batched over channels.

A reimagining of the reference's FPGA DDS (SURVEY.md §2.1 #1): the
phase accumulator is a wrapping int32 (Q0.32 turns), exactly like DDS
hardware, so phase continuity across blocks is bit-exact forever — no fp32
phase drift on infinite streams. Frequency resolution is fs/2^32 (≈45 µHz at
192 kHz). Per-channel frequency is a runtime input (SURVEY.md §3.4: retune =
update one element, no recompile).

Layout: x is (channels, time) complex64; freq words (channels,) int32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

TWO_PI = 2.0 * np.pi
_SCALE = np.float32(2.0 ** -32)


def freq_word(freq_hz, fs) -> np.ndarray:
    """Host-side: frequency (Hz) -> int32 DDS increment (Q0.32 turns/sample)."""
    cycles = np.asarray(freq_hz, dtype=np.float64) / fs
    word = np.round((cycles - np.round(cycles)) * 2.0 ** 32)
    return word.astype(np.int64).astype(np.int32)  # wrap into int32


def word_to_freq(word, fs) -> np.ndarray:
    return np.asarray(word, dtype=np.float64) * fs / 2.0 ** 32


def init_state(num_channels: int):
    """Phase accumulator (turns, Q0.32), one per channel."""
    return jnp.zeros((num_channels,), dtype=jnp.int32)


_GROUP = 128  # oscillator factorization group size


def _osc(word, base_acc, T: int, sign: float):
    """e^{sign*j*2π*(base + word*n)/2^32} for n in [0, T) — factorized.

    sin/cos are the VPU's slowest ops; the DDS phase is affine in n, so the
    oscillator factorizes exactly (exp is 2π-periodic, int32 wrap included):

        osc[m*K + k] = exp(j·θ(base + word*K*m)) * exp(j·θ(word*k))

    cutting transcendental count from T to T/K + K per channel, replaced by
    one complex multiply per sample. Falls back to the direct form when K
    doesn't divide T.
    """
    C = int(np.broadcast_shapes(word.shape, base_acc.shape)[0])
    K = _GROUP
    s = np.float32(sign) * _SCALE * np.float32(TWO_PI)
    if T % K != 0 or T < 2 * K:
        n = jnp.arange(T, dtype=jnp.int32)
        ang = (base_acc[:, None] + word[:, None] * n[None, :]).astype(jnp.float32) * s
        return lax.complex(jnp.cos(ang), jnp.sin(ang))
    M = T // K
    m = jnp.arange(M, dtype=jnp.int32)
    k = jnp.arange(K, dtype=jnp.int32)
    coarse = (base_acc[:, None] + (word * jnp.int32(K))[:, None] * m[None, :]).astype(jnp.float32) * s
    fine = (word[:, None] * k[None, :]).astype(jnp.float32) * s
    e1 = lax.complex(jnp.cos(coarse), jnp.sin(coarse))  # (C, M)
    e2 = lax.complex(jnp.cos(fine), jnp.sin(fine))      # (C, K)
    osc = e1[:, :, None] * e2[:, None, :]               # (C, M, K)
    return osc.reshape(C, T)


def mix_down(x, word, phase_acc):
    """y = x * e^{-j phase}; returns (y, new_phase_acc).

    ``word`` per channel; a signal at +f Hz (word=freq_word(f, fs)) lands at DC.
    """
    T = x.shape[-1]
    osc = _osc(word, phase_acc, T, -1.0)
    new_acc = phase_acc + word * jnp.int32(T)  # wraps — exact continuity
    return x * osc.astype(x.dtype), new_acc


def mix_down_at(x, word, phase_acc, sample_offset):
    """mix_down evaluated at a (traced) int32 sample offset into the stream.

    Used by time-sharded chains: shard d computes its oscillator segment
    locally from the replicated phase state — no communication, exact
    (int32 wrap) agreement with the unsharded program. Does NOT advance the
    accumulator; the caller advances it once by the global block length.
    """
    T = x.shape[-1]
    base = phase_acc + word * sample_offset.astype(jnp.int32)
    return x * _osc(word, base, T, -1.0).astype(x.dtype)


def mix_up_at(x, word, phase_acc, sample_offset):
    """mix_up at a sample offset (see mix_down_at)."""
    T = x.shape[-1]
    base = phase_acc + word * sample_offset.astype(jnp.int32)
    return x * _osc(word, base, T, 1.0).astype(x.dtype)


def mix_up(x, word, phase_acc):
    """y = x * e^{+j phase} (DUC direction); returns (y, new_phase_acc)."""
    T = x.shape[-1]
    osc = _osc(word, phase_acc, T, 1.0)
    new_acc = phase_acc + word * jnp.int32(T)
    return x * osc.astype(x.dtype), new_acc
