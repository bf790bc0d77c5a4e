"""Interference-fighting DSP: noise reduction, noise blanker, auto-notch, VAD.

Reference analogs (SURVEY.md §2.1 #12/#13): `[U:noise_reduction.c]` (FFT
spectral subtraction), `[U:noise_blanker.c]` (impulse blanker),
`[U:auto_notch.c]` (LMS notch), `[U:vad.c]`. Block forms:

- SpectralNR: frame-FFT spectral subtraction with a minima-tracking noise
  estimate per bin (EMA state). Frequency-domain gain, batched over channels.
- NoiseBlanker: running-power envelope via affine scan; samples whose
  magnitude exceeds k*rms are zeroed (impulse excision before narrow
  filtering rings them out).
- AutoNotch: persistent narrowband peaks tracked by a per-bin magnitude EMA
  are nulled in the frequency domain — the block-parallel replacement for the
  reference's per-sample LMS notch (a sequential recurrence that would fight
  the vector units; the spectral notch kills steady carriers the same way).
- vad: per-frame energy + spectral-flatness voice activity flag.

All frame ops use non-overlapping rectangular frames: artifact-acceptable
v1, exact streaming semantics (frame boundaries at multiples of nfft).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from radioframe.ops.scans import affine_scan


def _frames(x, nfft):
    C, T = x.shape
    assert T % nfft == 0, f"block length {T} must be a multiple of nfft={nfft}"
    return x.reshape(C, T // nfft, nfft)


class SpectralNR:
    """FFT-domain spectral subtraction. State: per-bin noise estimate (C, nfft)."""

    def __init__(self, nfft: int = 256, beta: float = 1.5, floor: float = 0.1,
                 bias: float = 1.0, up: float = 1.1):
        self.nfft = nfft
        self.beta, self.floor = float(beta), float(floor)
        self.bias, self.up = float(bias), float(up)

    def init_state(self, num_channels: int):
        return jnp.full((num_channels, self.nfft), 1e3, dtype=jnp.float32)

    def __call__(self, noise_est, x, voice=None):
        """``voice``: optional (C, F) per-frame voice-activity flags (from
        ``Vad`` at the same nfft). Voice-active frames are EXCLUDED from the
        noise-estimate update — the `[U:vad.c]` gating: speech must not be
        learned as noise. With every frame active the estimate freezes
        (no ``up`` growth either)."""
        X = jnp.fft.fft(_frames(x, self.nfft), axis=-1)
        mag = jnp.abs(X).astype(jnp.float32)

        # minimum-statistics noise estimate: the per-bin min over the block's
        # frames tracks the noise floor under intermittent signal; follow it
        # down instantly (min), up slowly (factor ``up`` per block). The min
        # of F iid Rayleigh magnitudes sits ~sqrt(F) below the mean — scale
        # it back up so ``est`` approximates the mean noise magnitude.
        F = mag.shape[1]
        if voice is None:
            block_min = jnp.min(mag, axis=1)  # (C, nfft)
            est = jnp.minimum(noise_est * self.up,
                              block_min * (self.bias * float(np.sqrt(F))))
        else:
            inf = jnp.float32(np.inf)
            block_min = jnp.min(jnp.where(voice[:, :, None], inf, mag), axis=1)
            any_quiet = jnp.any(~voice, axis=1)[:, None]  # (C, 1)
            cand = jnp.minimum(noise_est * self.up,
                               block_min * (self.bias * float(np.sqrt(F))))
            est = jnp.where(any_quiet, cand, noise_est)  # all-voice: freeze
        gain = jnp.clip(1.0 - self.beta * est[:, None, :] / jnp.maximum(mag, 1e-9),
                        self.floor, 1.0)
        y = jnp.fft.ifft(X * gain, axis=-1)
        C, F, N = y.shape
        return y.reshape(C, F * N).astype(x.dtype), est


class NoiseBlanker:
    """Impulse blanker. State: running mean power (C,)."""

    def __init__(self, threshold: float = 6.0, avg_pole: float = 0.999):
        # 6x rms: voice crest factor reaches ~4-5, real impulses are >>10x
        self.k2 = float(threshold) ** 2
        self.pole = float(avg_pole)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels,), dtype=jnp.float32)

    def __call__(self, power_est, x):
        p = jnp.abs(x).astype(jnp.float32) ** 2
        avg = affine_scan(jnp.full_like(p, jnp.float32(self.pole)),
                          (1.0 - self.pole) * p, power_est)
        mask = p > self.k2 * jnp.maximum(avg, 1e-12)
        y = jnp.where(mask, jnp.zeros((), x.dtype), x)
        return y, avg[:, -1]


class AutoNotch:
    """Spectral auto-notch for steady carriers. State: per-bin EMA (C, nfft).

    A carrier is a *local* spectral peak: the EMA magnitude at its bin far
    exceeds the mean of the surrounding ±W bins. (A global median test would
    also notch a smooth voice band sitting over a quiet spectrum.)
    """

    def __init__(self, nfft: int = 256, ema: float = 0.9, ratio: float = 8.0,
                 neighborhood: int = 3):
        # neighborhood must be narrower than half the narrowest voice band
        # (13 bins at 256/48k) or band bins read as peaks over empty spectrum;
        # a carrier is 1-2 bins, so +-3 discriminates cleanly
        self.nfft = nfft
        self.ema = float(ema)
        self.ratio = float(ratio)
        self.W = int(neighborhood)

    def init_state(self, num_channels: int):
        return jnp.zeros((num_channels, self.nfft), dtype=jnp.float32)

    def __call__(self, mag_ema, x):
        X = jnp.fft.fft(_frames(x, self.nfft), axis=-1)
        mag = jnp.abs(X).astype(jnp.float32)
        new_ema = self.ema * mag_ema + (1.0 - self.ema) * jnp.mean(mag, axis=1)
        # circular local background: mean of ±W neighbors excluding self
        bg = sum(jnp.roll(new_ema, s, axis=-1)
                 for s in range(-self.W, self.W + 1) if s != 0) / (2 * self.W)
        notch = new_ema > self.ratio * jnp.maximum(bg, 1e-9)
        y = jnp.fft.ifft(X * jnp.where(notch[:, None, :], 0.0, 1.0), axis=-1)
        C, F, N = y.shape
        return y.reshape(C, F * N).astype(x.dtype), new_ema


def vad(x, nfft: int = 256, energy_ratio: float = 3.0, flatness_max: float = 0.5):
    """Per-frame voice-activity flags (C, F) from energy + spectral flatness.

    Energy reference is the 20th-percentile frame (the quiet floor), not the
    median — with ~50% duty signals the median sits inside the active
    population and would mask everything. (Stateless, whole-block form; the
    streaming chain uses :class:`Vad`.)
    """
    X = jnp.fft.fft(_frames(x, nfft), axis=-1)
    p = jnp.abs(X) ** 2 + 1e-12
    energy = jnp.mean(p, axis=-1)  # (C, F)
    floor_energy = jnp.quantile(energy, 0.2, axis=-1, keepdims=True)
    flat = jnp.exp(jnp.mean(jnp.log(p), axis=-1)) / energy  # geometric/arith
    return (energy > energy_ratio * floor_energy) & (flat < flatness_max)


class Vad:
    """Streaming voice-activity detector (`[U:vad.c]` analog).

    State: per-channel quiet-floor energy (C,), minimum-statistics tracked
    like SpectralNR's noise estimate — follow the block-min frame energy down
    instantly, rise slowly (factor ``up`` per block). A frame is voice-active
    when its energy exceeds ``energy_ratio``x the floor AND its spectral
    flatness is below ``flatness_max`` (structured, not broadband, signal).
    In the chain the flags gate SpectralNR's noise-estimate update.
    """

    def __init__(self, nfft: int = 256, energy_ratio: float = 3.0,
                 flatness_max: float = 0.5, up: float = 1.1):
        self.nfft = nfft
        self.ratio = float(energy_ratio)
        self.flat_max = float(flatness_max)
        self.up = float(up)

    def init_state(self, num_channels: int):
        # start HIGH: the first block's min snaps it down (min-statistics),
        # and until then nothing is flagged voice — NR learns freely
        return jnp.full((num_channels,), 1e6, dtype=jnp.float32)

    def __call__(self, floor, x):
        """(floor (C,), x (C, T)) -> (voice flags (C, F) bool, new floor)."""
        X = jnp.fft.fft(_frames(x, self.nfft), axis=-1)
        p = jnp.abs(X).astype(jnp.float32) ** 2 + 1e-12
        energy = jnp.mean(p, axis=-1)  # (C, F)
        new_floor = jnp.minimum(floor * self.up, jnp.min(energy, axis=-1))
        flat = jnp.exp(jnp.mean(jnp.log(p), axis=-1)) / energy
        active = (energy > self.ratio * new_floor[:, None]) & (flat < self.flat_max)
        return active, new_floor
