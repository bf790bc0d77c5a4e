"""AGC — attack / release / hang automatic gain control, per-mode constants.

Reference analog: `[U:agc.c]` per-sample attack/release/hang loop with
per-mode time constants (SURVEY.md §2.1 #8). Block formulation per
BASELINE.json north_star ("per-sample recursions become associative
scans"), three vectorized stages, each exactly equal to the golden
per-sample definition (``golden.model.agc_full``):

  1. hang   — sliding-window max of |x| over the hang window (van Herk /
              Gil-Werman: two cummax passes, O(T) work, any window size);
  2. release — env_r[n] = max(m[n], release_decay * env_r[n-1]) as the
              max-decay associative scan. Combined with (1) this equals
              env_r[n] = max_j |x[j]| * g(n-j) where g holds peaks flat for
              the hang time, then decays exponentially — the hang timer.
  3. attack — env[n] = a*env[n-1] + (1-a)*env_r[n], a one-pole affine scan
              with the attack time constant (a=0: instant attack).

Gain = clip(target / env, <= max_gain). Per-mode constants are dense
(n_modes,) tables gathered by the runtime ``mode`` input, so retuning a
channel's mode never recompiles — same design as the demod bank.

``apply`` (instant-attack, release-only) remains for the TX speech
compressor and as the simple core primitive.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from radioframe.ops.scans import affine_scan, maxdecay_scan


def release_decay(release_s: float, fs: float) -> float:
    """Per-sample decay for a given release time constant (seconds)."""
    return float(np.exp(-1.0 / (release_s * fs)))


def attack_alpha(attack_s: float, fs: float) -> float:
    """One-pole coefficient for the attack time constant (0 = instant)."""
    if attack_s <= 0.0:
        return 0.0
    return float(np.exp(-1.0 / (attack_s * fs)))


def hang_samples(hang_s: float, fs: float) -> int:
    """Hang time in whole samples at fs."""
    return max(0, int(round(hang_s * fs)))


def init_state(num_channels: int):
    return jnp.zeros((num_channels,), dtype=jnp.float32)


def apply(env0, x, decay: float, target: float = 1.0, max_gain: float = 1e4, eps: float = 1e-9):
    """Instant-attack / exp-release AGC. (env0 (C,), x (C, T)) -> (y, new_env, gain)."""
    from radioframe.ops.scans import maxdecay_const_ok, maxdecay_scan_const

    mag = jnp.abs(x).astype(jnp.float32)
    if maxdecay_const_ok([decay], mag.shape[-1]):
        env = maxdecay_scan_const(jnp.full(mag.shape[:-1], jnp.float32(decay)),
                                  mag, env0)
    else:
        env = maxdecay_scan(jnp.full_like(mag, jnp.float32(decay)), mag, env0)
    gain = jnp.minimum(jnp.float32(max_gain), jnp.float32(target) / jnp.maximum(env, jnp.float32(eps)))
    y = x * gain.astype(x.dtype)
    return y, env[:, -1], gain


def sliding_max(xp, T: int, W: int):
    """m[t] = max(xp[..., t : t+W]) for t in [0, T); xp (..., T+W-1).

    Van Herk / Gil-Werman: pad to a multiple of W, one forward cummax and
    one backward cummax per W-chunk, then every window max is the max of
    one suffix value and one prefix value — O(T) total, fully vectorized,
    any window size (including W > T, the streaming-history case).
    """
    if W == 1:
        return xp[..., -T:]
    P = xp.shape[-1]
    assert P == T + W - 1, (P, T, W)
    P2 = -(-P // W) * W
    off = P2 - P
    pad = [(0, 0)] * (xp.ndim - 1) + [(off, 0)]
    x2 = jnp.pad(xp, pad, constant_values=-np.inf)
    blocks = x2.reshape(x2.shape[:-1] + (P2 // W, W))
    pre = lax.cummax(blocks, axis=blocks.ndim - 1)
    suf = jnp.flip(lax.cummax(jnp.flip(blocks, -1), axis=blocks.ndim - 1), -1)
    R = pre.reshape(x2.shape)   # R[i] = max(chunk_start..i)
    S = suf.reshape(x2.shape)   # S[i] = max(i..chunk_end)
    # window [i, i+W-1] in x2 coords, i = off + t: max(S[i], R[i+W-1])
    return jnp.maximum(S[..., off : off + T], R[..., off + W - 1 :])


class AgcBank:
    """Per-mode attack/release/hang AGC over (C, T) audio blocks.

    Built from one AgcConfig per demod mode code (SSB/CW/AM/NFM/LSB/SAM);
    the runtime (C,) ``mode`` input gathers each channel's constants from
    dense tables. Distinct hang windows are computed once each (like the
    demod bank: dense over the handful of distinct windows, masked select).

    State: {"hist": (C, Wmax-1) recent |audio|, "env": (C,) release env,
    "lpf": (C,) attack-smoothed env}. Streaming-exact across block splits.
    """

    def __init__(self, mode_cfgs, fs: float):
        self.n_modes = len(mode_cfgs)
        self.release = np.array([release_decay(c.release_s, fs) for c in mode_cfgs], np.float32)
        self.alpha = np.array([attack_alpha(c.attack_s, fs) for c in mode_cfgs], np.float32)
        self.target = np.array([c.target for c in mode_cfgs], np.float32)
        self.max_gain = np.array([c.max_gain for c in mode_cfgs], np.float32)
        wins = [hang_samples(c.hang_s, fs) + 1 for c in mode_cfgs]  # window incl. current
        self.distinct_W = sorted(set(wins))
        self.win_index = np.array([self.distinct_W.index(w) for w in wins], np.int32)
        self.Wmax = max(wins)
        self.hist_len = self.Wmax - 1  # == halo size under time sharding

    def init_state(self, num_channels: int):
        # hist is () when no mode has hang (no 0-size leaves in the state;
        # () matches the chains' disabled-feature state convention)
        hist = (jnp.zeros((num_channels, self.hist_len), jnp.float32)
                if self.hist_len else ())
        return {
            "hist": hist,
            "env": jnp.zeros((num_channels,), jnp.float32),
            "lpf": jnp.zeros((num_channels,), jnp.float32),
        }

    # -- pieces shared by the unsharded and sharded paths --------------------

    def hang_select(self, xp, T: int, mode):
        """Per-channel hang sliding max. xp (C, T+Wmax-1) = [hist | mag]."""
        if len(self.distinct_W) == 1:
            return sliding_max(xp, T, self.distinct_W[0])
        ms = jnp.stack([sliding_max(xp[..., self.Wmax - W :], T, W)
                        for W in self.distinct_W])  # (nW, C, T)
        widx = jnp.take(jnp.asarray(self.win_index), mode)  # (C,)
        return jnp.take_along_axis(ms, widx[None, :, None], axis=0)[0]

    def per_channel(self, mode):
        """Gather (release, alpha, target, max_gain) as (C,) arrays."""
        return (jnp.take(jnp.asarray(self.release), mode),
                jnp.take(jnp.asarray(self.alpha), mode),
                jnp.take(jnp.asarray(self.target), mode),
                jnp.take(jnp.asarray(self.max_gain), mode))

    def gain_from_env(self, env, mode, eps: float = 1e-9):
        _, _, tgt, mg = self.per_channel(mode)
        return jnp.minimum(mg[:, None], tgt[:, None] / jnp.maximum(env, jnp.float32(eps)))

    # -- the unsharded block op ----------------------------------------------

    def apply(self, state, audio, mode):
        """(state, audio (C, T) f32, mode (C,) i32) -> (y, new_state, gain)."""
        from radioframe.ops.scans import (affine_const_ok, affine_scan_const,
                                          maxdecay_const_ok, maxdecay_scan_const)

        C, T = audio.shape
        mag = jnp.abs(audio).astype(jnp.float32)
        xp = jnp.concatenate([state["hist"], mag], axis=-1) if self.hist_len else mag
        m = self.hang_select(xp, T, mode)
        rel, al, _, _ = self.per_channel(mode)
        # constant-coefficient fast paths (ops/scans.py round-3 note): the
        # static tables decide the formulation, so any runtime mode mix is
        # covered by the chosen path
        if maxdecay_const_ok(self.release, T):
            env_r = maxdecay_scan_const(rel, m, state["env"])
        else:
            env_r = maxdecay_scan(jnp.broadcast_to(rel[:, None], mag.shape),
                                  m, state["env"])
        if not self.alpha.any():
            env = env_r  # instant attack everywhere: the one-pole is identity
        elif affine_const_ok(self.alpha):
            env = affine_scan_const(al, (1.0 - al)[:, None] * env_r, state["lpf"])
        else:
            env = affine_scan(jnp.broadcast_to(al[:, None], mag.shape),
                              (1.0 - al)[:, None] * env_r, state["lpf"])
        gain = self.gain_from_env(env, mode)
        new_hist = xp[:, xp.shape[-1] - self.hist_len :] if self.hist_len else ()
        new_state = {"hist": new_hist, "env": env_r[:, -1], "lpf": env[:, -1]}
        return audio * gain, new_state, gain
