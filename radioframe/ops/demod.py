"""Demodulators (SSB/CW/AM/NFM) + DC blocker, batched over channels.

Reference analog: the mode switch inside `[U:audio_processor.c]`
(SURVEY.md §2.1 #9). Shape: all demods are elementwise/scan ops on
(C, T) blocks; the *demod bank* evaluates all modes and selects per channel
with a mask (dense compute, EP-analog routing — SURVEY.md §2.3), so one jitted
program serves mixed-mode channel populations with no control flow.

Per-sample recursions (DC blocker, NFM de-emphasis) use the affine
associative scan from ops/scans.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from radioframe.ops import nco
from radioframe.ops.scans import affine_scan

# mode codes (used as per-channel selector in the bank)
SSB, CW, AM, NFM, LSB, SAM = 0, 1, 2, 3, 4, 5
MODE_NAMES = {"ssb": SSB, "usb": SSB, "cw": CW, "am": AM, "nfm": NFM,
              "lsb": LSB, "sam": SAM}


# --- DC blocker ------------------------------------------------------------


def dc_block_init(num_channels: int):
    # state: (x_prev, y_prev) per channel
    return jnp.zeros((2, num_channels), dtype=jnp.float32)


def dc_block(state, x, pole: float = 0.995):
    """y[n] = x[n] - x[n-1] + pole*y[n-1] on (C, T) real blocks."""
    from radioframe.ops.scans import affine_const_ok, affine_scan_const

    xprev = jnp.concatenate([state[0][:, None], x[:, :-1]], axis=-1)
    b = x - xprev
    if affine_const_ok([pole]):  # static — pole is a python float
        y = affine_scan_const(jnp.full(x.shape[:-1], jnp.float32(pole)), b, state[1])
    else:
        y = affine_scan(jnp.full_like(x, jnp.float32(pole)), b, state[1])
    new_state = jnp.stack([x[:, -1], y[:, -1]])
    return y, new_state


# --- individual demods -----------------------------------------------------


def demod_ssb(x):
    return 2.0 * jnp.real(x)


_EXP_GROUP = 64


def _exp_neg_affine(a, w, T: int):
    """e^{-j(a + w·n)} for n in [0, T), float phases — factorized.

    Same trick as the DDS oscillator (nco._osc): the phase is affine in n,
    so exp factorizes into coarse x fine grids, cutting sin/cos count from
    T to T/K + K per channel (they are the VPU's slowest ops; at the 4096-
    channel channelizer's rates this dominates the demod bank). The coarse
    phase is wrapped mod 2π before cos/sin — same fp behavior as the direct
    form at large n.
    """
    C = int(np.broadcast_shapes(a.shape, w.shape)[0])
    K = _EXP_GROUP
    if T % K != 0 or T < 2 * K:
        n = jnp.arange(T, dtype=jnp.float32)
        ang = a[:, None] + w[:, None] * n[None, :]
        return jnp.exp(-1j * ang).astype(jnp.complex64)
    M = T // K
    m = jnp.arange(M, dtype=jnp.float32)
    k = jnp.arange(K, dtype=jnp.float32)
    coarse = jnp.mod(a[:, None] + (w * K)[:, None] * m[None, :],
                     jnp.float32(2.0 * np.pi))
    fine = w[:, None] * k[None, :]
    e1 = jnp.exp(-1j * coarse).astype(jnp.complex64)  # (C, M)
    e2 = jnp.exp(-1j * fine).astype(jnp.complex64)    # (C, K)
    return (e1[:, :, None] * e2[:, None, :]).reshape(C, T)


def demod_cw(phase_acc, x, tone_word):
    """Beat-tone shift via the DDS NCO (mix *up* by tone_hz); returns (y, acc)."""
    y, acc = nco.mix_up(x, tone_word, phase_acc)
    return 2.0 * jnp.real(y), acc


def demod_am(dc_state, x, pole: float = 0.995):
    env = jnp.abs(x).astype(jnp.float32)
    return dc_block(dc_state, env, pole)


def demod_sam(dc_state, carrier_acc, x, fs: float):
    """Synchronous AM: block-wise carrier recovery + coherent detection.

    The reference's SAM uses a per-sample PLL (`[U:audio_processor.c]` [MED])
    — a nonlinear recurrence that fights vector hardware. Block formulation:
    estimate the residual carrier per block as the angle of the lag-1
    autocorrelation (a Kay/fitz frequency estimator, exact for a strong
    carrier), derotate coherently with phase continuity carried in
    ``carrier_acc`` (float32 radians/sample estimate + accumulated phase),
    then take Re{} and DC-block. Tracks mistuning within the AM passband.

    carrier_acc: (2, C) float32 — [0]=accumulated phase (rad), [1]=last
    estimated residual carrier (rad/sample; a tuning-error metric).
    Returns (audio, new_dc_state, new_carrier_acc).
    """
    C, T = x.shape
    # residual carrier frequency: angle of sum x[n] conj(x[n-1])
    r1 = jnp.sum(x[:, 1:] * jnp.conj(x[:, :-1]), axis=-1)
    w = jnp.arctan2(jnp.imag(r1), jnp.real(r1))  # rad/sample
    derot = x * _exp_neg_affine(carrier_acc[0], w, T)
    # align residual constant phase: rotate by mean phasor so carrier -> +Re
    mean = jnp.sum(derot, axis=-1)
    mean = mean / jnp.maximum(jnp.abs(mean), 1e-9)
    coherent = jnp.real(derot * jnp.conj(mean)[:, None])
    audio, new_dc = dc_block(dc_state, coherent.astype(jnp.float32))
    new_acc = jnp.stack([jnp.mod(carrier_acc[0] + w * T, jnp.float32(2.0 * np.pi)), w])
    return audio, new_dc, new_acc


def squelch(noise_state, audio, threshold: float = 0.5, pole: float = 0.5):
    """FM squelch: gate audio on the carrier-to-noise estimate.

    Classic FM squelch measures ultrasonic noise out of the discriminator;
    block form: noise metric = mean |d audio/dt| (discriminator HF energy),
    smoothed by a one-pole (affine scan across blocks via carried state).
    Returns (gated_audio, new_noise_state, open_mask (C,)).
    """
    hf = jnp.mean(jnp.abs(jnp.diff(audio, axis=-1)), axis=-1)  # (C,)
    smoothed = pole * noise_state + (1.0 - pole) * hf  # per-BLOCK one-pole
    is_open = smoothed < threshold
    return audio * is_open[:, None], smoothed, is_open


def demod_nfm(last, x, fs: float, deviation_hz: float):
    """y[n] = angle(x[n] conj(x[n-1])) * fs/(2π·dev); state = previous sample."""
    xprev = jnp.concatenate([last[:, None], x[:, :-1]], axis=-1)
    d = x * jnp.conj(xprev)
    y = jnp.arctan2(jnp.imag(d), jnp.real(d)) * jnp.float32(fs / (2.0 * np.pi * deviation_hz))
    return y, x[:, -1]


# --- demod bank ------------------------------------------------------------


def bank_init(num_channels: int):
    return {
        "cw_phase": nco.init_state(num_channels),
        "am_dc": dc_block_init(num_channels),
        "nfm_last": jnp.ones((num_channels,), dtype=jnp.complex64),
        "sam_dc": dc_block_init(num_channels),
        "sam_carrier": jnp.zeros((2, num_channels), dtype=jnp.float32),
    }


def filter_index(mode):
    """Mode code -> mode-filter bank row (SAM shares the AM filter)."""
    return jnp.where(mode == SAM, AM, mode).astype(jnp.int32)


def bank_apply(state, x, mode, cw_tone_word, fs: float, nfm_deviation_hz: float = 2500.0,
               enabled: tuple | None = None):
    """Run the demod bank, select per channel by ``mode`` (C,) int32.

    Dense evaluation + mask keeps the program static-shape and branch-free
    (SURVEY.md §2.3 mode-bank routing). ``enabled`` statically restricts
    which demods are COMPILED (None = all six): the reference's mode menu
    maps to config + cheap recompile, so a deployment that never uses SAM
    (the costliest demod: carrier recovery + derotation + DC scan) simply
    doesn't pay for it — unlike the reverted lax.cond runtime gating (NOTE
    below), a static subset has no control flow at all. Disabled modes'
    states pass through unchanged; channels selecting a disabled mode
    produce silence. Returns (audio (C, T) float32, new_state).
    """
    en = frozenset(range(SAM + 1)) if enabled is None else frozenset(map(int, enabled))
    # NOTE: a lax.cond-gated variant (skip demods whose mode is absent this
    # block) was tried in round 2 and REVERTED: inside the full chain
    # program the CPU thunk runtime produced schedule-dependent corrupted
    # blocks (~1% of samples, nondeterministic across processes; bisected
    # to the conds — tests/test_pipeline.py caught it), and it bought no
    # measurable time on the 4096-channel channelizer (the bank's cost is
    # scans + stack/select memory traffic, not the gated transcendentals).
    # Dense evaluation is the reliable shape here.
    # Round-3 re-examination (ADVICE r2 #1 asked): the "corrupted blocks"
    # are consistent with the SAME cold-start AGC amplification that made
    # test_pipeline flaky (near-zero OLS warm-up x max-gain magnifies
    # few-ulp fp differences ~1e7x), so the cond revert's correctness
    # argument is weaker than written — but its perf argument held up, and
    # the need is now served STATICALLY: ``enabled`` below removes unused
    # demods at trace time with no control flow at all.
    # Selection by masked SUM, not stack + take_along_axis: exactly one mask
    # is hot per channel so the result is bit-identical, but the wheres fuse
    # into the demod arithmetic — no (6, C, T) array is ever materialized.
    m = mode[:, None]
    sel = jnp.zeros(x.shape, jnp.float32)
    cw_phase, am_dc = state["cw_phase"], state["am_dc"]
    nfm_last = state["nfm_last"]
    sam_dc, sam_carrier = state["sam_dc"], state["sam_carrier"]
    if en & {SSB, LSB}:
        # LSB demod is the same 2*Re after its (negative-band) mode filter;
        # the mask honors the subset per mode (enabling one must not un-mute
        # channels that selected the other, disabled, one)
        ssb_mask = (m == SSB) if SSB in en else jnp.zeros_like(m, bool)
        lsb_mask = (m == LSB) if LSB in en else jnp.zeros_like(m, bool)
        sel = sel + jnp.where(ssb_mask | lsb_mask, demod_ssb(x), 0.0)
    if CW in en:
        y_cw, cw_phase = demod_cw(state["cw_phase"], x, cw_tone_word)
        sel = sel + jnp.where(m == CW, y_cw, 0.0)
    if AM in en:
        y_am, am_dc = demod_am(state["am_dc"], x)
        sel = sel + jnp.where(m == AM, y_am, 0.0)
    if NFM in en:
        y_nfm, nfm_last = demod_nfm(state["nfm_last"], x, fs, nfm_deviation_hz)
        sel = sel + jnp.where(m == NFM, y_nfm, 0.0)
    if SAM in en:
        y_sam, sam_dc, sam_carrier = demod_sam(state["sam_dc"], state["sam_carrier"], x, fs)
        sel = sel + jnp.where(m == SAM, y_sam, 0.0)
    new_state = {"cw_phase": cw_phase, "am_dc": am_dc, "nfm_last": nfm_last,
                 "sam_dc": sam_dc, "sam_carrier": sam_carrier}
    return sel.astype(jnp.float32), new_state
