"""NCO mix + two decimation stages in one Pallas kernel, through Triton.

The reference front end is an FPGA datapath that mixes and decimates every
ADC sample in one pass (SURVEY.md §2.1 #1-#4). The plain XLA form
(``nco.mix_down`` followed by the ``FirDecimator`` grouped convolutions)
writes the full-rate mixed stream to device memory and reads it back, and
that stream is the largest byte count in the RX chain. This kernel reads
the raw I/Q planes once and writes only the stage-2 output.

Layout: the grid is (channel, output tile) and fully parallel; nothing
carries between programs. Each program owns ``TO`` stage-2 outputs of one
channel and computes them from:

  * stage 1 at ``N1`` consecutive stage-1 positions ending at the tile's
    last one (the ``N1 - TO*R2`` positions before the tile are the stage-2
    history, recomputed from the raw samples instead of carried);
  * the mixer folded into the taps. With the DDS phase
    theta(n) = 2 pi (acc + word*n) / 2^32 (int32, wrapping),

        y1[m] = e^{-j theta(m R1)} * sum_k h1[k] e^{+j 2 pi word k / 2^32} x[m R1 - k]

    which is exact in the int32 wrap, so the kernel takes N1 + K1 sines and
    cosines per program instead of one per sample;
  * raw samples before the block (negative indices) read from the carried
    raw tail, so no halo is ever concatenated to the block in XLA;
  * stage 2 as a product with a constant band matrix B2 (N1, TO),
    B2[n, p] = h2[N1 - (TO - p) R2 - n], on the CUDA cores in float32.

Triton has no complex type, so I and Q arrive as separate planes, as int16
ADC counts or float32. Per-tile input power partials are summed in XLA.
Every block size is a power of two. The kernel uses only generic ``pl``
ref operations, so ``interpret=True`` runs it on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_SCALE = np.float32(2.0 * np.pi / 2.0 ** 32)
# raw samples per frame block a program holds at once
_FRAME_ELEMS = 2048


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pow2_dividing(n: int, cap: int) -> int:
    p = 1
    while n % (2 * p) == 0 and 2 * p <= cap:
        p *= 2
    return p


def _kernel(xr_ref, xi_ref, tr_ref, ti_ref, word_ref, acc_ref, hp_ref, b2_ref,
            yr_ref, yi_ref, pw_ref, *, R1, R2, TO, N1, NC, J, H, PC, bcast):
    c = pl.program_id(0)
    t = pl.program_id(1)
    cx = 0 if bcast else c
    word = word_ref[c]
    acc = acc_ref[c]
    n0 = (t + 1) * (TO * R2) - N1  # first stage-1 position of this program
    r = lax.broadcasted_iota(jnp.int32, (R1,), 0)

    def frames_fast(ref, tref, start):
        return ref[cx, pl.ds(start, NC * R1)].astype(jnp.float32).reshape(NC, R1)

    def frames_tail(ref, tref, start):
        # raw samples before the block come from the carried tail
        idx = start + lax.broadcasted_iota(jnp.int32, (NC * R1,), 0)
        v = jnp.where(idx >= 0, ref[cx, jnp.maximum(idx, 0)].astype(jnp.float32),
                      tref[c, jnp.clip(idx + H, 0, H - 1)])
        return v.reshape(NC, R1)

    def tile(frames):
        def row_chunk(i, carry):
            y2r, y2i = carry
            n = n0 + i * NC + lax.broadcasted_iota(jnp.int32, (NC,), 0)
            sr = jnp.zeros((NC, R1), jnp.float32)
            si = jnp.zeros((NC, R1), jnp.float32)
            for j in range(J + 1):
                # sample (n - j) R1 + r meets tap k = j R1 - r
                ph = (word * (j * R1 - r)).astype(jnp.float32) * _SCALE
                h = hp_ref[j, :]
                gr = (h * jnp.cos(ph))[None, :]
                gi = (h * jnp.sin(ph))[None, :]
                start = (n0 + i * NC - j) * R1
                xr = frames(xr_ref, tr_ref, start)
                xi = frames(xi_ref, ti_ref, start)
                sr = sr + xr * gr - xi * gi
                si = si + xr * gi + xi * gr
            ar = jnp.sum(sr, axis=1)
            ai = jnp.sum(si, axis=1)
            th = (acc + word * (n * R1)).astype(jnp.float32) * _SCALE
            cs, sn = jnp.cos(th), jnp.sin(th)
            y1r = ar * cs + ai * sn
            y1i = ai * cs - ar * sn
            if R2 == 1:
                return y1r, y1i
            b2 = b2_ref[pl.ds(i * NC, NC), :]
            return (y2r + jnp.sum(y1r[:, None] * b2, axis=0),
                    y2i + jnp.sum(y1i[:, None] * b2, axis=0))

        zero = jnp.zeros((TO,), jnp.float32)
        return lax.fori_loop(0, N1 // NC, row_chunk, (zero, zero))

    # only the first tiles reach back into the tail; the rest load
    # contiguous frames (a negative start would read outside the block)
    y2r, y2i = lax.cond((n0 - J) * R1 < 0,
                        lambda: tile(frames_tail), lambda: tile(frames_fast))
    yr_ref[...] = y2r[None, :]
    yi_ref[...] = y2i[None, :]

    span = TO * R1 * R2
    base = t * span

    def power_chunk(i, p):
        s = pl.ds(base + i * PC, PC)
        a = xr_ref[cx, s].astype(jnp.float32)
        b = xi_ref[cx, s].astype(jnp.float32)
        return p + jnp.sum(a * a + b * b)

    pw_ref[...] = jnp.reshape(
        lax.fori_loop(0, span // PC, power_chunk, jnp.float32(0.0)), (1, 1))


class TritonFrontend:
    """NCO + stage 1 (+ optional stage 2) decimation, one Triton pass.

    taps/R: stage 1 (real taps). taps2/R2: optional second real-tap FIR
    stage (None: single-stage mode). ``input_scale`` is folded into the
    stage-1 taps, so int16 ADC counts (scale 2**-15) cost nothing at run
    time. Block state: {"acc" (C,) int32 DDS, "tail" (C, tail_len) raw iq}
    with tail_len = (L2-1)*R1 + L1-1, the raw history the first tile needs.
    """

    def __init__(self, taps, R: int, taps2=None, R2: int = 1,
                 input_scale: float = 1.0, interpret: bool = False):
        h1 = np.asarray(taps, np.float64) * float(input_scale)
        assert not np.iscomplexobj(h1)
        self.input_scale = float(input_scale)
        self.R, self.L = int(R), len(h1)
        assert self.R & (self.R - 1) == 0, "stage-1 R must be a power of two"
        # polyphase tap table hp[j, r] = h1[j R1 - r] (zero outside the taps)
        self.J = -(-(self.L - 1) // self.R)
        k = np.arange(self.J + 1)[:, None] * self.R - np.arange(self.R)[None, :]
        ok = (k >= 0) & (k < self.L)
        self.hp = np.where(ok, h1[np.clip(k, 0, self.L - 1)], 0.0).astype(np.float32)
        if taps2 is None:
            self.h2, self.R2, self.L2 = None, 1, 1
        else:
            self.h2 = np.asarray(taps2, np.float64)
            assert not np.iscomplexobj(self.h2)
            self.R2, self.L2 = int(R2), len(self.h2)
        self.tail_len = (self.L2 - 1) * self.R + self.L - 1
        self.decim = self.R * self.R2
        self.interpret = interpret

    def init_state(self, num_channels: int):
        return {
            "acc": jnp.zeros((num_channels,), jnp.int32),
            "tail": jnp.zeros((num_channels, self.tail_len), jnp.complex64),
        }

    def tiles(self, M2: int):
        """(TO, N1, NC): stage-2 outputs per program, stage-1 positions per
        program, stage-1 positions per inner step. TO is the power of two
        dividing M2 (up to 64) with the fewest stage-1 positions per output."""
        if self.h2 is None:
            TO = _pow2_dividing(M2, 256)
            N1 = TO
        else:
            best = None
            TO = 1
            while M2 % TO == 0 and TO <= 64:
                N1 = _pow2_at_least(TO * self.R2 + self.L2 - 1)
                if best is None or N1 / TO < best[1] / best[0]:
                    best = (TO, N1)
                TO *= 2
            TO, N1 = best
        NC = max(1, min(N1, _FRAME_ELEMS // self.R))
        return TO, N1, NC

    def band(self, TO: int, N1: int) -> np.ndarray:
        """Stage-2 band matrix B2[n, p] = h2[N1 - (TO - p) R2 - n]."""
        if self.h2 is None:
            return np.zeros((1, 1), np.float32)
        k = N1 - (TO - np.arange(TO))[None, :] * self.R2 - np.arange(N1)[:, None]
        ok = (k >= 0) & (k < self.L2)
        return np.where(ok, self.h2[np.clip(k, 0, self.L2 - 1)], 0.0).astype(np.float32)

    def step(self, state, iq, words, return_power: bool = False):
        """(state, iq (C or 1, T) c64, words (C,) i32) -> (state, y (C, T//decim))
        [+ per-channel input power sum when ``return_power``]."""
        return self.step_planes(state, jnp.real(iq), jnp.imag(iq), words,
                                return_power=return_power)

    def step_planes(self, state, xr, xi, words, return_power: bool = False):
        """Plane-input form: xr/xi (C or 1, T), float32 or int16 counts. A
        (1, T) input is broadcast to every channel inside the kernel.
        Returns (state, y) or (state, y, power_sum), power_sum (C,) = sum
        |x|^2 in raw input units (the caller applies input_scale**2)."""
        C = words.shape[0]
        Cx, T = xr.shape
        assert Cx in (1, C) and T % self.decim == 0
        M2 = T // self.decim
        TO, N1, NC = self.tiles(M2)
        span = TO * self.decim
        PC = _pow2_dividing(span, 1024)
        H = self.tail_len
        tail = state["tail"]
        if H == 0:
            tail = jnp.zeros((C, 1), jnp.complex64)
        tr = jnp.real(tail).astype(jnp.float32)
        ti = jnp.imag(tail).astype(jnp.float32)
        words = words.astype(jnp.int32)
        kern = functools.partial(
            _kernel, R1=self.R, R2=self.R2, TO=TO, N1=N1, NC=NC, J=self.J,
            H=max(H, 1), PC=PC, bcast=(Cx == 1 and C > 1))
        n_tiles = M2 // TO
        b2 = self.band(TO, N1)
        yr, yi, pw = pl.pallas_call(
            kern,
            grid=(C, n_tiles),
            in_specs=[pl.no_block_spec] * 8,
            out_specs=[pl.BlockSpec((1, TO), lambda c, t: (c, t)),
                       pl.BlockSpec((1, TO), lambda c, t: (c, t)),
                       pl.BlockSpec((1, 1), lambda c, t: (c, t))],
            out_shape=[jax.ShapeDtypeStruct((C, M2), jnp.float32),
                       jax.ShapeDtypeStruct((C, M2), jnp.float32),
                       jax.ShapeDtypeStruct((C, n_tiles), jnp.float32)],
            backend="triton",
            compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
            interpret=self.interpret,
            name="triton_frontend",
        )(xr, xi, tr, ti, words, state["acc"], jnp.asarray(self.hp),
          jnp.asarray(b2))
        y = lax.complex(yr, yi)
        new_tail = state["tail"]
        if H:
            lr, li = (jnp.broadcast_to(p[:, max(T - H, 0):], (C, min(T, H)))
                      .astype(jnp.float32) for p in (xr, xi))
            new_tail = jnp.concatenate([tail, lax.complex(lr, li)], axis=-1)[:, -H:]
        new_state = {"acc": state["acc"] + words * jnp.int32(T), "tail": new_tail}
        if return_power:
            return new_state, y, jnp.sum(pw, axis=-1)
        return new_state, y
