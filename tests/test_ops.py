"""JAX ops vs the A0 golden model (SURVEY.md §4.2 #1): near-fp32 tolerance,
plus block-split/state-handoff invariance for every stateful op.

All op invocations go through the conftest jit helpers (jrun/jwrap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import jrun, jwrap

from radioframe.golden import model as G
from radioframe.ops import agc as agc_op
from radioframe.ops import demod as demod_op
from radioframe.ops import filter_design as FD
from radioframe.ops import nco
from radioframe.ops.fir import FirDecimator, cic_decimator
from radioframe.ops.ols import OverlapSave
from radioframe.ops.scans import affine_scan, maxdecay_scan


def _iq(rng, C, T):
    return (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)


class TestNCO:
    def test_matches_golden_at_quantized_freq(self, rng):
        fs = 192000.0
        x = _iq(rng, 3, 4096)
        freqs = np.array([37000.0, -15000.0, 123.456])
        words = nco.freq_word(freqs, fs)
        fq = nco.word_to_freq(words, fs)  # golden runs at the quantized freqs
        y, _ = jrun(nco.mix_down, x, words, np.zeros(3, np.int32))
        for c in range(3):
            ref, _ = G.nco_mix(x[c], fq[c], fs)
            np.testing.assert_allclose(y[c], ref, atol=2e-5)

    def test_phase_continuity_exact(self, rng):
        fs = 48000.0
        x = _iq(rng, 1, 2048)
        w = np.asarray(nco.freq_word(1234.5, fs))[None]
        acc = np.zeros(1, np.int32)
        step = jwrap(nco.mix_down)
        # split on a multiple of the oscillator factorization group (128) so
        # the int32 phase grids coincide -> bit-exact continuation
        y1, acc1 = step(x[:, :1024], w, acc)
        y2, _ = step(x[:, 1024:], w, acc1)
        whole, _ = step(x, w, acc)
        got = np.concatenate([y1, y2], axis=-1)
        np.testing.assert_array_equal(got[:, 1024:], whole[:, 1024:])

    def test_long_stream_no_phase_drift(self, rng):
        # 100 blocks of 4096: int32 accumulator keeps phase exact vs float64
        fs = 192000.0
        w = nco.freq_word(37000.0, fs)
        acc = np.zeros(1, np.int32)
        ones = np.ones((1, 4096), np.complex64)
        step = jwrap(nco.mix_down)
        for _ in range(100):
            y, acc = step(ones, np.asarray(w)[None], acc)
        n_last = 100 * 4096 - 1
        expected = np.exp(-1j * 2 * np.pi * (nco.word_to_freq(w, fs) / fs) * n_last)
        assert abs(y[0, -1] - expected) < 1e-4


class TestFIR:
    @pytest.mark.parametrize("R", [1, 2, 4])
    def test_real_taps_vs_golden(self, rng, R):
        taps = FD.lowpass_taps(63, 0.2, 1.0)
        op = FirDecimator(taps, R)
        x = _iq(rng, 4, 512)
        y, _ = jrun(lambda x: op(op.init_state(4), x), x)
        for c in range(4):
            ref, _ = G.fir_decimate(x[c].astype(np.complex128), taps, R)
            np.testing.assert_allclose(y[c], ref, atol=1e-5)

    def test_complex_taps_vs_golden(self, rng):
        taps = FD.complex_bandpass_taps(101, 300.0, 2700.0, 48000.0)
        op = FirDecimator(taps, 2)
        x = _iq(rng, 2, 600)
        y, _ = jrun(lambda x: op(op.init_state(2), x), x)
        for c in range(2):
            ref, _ = G.fir_decimate(x[c].astype(np.complex128), taps, 2)
            np.testing.assert_allclose(y[c], ref, atol=1e-5)

    def test_streaming_state_handoff(self, rng):
        taps = FD.lowpass_taps(63, 0.2, 1.0)
        op = FirDecimator(taps, 4)
        x = _iq(rng, 2, 1024)
        whole, _ = jrun(lambda x: op(op.init_state(2), x), x)
        st = jrun(lambda: op.init_state(2))
        step = jwrap(op)
        outs = []
        for blk in np.split(x, 4, axis=-1):
            y, st = step(st, blk)
            outs.append(y)
        np.testing.assert_allclose(np.concatenate(outs, axis=-1), whole, atol=1e-6)

    def test_cic_vs_golden(self, rng):
        op = cic_decimator(8, 4)
        x = _iq(rng, 2, 1024)
        y, _ = jrun(lambda x: op(op.init_state(2), x), x)
        for c in range(2):
            ref, _ = G.cic_decimate(x[c].astype(np.complex128), 8, 4)
            np.testing.assert_allclose(y[c], ref, atol=1e-5)


class TestScans:
    def test_affine_scan_matches_loop(self, rng):
        a = rng.uniform(0.5, 1.0, (3, 200)).astype(np.float32)
        b = rng.standard_normal((3, 200)).astype(np.float32)
        s0 = rng.standard_normal(3).astype(np.float32)
        got = jrun(affine_scan, a, b, s0)
        for c in range(3):
            s = s0[c]
            for n in range(200):
                s = a[c, n] * s + b[c, n]
                assert abs(got[c, n] - s) < 1e-4

    def test_maxdecay_scan_matches_loop(self, rng):
        a = np.full((2, 300), 0.99, np.float32)
        v = np.abs(rng.standard_normal((2, 300))).astype(np.float32)
        s0 = np.array([0.0, 5.0], np.float32)
        got = jrun(maxdecay_scan, a, v, s0)
        for c in range(2):
            s = s0[c]
            for n in range(300):
                s = max(0.99 * s, v[c, n])
                np.testing.assert_allclose(got[c, n], s, rtol=1e-5)


class TestAGC:
    def test_vs_golden(self, rng):
        x = _iq(rng, 2, 500) * np.exp(np.sin(np.arange(500) / 40.0))[None, :]
        x = x.astype(np.complex64)
        y, env, _ = jrun(lambda e, x: agc_op.apply(e, x, 0.999),
                         np.zeros(2, np.float32), x)
        for c in range(2):
            ref, env_ref, _ = G.agc(x[c].astype(np.complex128), 0.999)
            np.testing.assert_allclose(y[c], ref, rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(env[c], env_ref, rtol=1e-4)

    def test_state_handoff(self, rng):
        x = _iq(rng, 1, 400)
        step = jwrap(lambda e, x: agc_op.apply(e, x, 0.995))
        z = np.zeros(1, np.float32)
        whole, _, _ = step(z, x)
        y1, e1, _ = step(z, x[:, :150])
        y2, _, _ = step(e1, x[:, 150:])
        got = np.concatenate([y1, y2], axis=-1)
        np.testing.assert_allclose(got, whole, rtol=2e-4, atol=2e-5)


class TestOLS:
    def test_vs_golden_real_and_complex_taps(self, rng):
        for taps in (FD.lowpass_taps(129, 3000.0, 48000.0),
                     FD.complex_bandpass_taps(257, 300.0, 2700.0, 48000.0)):
            op = OverlapSave(taps, hop=512)
            T = op.hop * 4
            x = _iq(rng, 2, T)
            y, _ = jrun(lambda x, op=op: op(op.init_state(2), x), x)
            for c in range(2):
                ref, _ = G.ols_filter(x[c].astype(np.complex128), taps)
                np.testing.assert_allclose(y[c], ref, atol=3e-4)

    def test_streaming(self, rng):
        taps = FD.lowpass_taps(129, 3000.0, 48000.0)
        op = OverlapSave(taps, hop=256)
        x = _iq(rng, 1, 4 * op.hop)
        whole, _ = jrun(lambda x: op(op.init_state(1), x), x)
        st = jrun(lambda: op.init_state(1))
        step = jwrap(op)
        outs = []
        for blk in np.split(x, 4, axis=-1):
            y, st = step(st, blk)
            outs.append(y)
        np.testing.assert_allclose(np.concatenate(outs, axis=-1), whole, atol=1e-5)


class TestDemod:
    def test_dc_block_vs_golden(self, rng):
        x = (rng.standard_normal((2, 300)) + 0.5).astype(np.float32)
        y, _ = jrun(lambda x: demod_op.dc_block(demod_op.dc_block_init(2), x), x)
        for c in range(2):
            ref, _ = G.dc_block(x[c].astype(np.float64))
            np.testing.assert_allclose(y[c], ref, atol=1e-4)

    def test_nfm_vs_golden(self, rng):
        x = np.exp(1j * np.cumsum(rng.standard_normal((2, 400)) * 0.1, axis=-1)).astype(np.complex64)
        y, _ = jrun(lambda x: demod_op.demod_nfm(jnp.ones(2, jnp.complex64), x,
                                                 48000.0, 2500.0), x)
        for c in range(2):
            ref, _ = G.demod_nfm(x[c].astype(np.complex128), 48000.0, 2500.0)
            np.testing.assert_allclose(y[c], ref, atol=1e-3)

    def test_bank_selects_per_channel(self, rng):
        x = _iq(rng, 4, 256)
        mode = np.asarray([demod_op.SSB, demod_op.CW, demod_op.AM, demod_op.NFM], np.int32)
        tone = np.broadcast_to(nco.freq_word(600.0, 48000.0), (4,)).copy()
        y, _ = jrun(lambda x: demod_op.bank_apply(demod_op.bank_init(4), x,
                                                  jnp.asarray(mode),
                                                  jnp.asarray(tone), 48000.0), x)
        # channel 0 must equal pure SSB demod; channel 3 pure NFM
        np.testing.assert_allclose(y[0], 2 * np.real(x[0]), atol=1e-5)
        ref_nfm, _ = G.demod_nfm(x[3].astype(np.complex128), 48000.0, 2500.0)
        np.testing.assert_allclose(y[3], ref_nfm, atol=1e-3)


class TestSamGoldenParity:
    def test_sam_vs_golden(self, rng):
        # mistuned AM baseband: carrier at +90 Hz with 600 Hz tone
        fs = 48_000.0
        t = np.arange(4096) / fs
        base = (1.0 + 0.8 * np.sin(2 * np.pi * 600.0 * t)) * np.exp(2j * np.pi * 90.0 * t)
        x = np.stack([base, 0.5 * base]).astype(np.complex64)
        y, dc, acc = jrun(lambda x: demod_op.demod_sam(
            demod_op.dc_block_init(2), jnp.zeros((2, 2), jnp.float32), x, fs), x)
        for c in range(2):
            ref, _, (ph, w) = G.demod_sam(x[c].astype(np.complex128), fs)
            np.testing.assert_allclose(y[c], ref, atol=2e-3)
            np.testing.assert_allclose(float(acc[1, c]), w, atol=1e-6)

    def test_squelch_vs_golden(self, rng):
        audio = rng.standard_normal((1, 2048)).astype(np.float32) * 3.0
        y, ns, is_open = jrun(lambda a: demod_op.squelch(
            jnp.zeros(1, jnp.float32), a), audio)
        ref_y, ref_ns, ref_open = G.squelch(audio[0].astype(np.float64))
        np.testing.assert_allclose(y[0], ref_y, atol=1e-4)
        np.testing.assert_allclose(float(ns[0]), ref_ns, rtol=1e-4)
        assert bool(np.asarray(is_open)[0]) == ref_open


def test_ols_bank_apply_selected_matches_full_bank(rng):
    """Frequency-domain per-channel selection == full bank + take_along_axis
    (the gather commutes with the linear IFFT): one IFFT instead of K."""
    from radioframe.ops import filter_design as FD
    from radioframe.ops.ols import OverlapSaveBank

    bank = OverlapSaveBank(
        [FD.complex_bandpass_taps(513, 300.0, 2700.0, 48e3),
         FD.complex_bandpass_taps(513, -250.0, 250.0, 48e3),
         FD.complex_bandpass_taps(513, -5000.0, 5000.0, 48e3)],
        hop=512)
    C, T = 6, 2048
    x = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))) \
        .astype(np.complex64)
    row = (np.arange(C) % 3).astype(np.int32)
    full, tail_a = jrun(lambda x: bank(bank.init_state(C), x), x)
    want = np.take_along_axis(full, row[None, :, None], axis=0)[0]
    got, tail_b = jrun(lambda x: bank.apply_selected(
        bank.init_state(C), x, jnp.asarray(row)), x)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(tail_a, tail_b)


class TestZoomSpectrum:
    def test_zoom_resolves_close_tones(self, rng):
        """Two tones 100 Hz apart at 192 kHz: unresolvable in a 1024-bin
        panorama (188 Hz/bin), cleanly split at zoom x16 (11.7 Hz/bin)."""
        from radioframe.ops import nco
        from radioframe.ops.spectrum import ZoomSpectrum

        fs, Z, nfft = 192_000.0, 16, 1024
        f0 = 12_000.0
        T = 4 * Z * nfft
        t = np.arange(T) / fs
        x = (np.exp(2j * np.pi * (f0 - 50.0) * t) +
             np.exp(2j * np.pi * (f0 + 50.0) * t)).astype(np.complex64)[None, :]
        zoom = ZoomSpectrum(nfft, Z)
        word = np.asarray([nco.freq_word(f0, fs)], np.int32)
        lines, _ = jrun(lambda x: zoom(zoom.init_state(1), x,
                                       jnp.asarray(word)), x)
        line = lines[0, -1]
        # find the two peaks: they sit ±50 Hz from center at 11.7 Hz/bin
        res = fs / Z / nfft
        k = np.argsort(line)[::-1]
        # take the top two local maxima separated by > 4 bins
        top = [int(k[0])]
        for kk in k[1:]:
            if abs(int(kk) - top[0]) > 4:
                top.append(int(kk))
                break
        got_hz = sorted(((np.array(top) - nfft // 2) * res).tolist())
        np.testing.assert_allclose(got_hz, [-50.0, 50.0], atol=1.5 * res)

    def test_streaming_state(self, rng):
        """Split blocks == one shot (NCO + decimator + EMA state carry)."""
        from radioframe.ops import nco
        from radioframe.ops.spectrum import ZoomSpectrum

        zoom = ZoomSpectrum(256, 4, avg=0.5)
        x = (rng.standard_normal((2, 8 * 1024)) +
             1j * rng.standard_normal((2, 8 * 1024))).astype(np.complex64)
        word = np.asarray(nco.freq_word(np.array([1e3, -2e3]), 192e3))
        whole, _ = jrun(lambda x: zoom(zoom.init_state(2), x,
                                       jnp.asarray(word)), x)
        st = jrun(lambda: zoom.init_state(2))
        step = jwrap(lambda st, x: zoom(st, x, jnp.asarray(word)))
        outs = []
        for blk in np.split(x, 2, axis=-1):
            lines, st = step(st, blk)
            outs.append(lines)
        got = np.concatenate(outs, axis=1)
        np.testing.assert_allclose(got, whole, atol=1e-3)


class TestFastScans:
    """Constant-coefficient scan fast paths == associative scans
    (ops/scans.py note)."""

    def test_affine_const_matches(self, rng):
        from radioframe.ops.scans import affine_const_ok, affine_scan, affine_scan_const

        C, T = 16, 1024
        a_ch = rng.uniform(0.93, 0.999, C).astype(np.float32)
        b = rng.standard_normal((C, T)).astype(np.float32)
        s0 = rng.standard_normal(C).astype(np.float32)
        assert affine_const_ok(a_ch)
        ref = jrun(lambda a, b, s: affine_scan(
            jnp.broadcast_to(a[:, None], (C, T)), b, s), a_ch, b, s0)
        got = jrun(affine_scan_const, a_ch, b, s0)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    def test_affine_const_zero_rows_exact(self, rng):
        from radioframe.ops.scans import affine_scan_const

        C, T = 8, 512
        a_ch = np.r_[np.zeros(4), np.full(4, 0.98)].astype(np.float32)
        b = rng.standard_normal((C, T)).astype(np.float32)
        s0 = np.zeros((C,), np.float32)
        got = jrun(affine_scan_const, a_ch, b, s0)
        # a == 0 rows: s[n] == b[n] exactly (instant)
        np.testing.assert_array_equal(got[:4], b[:4])

    def test_maxdecay_const_matches(self, rng):
        from radioframe.ops.scans import (maxdecay_const_ok, maxdecay_scan,
                                          maxdecay_scan_const)

        C, T = 16, 2048
        a_ch = np.exp(-1.0 / (rng.uniform(0.25, 0.8, C) * 15000.0)) \
            .astype(np.float32)
        v = np.abs(rng.standard_normal((C, T))).astype(np.float32)
        s0 = np.abs(rng.standard_normal(C)).astype(np.float32)
        assert maxdecay_const_ok(a_ch, T)
        ref = jrun(lambda a, v, s: maxdecay_scan(
            jnp.broadcast_to(a[:, None], (C, T)), v, s), a_ch, v, s0)
        got = jrun(maxdecay_scan_const, a_ch, v, s0)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def test_ok_guards(self):
        from radioframe.ops.scans import affine_const_ok, maxdecay_const_ok

        assert affine_const_ok([0.995, 0.98, 0.0])
        assert not affine_const_ok([0.5])      # rescale would blow up
        assert maxdecay_const_ok([0.9999], 2048)
        assert not maxdecay_const_ok([0.99], 2048)  # 0.99^-2047 huge


def test_decay_pows_matches_pow():
    """halo.decay_pows: index-selected static pow rows == direct pow."""
    from radioframe.shard.halo import decay_pows

    table = np.array([0.99, 0.5, 0.9], np.float32)
    idx = np.array([0, 1, 2, 1, 0])
    got = np.asarray(jax.jit(lambda i: decay_pows(i, table, 16))(
        jnp.asarray(idx, jnp.int32)))
    want = table[idx][:, None] ** (1.0 + np.arange(16))
    np.testing.assert_allclose(got, want, rtol=2e-6)
