"""Self-consistency tests of the A0 golden model (SURVEY.md §4.2 #1/#4).

These pin down the normative op semantics before any JAX code exists:
  - CIC FIR-equivalent == textbook integrator/comb structure
  - streaming ops are block-split invariant (state handoff is exact)
  - modulate -> demodulate round trips achieve high SNR
"""

import numpy as np
import pytest

from radioframe.diag.metrics import audio_snr_db
from radioframe.golden import model as G
from radioframe.io import fixtures as FX
from radioframe.ops import filter_design as FD


def _rand_iq(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


class TestCIC:
    @pytest.mark.parametrize("R,N,M", [(2, 1, 1), (4, 3, 1), (8, 4, 1), (5, 2, 2)])
    def test_fir_equivalent_matches_integrator_comb(self, rng, R, N, M):
        x = _rand_iq(rng, 1024)
        ref = G.cic_decimate_integrator_comb(x, R, N, M)
        y, _ = G.cic_decimate(x, R, N, M, norm=False)
        m = min(len(ref), len(y))
        np.testing.assert_allclose(y[:m], ref[:m], rtol=1e-9, atol=1e-9)

    def test_dc_gain_normalized(self, rng):
        x = np.ones(512, dtype=np.complex128)
        y, _ = G.cic_decimate(x, 4, 3)
        np.testing.assert_allclose(y[-10:], 1.0, rtol=1e-12)


class TestBlockSplitInvariance:
    """Process a stream as 1 block vs K blocks -> identical outputs."""

    def _run_blocked(self, fn_stream, x, sizes):
        outs, state = [], None
        i = 0
        for s in sizes:
            y, state = fn_stream(x[i : i + s], state)
            outs.append(y)
            i += s
        assert i == len(x)
        return np.concatenate(outs)

    def test_fir_decimate(self, rng):
        x = _rand_iq(rng, 1000)
        taps = FD.lowpass_taps(63, 0.2, 1.0)
        whole, _ = G.fir_decimate(x, taps, 4)
        split = self._run_blocked(lambda b, s: G.fir_decimate(b, taps, 4, s), x, [100, 1, 399, 250, 250])
        np.testing.assert_allclose(split, whole, rtol=1e-12, atol=1e-12)

    def test_cic(self, rng):
        x = _rand_iq(rng, 960)
        whole, _ = G.cic_decimate(x, 8, 4)
        split = self._run_blocked(lambda b, s: G.cic_decimate(b, 8, 4, state=s), x, [320, 320, 320])
        np.testing.assert_allclose(split, whole, rtol=1e-12, atol=1e-12)

    def test_agc(self, rng):
        x = _rand_iq(rng, 600) * np.exp(np.sin(np.arange(600) / 50.0))
        whole, env, _ = G.agc(x, 0.999)
        o1, e1, _ = G.agc(x[:200], 0.999)
        o2, e2, _ = G.agc(x[200:], 0.999, env0=e1)
        np.testing.assert_allclose(np.concatenate([o1, o2]), whole, rtol=1e-12)
        assert e2 == env

    def test_nco_phase_continuity(self, rng):
        x = _rand_iq(rng, 500)
        whole, _ = G.nco_mix(x, 1234.5, 48000.0)
        y1, p1 = G.nco_mix(x[:123], 1234.5, 48000.0)
        y2, _ = G.nco_mix(x[123:], 1234.5, 48000.0, phase0=p1)
        np.testing.assert_allclose(np.concatenate([y1, y2]), whole, rtol=1e-9, atol=1e-9)

    def test_dc_block(self, rng):
        x = rng.standard_normal(400) + 0.7
        whole, _ = G.dc_block(x)
        y1, s1 = G.dc_block(x[:157])
        y2, _ = G.dc_block(x[157:], state=s1)
        np.testing.assert_allclose(np.concatenate([y1, y2]), whole, rtol=1e-12)

    def test_nfm(self, rng):
        x = np.exp(1j * np.cumsum(rng.standard_normal(300) * 0.1))
        whole, _ = G.demod_nfm(x, 48000.0, 2500.0)
        y1, s1 = G.demod_nfm(x[:100], 48000.0, 2500.0)
        y2, _ = G.demod_nfm(x[100:], 48000.0, 2500.0, last=s1)
        np.testing.assert_allclose(np.concatenate([y1, y2]), whole, rtol=1e-12)


class TestRoundTrips:
    """Modulate with golden, demodulate with golden: the fixture SNR floor."""

    def test_ssb_round_trip(self):
        fs_iq, fs_audio = 192000.0, 48000.0
        n = int(fs_iq * 1.0)
        iq, audio = FX.ssb_capture(fs_iq, n, carrier_offset_hz=37000.0, fs_audio=fs_audio)
        # golden RX: mix down, decimate 4x (CIC + comp FIR), SSB BPF, demod
        mixed, _ = G.nco_mix(iq, 37000.0, fs_iq)
        d1, _ = G.cic_decimate(mixed, 2, 4)
        taps = FD.compensated_decim_taps(129, 96000.0, 3000.0, 21000.0, cic_R=2, cic_N=4)
        d2, _ = G.fir_decimate(d1, taps, 2)
        bpf = FD.complex_bandpass_taps(257, 300.0, 2700.0, fs_audio)
        filt, _ = G.ols_filter(d2, bpf)
        out = G.demod_ssb(filt)
        snr = audio_snr_db(audio, out)
        assert snr > 30.0, f"SSB round-trip SNR {snr:.1f} dB"

    def test_am_round_trip(self):
        fs_iq = 192000.0
        n = int(fs_iq * 0.5)
        iq, audio = FX.am_capture(fs_iq, n, carrier_offset_hz=20000.0)
        mixed, _ = G.nco_mix(iq, 20000.0, fs_iq)
        d1, _ = G.cic_decimate(mixed, 2, 4)
        taps = FD.compensated_decim_taps(129, 96000.0, 5000.0, 21000.0, cic_R=2, cic_N=4)
        d2, _ = G.fir_decimate(d1, taps, 2)
        out, _ = G.demod_am(d2)
        snr = audio_snr_db(audio, out)
        assert snr > 25.0, f"AM round-trip SNR {snr:.1f} dB"

    def test_nfm_round_trip(self):
        fs_iq = 192000.0
        n = int(fs_iq * 0.5)
        iq, audio = FX.nfm_capture(fs_iq, n, carrier_offset_hz=-15000.0, deviation_hz=2500.0)
        mixed, _ = G.nco_mix(iq, -15000.0, fs_iq)
        d1, _ = G.cic_decimate(mixed, 2, 4)
        taps = FD.compensated_decim_taps(129, 96000.0, 6000.0, 21000.0, cic_R=2, cic_N=4)
        d2, _ = G.fir_decimate(d1, taps, 2)
        out, _ = G.demod_nfm(d2, 48000.0, 2500.0)
        snr = audio_snr_db(audio, out)
        assert snr > 25.0, f"NFM round-trip SNR {snr:.1f} dB"


class TestPFB:
    def test_tone_lands_in_right_channel(self):
        M = 16
        proto = FD.pfb_prototype_taps(M, 8)
        fs = 16000.0
        n = 4096
        t = np.arange(n) / fs
        c = 5  # tone at center of channel 5
        x = np.exp(2j * np.pi * (c * fs / M) * t)
        y = G.pfb_channelize(x, M, proto)
        power = np.mean(np.abs(y[8:]) ** 2, axis=0)
        assert np.argmax(power) == c
        # adjacent-channel rejection
        others = np.delete(power, c)
        assert 10 * np.log10(power[c] / others.max()) > 30.0


class TestInterferenceGolden:
    """ops/interference.py vs the A0 golden definitions (VERDICT r2 ask #7:
    the interference family's contract, streamed over multiple blocks so the
    state handoff is covered too)."""

    def _stream(self, op_call, golden_call, blocks):
        import jax
        import jax.numpy as jnp

        outs_j, outs_g = [], []
        for b in blocks:
            outs_j.append(op_call(jnp.asarray(b[None, :])))
            outs_g.append(golden_call(b))
        return outs_j, outs_g

    def test_spectral_nr_matches_golden(self, rng):
        from conftest import jwrap

        from radioframe.ops.interference import SpectralNR

        nr = SpectralNR(nfft=128)
        step = jwrap(nr)
        st_j = nr.init_state(1)
        st_g = None
        x = (0.1 * _rand_iq(rng, 3 * 1024)).astype(np.complex64)
        x[1024:2048] += np.exp(2j * np.pi * 0.13 * np.arange(1024))
        for b in x.reshape(3, 1024):
            yj, st_j = step(st_j, b[None, :])
            yg, st_g = G.spectral_nr(b, nfft=128, noise_est=st_g)
            np.testing.assert_allclose(np.asarray(yj)[0], yg, atol=2e-5)
            np.testing.assert_allclose(np.asarray(st_j)[0], st_g, rtol=1e-4)

    def test_spectral_nr_vad_gated_matches_golden(self, rng):
        from conftest import jwrap

        from radioframe.ops.interference import SpectralNR, Vad

        nr, vd = SpectralNR(nfft=128), Vad(nfft=128)
        step_nr, step_vd = jwrap(nr), jwrap(vd)
        st_j, fl_j = nr.init_state(1), vd.init_state(1)
        st_g = fl_g = None
        x = (0.1 * _rand_iq(rng, 3 * 1024)).astype(np.complex64)
        x[1024:2048] += 2.0 * np.exp(2j * np.pi * 0.13 * np.arange(1024))
        for b in x.reshape(3, 1024):
            vj, fl_j = step_vd(fl_j, b[None, :])
            vg, fl_g = G.vad_stream(b, nfft=128, floor=fl_g)
            np.testing.assert_array_equal(np.asarray(vj)[0], vg)
            np.testing.assert_allclose(np.asarray(fl_j)[0], fl_g, rtol=1e-4)
            yj, st_j = step_nr(st_j, b[None, :], voice=vj)
            yg, st_g = G.spectral_nr(b, nfft=128, noise_est=st_g, voice=vg)
            np.testing.assert_allclose(np.asarray(yj)[0], yg, atol=2e-5)
            np.testing.assert_allclose(np.asarray(st_j)[0], st_g, rtol=1e-4)

    def test_noise_blanker_matches_golden(self, rng):
        from conftest import jwrap

        from radioframe.ops.interference import NoiseBlanker

        nb = NoiseBlanker(threshold=6.0)
        step = jwrap(nb)
        st_j = nb.init_state(1)
        st_g = 0.0
        x = (0.1 * _rand_iq(rng, 2 * 2048)).astype(np.complex64)
        x[777] = 30.0
        x[3000] = -25.0j
        for b in x.reshape(2, 2048):
            yj, st_j = step(st_j, b[None, :])
            yg, st_g = G.noise_blanker(b, power_est=st_g)
            np.testing.assert_allclose(np.asarray(yj)[0], yg, atol=2e-5)
            np.testing.assert_allclose(float(np.asarray(st_j)[0]), float(st_g), rtol=1e-4)

    def test_auto_notch_matches_golden(self, rng):
        from conftest import jwrap

        from radioframe.ops.interference import AutoNotch

        an = AutoNotch(nfft=128)
        step = jwrap(an)
        st_j = an.init_state(1)
        st_g = None
        n = 3 * 1024
        x = (0.05 * _rand_iq(rng, n)).astype(np.complex64)
        x += np.exp(2j * np.pi * (17.0 / 128.0) * np.arange(n))  # steady carrier
        for b in x.reshape(3, 1024):
            yj, st_j = step(st_j, b[None, :])
            yg, st_g = G.auto_notch(b, nfft=128, mag_ema=st_g)
            np.testing.assert_allclose(np.asarray(yj)[0], yg, atol=2e-5)
            np.testing.assert_allclose(np.asarray(st_j)[0], st_g, rtol=1e-4)
