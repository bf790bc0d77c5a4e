"""RxChain — the jit-compiled receive block program (SURVEY.md §3.2).

Reference analog: the RX half of `[U:audio_processor.c]` driving
NCO -> CIC -> comp FIR -> channel filter -> AGC -> demod per ISR block.
Shape: one traced SPMD program per block,

    (state, iq (C, T), freq_words (C,), mode (C,)) -> (state, audio, aux)

with all per-sample recursions as scans, the mode filters as one OLS FFT
bank, and the demod bank dense+masked. Per-channel frequency and mode are
runtime inputs — retuning never recompiles (SURVEY.md §3.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from radioframe import kernels
from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.ops import agc as agc_op
from radioframe.ops import demod as demod_op
from radioframe.ops import filter_design as FD
from radioframe.ops import nco
from radioframe.ops.fir import FirDecimator, cic_decimator
from radioframe.ops.ols import OverlapSaveBank
from radioframe.ops.spectrum import Spectrum


class RxChain:
    """Builds ops/taps from an RxConfig; ``step`` is pure and jittable."""

    def __init__(self, cfg: RxConfig):
        self.cfg = cfg
        self.decimators = []
        fs = cfg.fs_in
        prev_cic: CicStage | None = None
        self._stage_taps = []  # taps per stage (for the front-end kernel)
        for st in cfg.stages:
            if isinstance(st, CicStage):
                from radioframe.ops.filter_design import cic_equivalent_taps

                self._stage_taps.append(cic_equivalent_taps(st.R, st.N, st.M))
                self.decimators.append(cic_decimator(st.R, st.N, st.M))
                prev_cic = st
                fs /= st.R
            elif isinstance(st, FirStage):
                stop = st.stopband_hz if st.stopband_hz is not None else 0.45 * fs / st.R
                if prev_cic is not None:
                    taps = FD.compensated_decim_taps(
                        st.numtaps, fs, st.passband_hz, stop,
                        cic_R=prev_cic.R, cic_N=prev_cic.N, cic_M=prev_cic.M,
                        cic_input_fs=fs * prev_cic.R,
                    )
                else:
                    taps = FD.lowpass_taps(st.numtaps, min(st.passband_hz, stop), fs)
                self._stage_taps.append(taps)
                self.decimators.append(FirDecimator(taps, st.R))
                prev_cic = None
                fs /= st.R
            else:
                raise TypeError(f"unknown stage {st!r}")
        assert abs(fs - cfg.fs_audio) < 1e-6
        # Triton front end where it runs (kernels.frontend_for): replaces
        # nco.mix_down and the first one or two decimators with one pass
        self.frontend = kernels.frontend_for(
            self._stage_taps, [d.R for d in self.decimators],
            jax.default_backend(),
            input_scale=2.0 ** -15 if cfg.int16_ingest else 1.0)
        self.frontend_stages = (0 if self.frontend is None
                                else 1 if self.frontend.h2 is None else 2)
        mf = cfg.mode_filters
        fa = cfg.fs_audio
        self.mode_bank = OverlapSaveBank(
            [
                FD.complex_bandpass_taps(mf.numtaps, mf.ssb_lo, mf.ssb_hi, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.cw_halfwidth, mf.cw_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.am_halfwidth, mf.am_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.nfm_halfwidth, mf.nfm_halfwidth, fa),
                FD.complex_bandpass_taps(mf.numtaps, -mf.ssb_hi, -mf.ssb_lo, fa),  # LSB
            ],
            hop=cfg.ols_hop,
        )
        self.spectrum = Spectrum(cfg.spectrum_nfft, cfg.spectrum_avg)
        # per-mode attack/release/hang AGC (reference [U:agc.c] parity);
        # a single AgcConfig fans out to all 6 mode slots when agc_modes
        # is unset, reproducing the round-1 single-profile behavior
        n_modes = demod_op.SAM + 1
        mode_cfgs = cfg.agc_modes if cfg.agc_modes is not None else (cfg.agc,) * n_modes
        assert len(mode_cfgs) == n_modes
        self.agc_bank = agc_op.AgcBank(mode_cfgs, fa)
        self.cw_tone_word = int(nco.freq_word(cfg.cw_tone_hz, fa))
        from radioframe.ops.interference import AutoNotch, NoiseBlanker, SpectralNR, Vad

        self.nb = NoiseBlanker(cfg.nb_threshold) if cfg.nb_enabled else None
        self.nr = SpectralNR(cfg.nr_nfft) if cfg.nr_enabled else None
        self.notch = AutoNotch(cfg.notch_nfft) if cfg.notch_enabled else None
        # VAD frames share nr_nfft so its flags align with NR's frames
        self.vad = (Vad(cfg.nr_nfft, cfg.vad_energy_ratio, cfg.vad_flatness_max)
                    if cfg.vad_enabled else None)
        # NFM de-emphasis (one-pole biquad, complements TX pre-emphasis)
        self.deemph = None
        if cfg.nfm_deemphasis_s > 0.0:
            from radioframe.ops.biquad import BiquadCascade

            self.deemph = BiquadCascade(FD.deemphasis_sos(cfg.nfm_deemphasis_s, fa))
        # minimum input block: every stage's constraint pulled back to fs_in
        r = 1
        lcm = 1
        for st, dec in zip(cfg.stages, self.decimators):
            lcm = np.lcm(lcm, r * dec.R)
            r *= dec.R
        lcm = int(np.lcm(lcm, r * self.mode_bank.hop))
        lcm = int(np.lcm(lcm, r * cfg.spectrum_nfft)) if cfg.emit_spectrum else lcm
        if cfg.nr_enabled or cfg.vad_enabled:
            lcm = int(np.lcm(lcm, r * cfg.nr_nfft))
        if cfg.notch_enabled:
            lcm = int(np.lcm(lcm, r * cfg.notch_nfft))
        self.min_block = lcm

    # -- state ---------------------------------------------------------------

    def init_state(self, num_channels: int | None = None):
        C = self.cfg.channels if num_channels is None else num_channels
        if self.frontend is not None:
            decim0 = (self.frontend.init_state(C)["tail"],)
            rest = self.decimators[self.frontend_stages :]
        else:
            decim0 = (self.decimators[0].init_state(C),) if self.decimators else ()
            rest = self.decimators[1:]
        return {
            "nco": nco.init_state(C),
            "decim": decim0 + tuple(d.init_state(C) for d in rest),
            "bpf": self.mode_bank.init_state(C),
            "demod": demod_op.bank_init(C),
            "agc": self.agc_bank.init_state(C),
            "spec": self.spectrum.init_state(C),
            "nb": self.nb.init_state(C) if self.nb else (),
            "nr": self.nr.init_state(C) if self.nr else (),
            "vad": self.vad.init_state(C) if self.vad else (),
            "notch": self.notch.init_state(C) if self.notch else (),
            "squelch": jnp.zeros((C,), jnp.float32) if self.cfg.squelch_enabled else (),
            "deemph": self.deemph.init_state(C) if self.deemph else (),
        }

    # -- the block program ---------------------------------------------------

    # Stage split for the pipelined executor (radioframe/shard/pipeline.py):
    # ``step_front`` is the full-rate half (NCO mix + decimation — the
    # reference's FPGA datapath, SURVEY.md §2.1 #1-#4) and ``step_back`` the
    # audio-rate half (channel filter .. AGC/squelch/spectrum — the MCU block
    # loop, §2.1 #6-#13). ``step`` composes them; outputs are identical.

    FRONT_KEYS = ("nco", "decim")

    def split_state(self, state):
        """Full state dict -> (front_state, back_state)."""
        f = {k: state[k] for k in self.FRONT_KEYS}
        b = {k: v for k, v in state.items() if k not in self.FRONT_KEYS}
        return f, b

    def step_front(self, fstate, iq, freq_words):
        """Full-rate stage: (fstate, iq (C,T) c64, words (C,) i32)
        -> (fstate, x (C, T/decim) c64, power_in (C,) f32)."""
        assert iq.shape[-1] % self.min_block == 0, (
            f"block length {iq.shape[-1]} must be a multiple of {self.min_block}")
        # an int16-ingest chain scales counts by 2**-15 (folded into the
        # kernel's taps), so normalized complex input here would come out
        # attenuated 32768x with no error
        assert not self.cfg.int16_ingest, (
            "chain built with int16_ingest=True: feed int16 count planes via "
            "step_i16/step_front_i16, not normalized complex input")
        if self.frontend is not None:
            return self._front_kernel(fstate, jnp.real(iq), jnp.imag(iq), freq_words)
        return self._front_xla(fstate, iq, freq_words)

    def _front_xla(self, fstate, iq, freq_words):
        x, nco_acc = nco.mix_down(iq, freq_words, fstate["nco"])
        tails = []
        for d, tail in zip(self.decimators, fstate["decim"]):
            x, t = d(tail, x)
            tails.append(t)
        pw = jnp.mean(jnp.abs(iq) ** 2, axis=-1)
        return {"nco": nco_acc, "decim": tuple(tails)}, x, pw

    def _front_kernel(self, fstate, xr, xi, freq_words):
        fe = self.frontend
        # int16 counts reach the kernel as float32 (the scale stays folded
        # in its taps): the kernel reading 2-byte words measured slower end
        # to end on an H100 than this upcast pass plus a float32 kernel
        xr, xi = xr.astype(jnp.float32), xi.astype(jnp.float32)
        fst = {"acc": fstate["nco"], "tail": fstate["decim"][0]}
        fst, x, pwsum = fe.step_planes(fst, xr, xi, freq_words, return_power=True)
        tails = [fst["tail"]]
        for d, tail in zip(self.decimators[self.frontend_stages :], fstate["decim"][1:]):
            x, t = d(tail, x)
            tails.append(t)
        pw = pwsum * jnp.float32(fe.input_scale ** 2 / xr.shape[-1])
        return {"nco": fst["acc"], "decim": tuple(tails)}, x, pw

    def step_front_i16(self, fstate, xr, xi, freq_words):
        """int16 ADC ingest (cfg.int16_ingest): xr/xi are (C, T) int16 count
        planes, the reference's native IQ word format (`[U:fpga.c]`),
        upcast on the device and scaled by 2**-15 (folded into the Triton
        front end's taps where it runs)."""
        assert self.cfg.int16_ingest, "chain not built with int16_ingest"
        assert xr.shape[-1] % self.min_block == 0
        if self.frontend is not None:
            return self._front_kernel(fstate, xr, xi, freq_words)
        s = jnp.float32(2.0 ** -15)
        iq = lax.complex(xr.astype(jnp.float32) * s, xi.astype(jnp.float32) * s)
        return self._front_xla(fstate, iq, freq_words)

    def step_i16(self, state, xr, xi, freq_words, mode):
        """Full RX block step from int16 count planes (see step_front_i16)."""
        fstate, bstate = self.split_state(state)
        fstate, x, pw = self.step_front_i16(fstate, xr, xi, freq_words)
        bstate, audio, aux = self.step_back(bstate, x, mode, pw)
        return {**fstate, **bstate}, audio, aux

    def step(self, state, iq, freq_words, mode):
        """(state, iq (C,T) c64, freq_words (C,) i32, mode (C,) i32)
        -> (state, audio (C, T/decim) f32, aux dict)."""
        fstate, bstate = self.split_state(state)
        fstate, x, pw = self.step_front(fstate, iq, freq_words)
        bstate, audio, aux = self.step_back(bstate, x, mode, pw)
        return {**fstate, **bstate}, audio, aux

    def step_back(self, state, x, mode, power_in):
        """Audio-rate stage: (bstate, x (C, T/decim) c64, mode (C,) i32,
        power_in (C,) f32) -> (bstate, audio, aux)."""
        cfg = self.cfg
        nb_state = state.get("nb", ())
        if self.nb:
            x, nb_state = self.nb(state["nb"], x)  # impulse excision pre-filter
        # per-channel mode filter, selected in the FREQUENCY domain: one
        # forward + one inverse FFT instead of K (ops/ols.py apply_selected)
        sel, bpf_tail = self.mode_bank.apply_selected(
            state["bpf"], x, demod_op.filter_index(mode))
        notch_state = state.get("notch", ())
        if self.notch:
            sel, notch_state = self.notch(state["notch"], sel)
        vad_state = state.get("vad", ())
        voice = None
        if self.vad:
            # flags computed on the same signal NR sees (post-filter/notch)
            voice, vad_state = self.vad(state["vad"], sel)
        nr_state = state.get("nr", ())
        if self.nr:
            sel, nr_state = self.nr(state["nr"], sel, voice=voice)
        cw_word = jnp.full(mode.shape[0], self.cw_tone_word, jnp.int32)
        audio, demod_state = demod_op.bank_apply(
            state["demod"], sel, mode, cw_word, cfg.fs_audio,
            cfg.nfm_deviation_hz, enabled=cfg.enabled_modes)
        deemph_state = state.get("deemph", ())
        if self.deemph is not None:
            # de-emphasis runs dense, selected for NFM channels only (the
            # squelch below then gates the de-emphasized audio)
            de, deemph_state = self.deemph(state["deemph"], audio)
            audio = jnp.where((mode == demod_op.NFM)[:, None], de, audio)
        # AGC on SSB/CW/AM; FM audio is amplitude-invariant (deviation-scaled)
        # and AGC would only pump on warm-up transients — the reference
        # likewise runs AGC only outside FM mode.
        agc_audio, agc_env, agc_gain = self.agc_bank.apply(state["agc"], audio, mode)
        audio = jnp.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
        sq_state = state.get("squelch", ())
        if cfg.squelch_enabled:
            gated, sq_state, sq_open = demod_op.squelch(
                state["squelch"], audio, cfg.squelch_threshold)
            audio = jnp.where((mode == demod_op.NFM)[:, None], gated, audio)
        # power_in may come from a (1, T) iq broadcast; report per channel
        aux = {"agc_gain_last": agc_gain[:, -1],
               "power_in": jnp.broadcast_to(power_in, mode.shape).astype(jnp.float32)}
        if voice is not None:
            aux["vad_active"] = voice  # (C, F) per-frame flags
        if cfg.emit_spectrum:
            lines, spec_prev = self.spectrum(state["spec"], x)
            aux["spectrum"] = lines
        else:
            spec_prev = state["spec"]
        new_state = {
            "bpf": bpf_tail,
            "demod": demod_state,
            "agc": agc_env,
            "spec": spec_prev,
            "nb": nb_state,
            "nr": nr_state,
            "notch": notch_state,
            "squelch": sq_state,
            "vad": vad_state,
            "deemph": deemph_state,
        }
        return new_state, audio, aux
