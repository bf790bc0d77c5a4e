"""ShardedRxChain — the RX block program over a ('channel', 'time') mesh.

BASELINE.json config 3 (64-channel sharded DDC with halo exchange) and the
scaling substrate for config 5. Design per SURVEY.md §2.3:

  - ``channel`` axis: embarrassingly parallel (DP-analog) — every op is
    already batched over channels, so sharding the C dim needs no collectives.
  - ``time`` axis: sequence parallelism — one contiguous IQ block split
    across shards. Causal FIR/CIC tails cross shard boundaries via
    ppermute halos; AGC/DC-block/FM recursions finish with all-gather
    prefix scans (radioframe/shard/halo.py). The int32 DDS NCO needs NO
    communication: shard d derives its oscillator segment from the
    replicated phase word at offset d*T_local, bit-identical to unsharded.

Produces the same (state, audio, aux) as RxChain.step, with identical
numerics up to fp32 reassociation — asserted by tests/test_sharded.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from radioframe.ops import agc as agc_op
from radioframe.ops import demod as demod_op
from radioframe.ops import nco
from radioframe.pipelines.rx_chain import RxChain
from radioframe.shard.halo import (
    causal_halo,
    last_shard_value,
    sharded_affine_scan,
    sharded_biquad_cascade,
    sharded_maxdecay_scan,
)


def _halo_tail(x_local, carry, H, axis="time"):
    """(prepend_tail (C, H), new_carry) — carry replicated across time axis."""
    if H == 0:
        return x_local[..., :0], carry
    xp, new_carry = causal_halo(x_local, carry, H, axis)
    return xp[..., :H], new_carry


class ShardedRxChain:
    """Wraps an RxChain's ops in a shard_map'd block step."""

    def __init__(self, chain: RxChain, mesh, channel_axis="channel", time_axis="time"):
        self.chain = chain
        self.mesh = mesh
        self.ca, self.ta = channel_axis, time_axis
        if chain.cfg.emit_spectrum and chain.cfg.spectrum_avg > 0.0:
            from radioframe.ops.spectrum import Spectrum

            self._raw_spec = Spectrum(chain.cfg.spectrum_nfft, 0.0)

    # ---- per-shard body (runs inside shard_map) ---------------------------

    def _local_step(self, state, iq, words, mode):
        chain, cfg, ta = self.chain, self.chain.cfg, self.ta
        D = lax.axis_size(ta)
        d = lax.axis_index(ta)
        T_loc = iq.shape[-1]

        new_nco = state["nco"] + words * jnp.int32(D * T_loc)
        if chain.frontend is not None:
            # front-end kernel under time sharding: the DDS phase is affine in
            # the sample index, so shard d offsets the accumulator by
            # word*d*T_loc (int32 wrap, bit-exact vs unsharded); the halo
            # carries RAW iq, mixed inside the kernel at its global indices
            acc_d = state["nco"] + words * (d * jnp.int32(T_loc))
            prepend, carry0 = _halo_tail(iq, state["decim"][0],
                                         chain.frontend.tail_len, ta)
            _, x = chain.frontend.step({"acc": acc_d, "tail": prepend}, iq, words)
            tails = [carry0]
            dec_rest = zip(chain.decimators[chain.frontend_stages:], state["decim"][1:])
        else:
            # NCO: local segment at global offset d*T_loc, no comms
            x = nco.mix_down_at(iq, words, state["nco"], d * jnp.int32(T_loc))
            tails = []
            dec_rest = zip(chain.decimators, state["decim"])

        # decimation stages: halo = L-1 input samples from left neighbor
        for dec, carry in dec_rest:
            prepend, new_carry = _halo_tail(x, carry, dec.tail_len, ta)
            x, _ = dec(prepend, x)
            tails.append(new_carry)

        # noise blanker: running-power affine scan crosses shards
        nb_state = ()
        if chain.nb:
            p = jnp.abs(x).astype(jnp.float32) ** 2
            avg, nb_state = sharded_affine_scan(
                chain.nb.pole, (1.0 - chain.nb.pole) * p, state["nb"], ta)
            mask = p > chain.nb.k2 * jnp.maximum(avg, 1e-12)
            x = jnp.where(mask, jnp.zeros((), x.dtype), x)

        # mode-filter OLS bank: halo at audio rate; per-channel response
        # selected in the frequency domain (one IFFT, see ops/ols.py)
        prepend, bpf_carry = _halo_tail(x, state["bpf"], chain.mode_bank.L - 1, ta)
        sel, _ = chain.mode_bank.apply_selected(prepend, x, demod_op.filter_index(mode))

        # auto-notch: per-bin EMA from the GLOBAL frame mean (psum over time)
        notch_state = ()
        if chain.notch:
            nf = chain.notch.nfft
            Cn, Tn = sel.shape
            X = jnp.fft.fft(sel.reshape(Cn, Tn // nf, nf), axis=-1)
            mag = jnp.abs(X).astype(jnp.float32)
            F_tot = (Tn // nf) * D
            gmean = lax.psum(jnp.sum(mag, axis=1), ta) / F_tot
            new_ema = chain.notch.ema * state["notch"] + (1.0 - chain.notch.ema) * gmean
            W = chain.notch.W
            bg = sum(jnp.roll(new_ema, s, axis=-1) for s in range(-W, W + 1) if s != 0) / (2 * W)
            nmask = new_ema > chain.notch.ratio * jnp.maximum(bg, 1e-9)
            sel = jnp.fft.ifft(X * jnp.where(nmask[:, None, :], 0.0, 1.0), axis=-1)
            sel = sel.reshape(Cn, Tn).astype(jnp.complex64)
            notch_state = new_ema

        # VAD: minimum-statistics quiet floor over the GLOBAL block (pmin);
        # per-frame flags stay local (frames are time-sharded)
        vad_state = ()
        voice = None
        if chain.vad:
            nf = chain.vad.nfft
            Cv, Tv = sel.shape
            Xv = jnp.fft.fft(sel.reshape(Cv, Tv // nf, nf), axis=-1)
            pv = jnp.abs(Xv).astype(jnp.float32) ** 2 + 1e-12
            energy = jnp.mean(pv, axis=-1)  # (C, F_loc)
            gmin_e = lax.pmin(jnp.min(energy, axis=-1), ta)
            new_floor = jnp.minimum(state["vad"] * chain.vad.up, gmin_e)
            flat = jnp.exp(jnp.mean(jnp.log(pv), axis=-1)) / energy
            voice = ((energy > chain.vad.ratio * new_floor[:, None])
                     & (flat < chain.vad.flat_max))
            vad_state = new_floor

        # spectral NR: minimum statistics over the GLOBAL block (pmin);
        # voice-active frames excluded from the estimate update (VAD gating)
        nr_state = ()
        if chain.nr:
            nf = chain.nr.nfft
            Cn, Tn = sel.shape
            X = jnp.fft.fft(sel.reshape(Cn, Tn // nf, nf), axis=-1)
            mag = jnp.abs(X).astype(jnp.float32)
            F_tot = (Tn // nf) * D
            if voice is None:
                gmin = lax.pmin(jnp.min(mag, axis=1), ta)
                est = jnp.minimum(state["nr"] * chain.nr.up,
                                  gmin * (chain.nr.bias * float(np.sqrt(F_tot))))
            else:
                inf = jnp.float32(np.inf)
                loc_min = jnp.min(jnp.where(voice[:, :, None], inf, mag), axis=1)
                gmin = lax.pmin(loc_min, ta)
                n_quiet = lax.psum(jnp.sum((~voice).astype(jnp.int32), axis=1), ta)
                cand = jnp.minimum(state["nr"] * chain.nr.up,
                                   gmin * (chain.nr.bias * float(np.sqrt(F_tot))))
                est = jnp.where((n_quiet > 0)[:, None], cand, state["nr"])
            gain_nr = jnp.clip(1.0 - chain.nr.beta * est[:, None, :] / jnp.maximum(mag, 1e-9),
                               chain.nr.floor, 1.0)
            sel = jnp.fft.ifft(X * gain_nr, axis=-1).reshape(Cn, Tn).astype(jnp.complex64)
            nr_state = est

        Ta_loc = sel.shape[-1]
        # demod bank, sharded: cw NCO at offset; nfm 1-sample halo; am dc
        # scan. Static mode-subset gating + masked-sum select, mirroring
        # ops/demod.py bank_apply (disabled demods' states pass through).
        en = (frozenset(range(demod_op.SAM + 1)) if cfg.enabled_modes is None
              else frozenset(map(int, cfg.enabled_modes)))
        m_sel = mode[:, None]
        audio = jnp.zeros(sel.shape, jnp.float32)
        if en & {demod_op.SSB, demod_op.LSB}:
            y_ssb = demod_op.demod_ssb(sel)
            ssb_m = ((m_sel == demod_op.SSB) if demod_op.SSB in en
                     else jnp.zeros_like(m_sel, bool))
            lsb_m = ((m_sel == demod_op.LSB) if demod_op.LSB in en
                     else jnp.zeros_like(m_sel, bool))
            audio = audio + jnp.where(ssb_m | lsb_m, y_ssb, 0.0)

        cw_word = jnp.full(sel.shape[0], chain.cw_tone_word, jnp.int32)
        new_cw = state["demod"]["cw_phase"]
        if demod_op.CW in en:
            y_cw = 2.0 * jnp.real(nco.mix_up_at(sel, cw_word, state["demod"]["cw_phase"],
                                                d * jnp.int32(Ta_loc)))
            new_cw = state["demod"]["cw_phase"] + cw_word * jnp.int32(D * Ta_loc)
            audio = audio + jnp.where(m_sel == demod_op.CW, y_cw, 0.0)

        new_am_dc = state["demod"]["am_dc"]
        if demod_op.AM in en:
            env_am = jnp.abs(sel).astype(jnp.float32)
            xprev_pre, new_am_xprev = _halo_tail(env_am, state["demod"]["am_dc"][0][:, None], 1, ta)
            xprev = jnp.concatenate([xprev_pre, env_am[:, :-1]], axis=-1)
            b = env_am - xprev
            y_am, new_am_y = sharded_affine_scan(0.995, b, state["demod"]["am_dc"][1], ta)
            new_am_dc = jnp.stack([jnp.real(new_am_xprev[:, -1]), new_am_y])
            audio = audio + jnp.where(m_sel == demod_op.AM, y_am, 0.0)

        new_nfm_last = state["demod"]["nfm_last"][:, None]
        if demod_op.NFM in en:
            prev_pre, new_nfm_last = _halo_tail(sel, state["demod"]["nfm_last"][:, None], 1, ta)
            xprev_c = jnp.concatenate([prev_pre, sel[:, :-1]], axis=-1)
            dd = sel * jnp.conj(xprev_c)
            y_nfm = jnp.arctan2(jnp.imag(dd), jnp.real(dd)) * jnp.float32(
                cfg.fs_audio / (2.0 * np.pi * cfg.nfm_deviation_hz))
            audio = audio + jnp.where(m_sel == demod_op.NFM, y_nfm, 0.0)

        new_sam_dc = state["demod"]["sam_dc"]
        new_sam_carrier = state["demod"]["sam_carrier"]
        if demod_op.SAM in en:
            # SAM: global lag-1 autocorrelation (psum; shard 0 drops the term
            # that would reach before the block), coherent derotation, dc scan
            lag1_pre, _ = _halo_tail(sel, jnp.zeros((sel.shape[0], 1), sel.dtype), 1, ta)
            xl = jnp.concatenate([lag1_pre, sel[:, :-1]], axis=-1)
            prods = sel * jnp.conj(xl)
            first_w = jnp.where(d == 0, 0.0, 1.0)
            prods = prods.at[:, 0].multiply(first_w)
            r1 = lax.psum(jnp.sum(prods, axis=-1), ta)
            w_c = jnp.arctan2(jnp.imag(r1), jnp.real(r1))
            n_loc = d * jnp.int32(Ta_loc) + jnp.arange(Ta_loc, dtype=jnp.int32)
            sam_phase = state["demod"]["sam_carrier"][0][:, None] + w_c[:, None] * n_loc.astype(jnp.float32)[None, :]
            derot = sel * jnp.exp(-1j * sam_phase).astype(sel.dtype)
            meanp = lax.psum(jnp.sum(derot, axis=-1), ta)
            meanp = meanp / jnp.maximum(jnp.abs(meanp), 1e-9)
            coherent = jnp.real(derot * jnp.conj(meanp)[:, None]).astype(jnp.float32)
            sam_prev_pre, new_sam_x = _halo_tail(coherent, state["demod"]["sam_dc"][0][:, None], 1, ta)
            sam_b = coherent - jnp.concatenate([sam_prev_pre, coherent[:, :-1]], axis=-1)
            y_sam, new_sam_y = sharded_affine_scan(0.995, sam_b, state["demod"]["sam_dc"][1], ta)
            new_sam_dc = jnp.stack([new_sam_x[:, -1], new_sam_y])
            new_sam_carrier = jnp.stack([
                jnp.mod(state["demod"]["sam_carrier"][0] + w_c * (D * Ta_loc),
                        jnp.float32(2.0 * np.pi)), w_c])
            audio = audio + jnp.where(m_sel == demod_op.SAM, y_sam, 0.0)
        audio = audio.astype(jnp.float32)

        # NFM de-emphasis: dense cross-shard biquad, selected per channel
        deemph_state = ()
        if chain.deemph is not None:
            de, deemph_state = sharded_biquad_cascade(
                chain.deemph, state["deemph"], audio, ta)
            audio = jnp.where((mode == demod_op.NFM)[:, None], de, audio)

        # AGC: hang sliding-max (hist_len halo) + cross-shard release
        # max-decay and attack affine scans, per-mode constants gathered
        # per channel (ops/agc.py AgcBank; halo requires hist_len <= T_loc)
        bank = chain.agc_bank
        mag = jnp.abs(audio).astype(jnp.float32)
        xp_agc, hist_carry = causal_halo(mag, state["agc"]["hist"], bank.hist_len, ta)
        m_agc = bank.hang_select(xp_agc, mag.shape[-1], mode)
        rel_c, al_c, _, _ = bank.per_channel(mode)
        env_r, new_env = sharded_maxdecay_scan(rel_c, m_agc, state["agc"]["env"], ta)
        env, new_lpf = sharded_affine_scan(al_c, (1.0 - al_c)[:, None] * env_r,
                                           state["agc"]["lpf"], ta)
        new_agc = {"hist": hist_carry, "env": new_env, "lpf": new_lpf}
        gain = bank.gain_from_env(env, mode)
        agc_audio = audio * gain
        audio = jnp.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
        sq_state = ()
        if cfg.squelch_enabled:
            # discriminator HF noise: global mean |diff| (1-sample halo + psum)
            dpre, _ = _halo_tail(audio, jnp.zeros((audio.shape[0], 1), audio.dtype), 1, ta)
            diffs = jnp.abs(audio - jnp.concatenate([dpre, audio[:, :-1]], axis=-1))
            diffs = diffs.at[:, 0].multiply(jnp.where(d == 0, 0.0, 1.0))
            hf = lax.psum(jnp.sum(diffs, axis=-1), ta) / (D * audio.shape[-1] - 1)
            sq_state = 0.5 * state["squelch"] + 0.5 * hf  # match demod_op.squelch
            is_open = sq_state < cfg.squelch_threshold
            audio = jnp.where((mode == demod_op.NFM)[:, None],
                              audio * is_open[:, None], audio)

        pw = lax.psum(jnp.sum(jnp.abs(iq) ** 2, axis=-1), ta) / (D * T_loc)
        aux = {
            "agc_gain_last": last_shard_value(gain[:, -1], ta),
            "power_in": jnp.broadcast_to(pw, mode.shape).astype(jnp.float32),
        }
        if voice is not None:
            aux["vad_active"] = voice  # (C, F_loc) — frames time-sharded
        spec_prev = state["spec"]
        if cfg.emit_spectrum:
            if cfg.spectrum_avg > 0.0:
                db, _ = self._raw_spec(state["spec"], x)  # (C, F_loc, nfft)
                Cs, Fl, nf = db.shape
                b = (1.0 - cfg.spectrum_avg) * jnp.moveaxis(db, 1, -1).reshape(Cs * nf, Fl)
                lines_flat, prev_flat = sharded_affine_scan(
                    cfg.spectrum_avg, b, state["spec"].reshape(Cs * nf), ta)
                lines = jnp.moveaxis(lines_flat.reshape(Cs, nf, Fl), -1, 1)
                spec_prev = prev_flat.reshape(Cs, nf)
            else:
                lines, _ = chain.spectrum(state["spec"], x)
                spec_prev = last_shard_value(lines[:, -1, :], ta)
            aux["spectrum"] = lines

        new_state = {
            "nco": new_nco,
            "decim": tuple(tails),
            "bpf": bpf_carry,
            "demod": {"cw_phase": new_cw, "am_dc": new_am_dc,
                      "nfm_last": new_nfm_last[:, -1],
                      "sam_dc": new_sam_dc, "sam_carrier": new_sam_carrier},
            "agc": new_agc,
            "spec": spec_prev,
            "nb": nb_state, "nr": nr_state, "notch": notch_state,
            "vad": vad_state,
            "squelch": sq_state,
            "deemph": deemph_state,
        }
        return new_state, audio, aux

    # ---- shard_map wrapper -------------------------------------------------

    def state_specs(self):
        """Public PartitionSpec tree for mesh.place_state (donation hygiene)."""
        return self._state_specs()

    def _state_specs(self):
        ca = self.ca
        return {
            "nco": P(ca),
            "decim": tuple(P(ca, None) for _ in range(
                len(self.chain.decimators) - self.chain.frontend_stages
                + (1 if self.chain.frontend else 0))),
            "bpf": P(ca, None),
            "demod": {"cw_phase": P(ca), "am_dc": P(None, ca), "nfm_last": P(ca),
                      "sam_dc": P(None, ca), "sam_carrier": P(None, ca)},
            "agc": {"hist": P(ca, None) if self.chain.agc_bank.hist_len else (),
                    "env": P(ca), "lpf": P(ca)},
            "spec": P(ca, None),
            "nb": P(ca) if self.chain.nb else (),
            "nr": P(ca, None) if self.chain.nr else (),
            "vad": P(ca) if self.chain.vad else (),
            "notch": P(ca, None) if self.chain.notch else (),
            "squelch": P(ca) if self.chain.cfg.squelch_enabled else (),
            "deemph": (tuple(P(ca, None) for _ in self.chain.deemph.sections)
                       if self.chain.deemph else ()),
        }

    def step(self, state, iq, words, mode):
        ca, ta = self.ca, self.ta
        sspec = self._state_specs()
        aux_spec = {"agc_gain_last": P(ca), "power_in": P(ca)}
        if self.chain.vad:
            aux_spec["vad_active"] = P(ca, ta)
        if self.chain.cfg.emit_spectrum:
            aux_spec["spectrum"] = P(ca, ta, None)
        fn = jax.shard_map(
            self._local_step,
            mesh=self.mesh,
            in_specs=(sspec, P(ca, ta), P(ca), P(ca)),
            out_specs=(sspec, P(ca, ta), aux_spec),
            check_vma=False,
        )
        return fn(state, iq, words, mode)

    def init_state(self, num_channels: int):
        return self.chain.init_state(num_channels)
