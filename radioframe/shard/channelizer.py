"""Pod-sharded channelizer (BASELINE config 5; SURVEY.md §2.3 re-shard row).

One formulation over a 1-D device mesh ("dev", D devices):

  wideband IQ, time-sharded P('dev')
    -> causal halo ((K-1)*M raw samples via ppermute)
    -> per-shard PFB (polyphase accumulate + M-point FFT)   [time-sharded]
    -> lax.all_to_all transpose: channels split D-ways, frames gathered
       (the Ulysses-style reshard between time-parallel filtering and
       channel-parallel demod)
    -> per-channel demod bank + AGC on full-length channel streams
       [channel-sharded, no further collectives]

  Audio out: (M, F) sharded P('dev') over channels. A Spectrum waterfall
  stays time-sharded P('dev') over frames; a PFB-derived waterfall comes
  out channel-sharded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from radioframe.ops import demod as demod_op
from radioframe.pipelines.channelizer import ChannelizerChain
from radioframe.shard.halo import causal_halo, last_shard_value, sharded_affine_scan


class ShardedChannelizer:
    def __init__(self, chain: ChannelizerChain, mesh, axis: str = "dev"):
        self.chain = chain
        self.mesh = mesh
        self.axis = axis
        D = mesh.shape[axis]
        assert chain.cfg.num_channels % D == 0
        if chain.cfg.emit_spectrum and chain.cfg.spectrum_avg > 0.0:
            from radioframe.ops.spectrum import Spectrum

            self._raw_spec = Spectrum(chain.cfg.spectrum_nfft, 0.0)

    def _local_step(self, state, wideband, mode):
        chain, cfg, ax = self.chain, self.chain.cfg, self.axis
        M = cfg.num_channels
        D = lax.axis_size(ax)
        H = (chain.pfb.K - 1) * M

        x = wideband[None, :]  # (1, T_loc)
        xp, pfb_carry = causal_halo(x, state["pfb"], H, ax)
        chans, _ = chain.pfb(xp[:, :H], x)  # (1, M, F_loc)
        chans = chans[0]  # (M, F_loc)

        # reshard: channels -> P(dev), frames -> full length
        if D > 1:
            chans = lax.all_to_all(chans, ax, split_axis=0, concat_axis=1, tiled=True)
        # (M/D, F) — each device now owns M/D channels' full streams

        cw_word = jnp.full((chans.shape[0],), chain.cw_tone_word, jnp.int32)
        audio, demod_state = demod_op.bank_apply(
            state["demod"], chans, mode, cw_word, cfg.fs_channel,
            cfg.nfm_deviation_hz, enabled=cfg.enabled_modes)
        # channels are sharded, time is whole here — the per-mode AGC bank
        # runs locally per shard, no collectives needed
        agc_audio, agc_env, agc_gain = chain.agc_bank.apply(state["agc"], audio, mode)
        audio = jnp.where((mode == demod_op.NFM)[:, None], audio, agc_audio)

        aux = {"channel_power": jnp.mean(jnp.abs(chans) ** 2, axis=-1)}
        spec_prev = state["spec"]
        if cfg.emit_spectrum:
            if cfg.waterfall_from_pfb:
                # chans are channel-sharded with whole frame streams here, so
                # each shard emits full-length lines for its M/D channels
                # (out spec P(None, dev)); the global fftshift roll runs
                # OUTSIDE shard_map in step() so sharded == unsharded exactly
                A = cfg.waterfall_frame_avg
                Ml, Fl = chans.shape
                p = jnp.real(chans) ** 2 + jnp.imag(chans) ** 2
                pa = p.reshape(Ml, Fl // A, A).mean(axis=-1)
                db = 10.0 * jnp.log10(jnp.maximum(pa, 1e-24)).astype(jnp.float32)
                aux["waterfall"] = db.T  # (F/A, M/D) channel-sharded, UNROLLED
            elif cfg.spectrum_avg > 0.0:
                # EMA waterfall: raw dB lines locally, then the affine scan
                # completed across time shards (same as shard/rx.py)
                db, _ = self._raw_spec(state["spec"], x)  # (1, F_loc, nfft)
                _, Fl, nf = db.shape
                b = (1.0 - cfg.spectrum_avg) * jnp.moveaxis(db, 1, -1).reshape(nf, Fl)
                lines_flat, prev_flat = sharded_affine_scan(
                    cfg.spectrum_avg, b, state["spec"].reshape(nf), ax)
                lines = jnp.moveaxis(lines_flat.reshape(1, nf, Fl), -1, 1)
                spec_prev = prev_flat.reshape(1, nf)
                aux["waterfall"] = lines[0]  # (F_spec_loc, nfft), time-sharded
            else:
                lines, _ = chain.spectrum(state["spec"], x)
                spec_prev = last_shard_value(lines[:, -1, :], ax)
                aux["waterfall"] = lines[0]  # (F_spec_loc, nfft), time-sharded
        new_state = {"pfb": pfb_carry, "demod": demod_state, "agc": agc_env,
                     "spec": spec_prev}
        return new_state, audio, aux

    def state_specs(self):
        """Public PartitionSpec tree for mesh.place_state (donation hygiene)."""
        return self._state_specs()

    def _state_specs(self):
        ax = self.axis
        cfg = self.chain.cfg
        has_spec = cfg.emit_spectrum and not cfg.waterfall_from_pfb
        return {
            "pfb": P(None, None),  # replicated carry
            "demod": {"cw_phase": P(ax), "am_dc": P(None, ax), "nfm_last": P(ax),
                      "sam_dc": P(None, ax), "sam_carrier": P(None, ax)},
            "agc": {"hist": P(ax, None) if self.chain.agc_bank.hist_len else (),
                    "env": P(ax), "lpf": P(ax)},
            "spec": P(None, None) if has_spec else (),
        }

    def step(self, state, wideband, mode):
        ax = self.axis
        cfg = self.chain.cfg
        aux_spec = {"channel_power": P(ax)}
        if cfg.emit_spectrum:
            # PFB-derived waterfall: frames whole, channels sharded;
            # Spectrum waterfall: frames time-sharded, bins whole
            aux_spec["waterfall"] = (P(None, ax) if cfg.waterfall_from_pfb
                                     else P(ax, None))
        fn = jax.shard_map(
            self._local_step,
            mesh=self.mesh,
            in_specs=(self._state_specs(), P(ax), P(ax)),
            out_specs=(self._state_specs(), P(ax, None), aux_spec),
            check_vma=False,
        )
        state, audio, aux = fn(state, wideband, mode)
        if cfg.emit_spectrum and cfg.waterfall_from_pfb:
            # global fftshift (channel c at +c*fs/M -> low..high order),
            # outside shard_map so the roll crosses shards correctly
            aux["waterfall"] = jnp.roll(aux["waterfall"],
                                        cfg.num_channels // 2, axis=-1)
        return state, audio, aux

    def init_state(self):
        return self.chain.init_state()
