"""Channelizer pipeline — wideband IQ -> M channels -> per-channel AGC/demod
+ wideband waterfall (BASELINE config 5, unsharded reference program;
the sharded version is radioframe/shard/channelizer.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from radioframe.core.config import AgcConfig
from radioframe.ops import agc as agc_op
from radioframe.ops import demod as demod_op
from radioframe.ops import nco
from radioframe.ops.pfb import PfbChannelizer
from radioframe.ops.spectrum import Spectrum


@dataclass(frozen=True)
class ChannelizerConfig:
    fs_in: float = 61_440_000.0      # wideband input rate
    num_channels: int = 4096
    taps_per_channel: int = 8
    agc: AgcConfig = field(default_factory=AgcConfig)
    # optional per-mode AGC profiles (len-6, by demod mode code)
    agc_modes: tuple | None = None
    cw_tone_hz: float = 600.0
    nfm_deviation_hz: float = 2500.0
    spectrum_nfft: int = 4096
    # EMA waterfall averaging across frames (0 = raw lines), like
    # RxConfig.spectrum_avg; completed across time shards when sharded
    spectrum_avg: float = 0.0
    emit_spectrum: bool = True
    # derive the waterfall from the PFB output itself instead of a separate
    # hann-windowed wideband FFT: |y[c, f]|^2 IS a periodogram whose window
    # is the K*M-tap prototype filter (better sidelobes than one hann
    # frame), and the spectral FFT work is already paid. Lines are linear
    # power averaged over ``waterfall_frame_avg`` frames, then dB — the
    # classic averaged waterfall, at 1/avg the log-op cost. The separate
    # Spectrum path stays the default for `[U:fft.c]` panorama parity.
    waterfall_from_pfb: bool = False
    waterfall_frame_avg: int = 1
    # statically restrict which demods compile (None = all six); see
    # ops/demod.py bank_apply — a deployment without SAM doesn't pay for it
    enabled_modes: tuple | None = None

    @property
    def fs_channel(self) -> float:
        return self.fs_in / self.num_channels


def pfb_waterfall_lines(chans, frame_avg: int):
    """PFB output (M, F) -> waterfall lines (F/avg, M) in dB, low..high
    frequency order (channel c sits at +c*fs/M; roll by M/2 = fftshift)."""
    M, F = chans.shape
    p = jnp.real(chans) ** 2 + jnp.imag(chans) ** 2
    pa = p.reshape(M, F // frame_avg, frame_avg).mean(axis=-1)
    db = 10.0 * jnp.log10(jnp.maximum(pa, 1e-24)).astype(jnp.float32)
    return jnp.roll(db, M // 2, axis=0).T


class ChannelizerChain:
    """(state, wideband (T,), mode (M,)) -> (state, audio (M, T/M), aux)."""

    def __init__(self, cfg: ChannelizerConfig):
        self.cfg = cfg
        self.pfb = PfbChannelizer(cfg.num_channels, cfg.taps_per_channel)
        self.spectrum = Spectrum(cfg.spectrum_nfft, cfg.spectrum_avg)
        n_modes = demod_op.SAM + 1
        mode_cfgs = cfg.agc_modes if cfg.agc_modes is not None else (cfg.agc,) * n_modes
        self.agc_bank = agc_op.AgcBank(mode_cfgs, cfg.fs_channel)
        self.cw_tone_word = int(nco.freq_word(cfg.cw_tone_hz, cfg.fs_channel))
        if cfg.waterfall_from_pfb:
            assert cfg.spectrum_avg == 0.0, (
                "waterfall_from_pfb uses linear frame averaging "
                "(waterfall_frame_avg), not the dB-domain EMA")
        self.min_block = cfg.num_channels * max(cfg.taps_per_channel, 1)
        if cfg.waterfall_from_pfb and cfg.waterfall_frame_avg > 1:
            self.min_block = int(np.lcm(self.min_block,
                                        cfg.num_channels * cfg.waterfall_frame_avg))

    def init_state(self):
        M = self.cfg.num_channels
        # no spec state when the waterfall derives from the PFB output
        # (stateless per line) — no carried-but-never-updated leaves
        spec = (() if self.cfg.waterfall_from_pfb or not self.cfg.emit_spectrum
                else self.spectrum.init_state(1))
        return {
            "pfb": self.pfb.init_state(1),
            "demod": demod_op.bank_init(M),
            "agc": self.agc_bank.init_state(M),
            "spec": spec,
        }

    def step(self, state, wideband, mode):
        cfg = self.cfg
        M = cfg.num_channels
        # ADVICE r3: name the constraint here (min_block includes the
        # waterfall averaging factor) instead of failing in a deep reshape
        assert wideband.shape[-1] % self.min_block == 0, (
            f"block length {wideband.shape[-1]} must be a multiple of "
            f"{self.min_block} (num_channels x taps/waterfall_frame_avg lcm)")
        chans, pfb_tail = self.pfb(state["pfb"], wideband[None, :])  # (1, M, F)
        chans = chans[0]  # (M, F)
        cw_word = jnp.full((M,), self.cw_tone_word, jnp.int32)
        audio, demod_state = demod_op.bank_apply(
            state["demod"], chans, mode, cw_word, cfg.fs_channel,
            cfg.nfm_deviation_hz, enabled=cfg.enabled_modes)
        agc_audio, agc_env, agc_gain = self.agc_bank.apply(state["agc"], audio, mode)
        audio = jnp.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
        aux = {"channel_power": jnp.mean(jnp.abs(chans) ** 2, axis=-1)}
        spec_prev = state["spec"]
        if cfg.emit_spectrum:
            if cfg.waterfall_from_pfb:
                aux["waterfall"] = pfb_waterfall_lines(chans, cfg.waterfall_frame_avg)
            else:
                lines, spec_prev = self.spectrum(state["spec"], wideband[None, :])
                aux["waterfall"] = lines[0]  # (F_spec, nfft)
        new_state = {"pfb": pfb_tail, "demod": demod_state, "agc": agc_env, "spec": spec_prev}
        return new_state, audio, aux
