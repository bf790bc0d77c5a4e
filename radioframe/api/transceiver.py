"""Transceiver — PTT/split/RIT/XIT control plane over the full-duplex chain.

The `[U:trx_manager.c]` analog (SURVEY.md §2.2 #16, §3.3): the reference's
TRX state machine keys RF relays, swaps the UI, and freezes AGC on PTT. Here
the duplex chain computes RX and TX every block regardless (both halves
live in one jitted program, BASELINE config 4); PTT is a
*routing* decision: which half's output is live, with the same observable
semantics (RX muted while transmitting unless split monitoring).

VFO model matches the reference: VFO A/B per channel, split operation
(RX on A, TX on B), RIT/XIT incremental offsets applied at the freq-word
level so they never touch the stored VFO frequency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radioframe.api.bands import BandMemory, band
from radioframe.api.radio import MODE_BY_NAME, NAME_BY_MODE
from radioframe.core.config import RxConfig, TxConfig
from radioframe.ops import nco
from radioframe.pipelines.duplex import DuplexChain


def s_meter(power_linear: float, full_scale_dbm: float = 0.0) -> str:
    """IQ power -> S-meter reading (S1..S9, then dB-over-9).

    The reference calibrates S9 = -73 dBm at the antenna (IARU R.1 Tech.
    Recommendation; `[U:lcd.c]` S-meter bar); digital full-scale maps to
    ``full_scale_dbm``. 6 dB per S-unit below S9.
    """
    if power_linear <= 0.0:
        return "S0"
    dbm = 10.0 * np.log10(power_linear) + full_scale_dbm
    over9 = dbm - (-73.0)
    if over9 >= 0:
        return f"S9+{int(round(over9))}" if over9 >= 0.5 else "S9"
    s = 9 + over9 / 6.0
    return f"S{max(0, int(round(s)))}"


class Transceiver:
    """Multi-channel full-duplex transceiver with trx_manager semantics.

    >>> trx = Transceiver(RxConfig(channels=2), TxConfig(channels=2))
    >>> trx.set_band(0, "40m")          # band memory recall (bands.c)
    >>> trx.split(0, True); trx.vfo_b(0, 7_105_000.0)
    >>> trx.ptt(True)
    >>> audio, tx_iq = trx.process(rx_iq, mic_audio)
    """

    def __init__(self, rx_cfg: RxConfig, tx_cfg: TxConfig):
        assert rx_cfg.channels == tx_cfg.channels
        self.rx_cfg, self.tx_cfg = rx_cfg, tx_cfg
        C = rx_cfg.channels
        self.chain = DuplexChain(rx_cfg, tx_cfg)

        # plane-splitting step (same convention as Radio/Monitor): IQ
        # arrives as f32 planes, the TX IQ leaves as f32 planes, the
        # complex views live only inside the one jitted program
        def _step_planes(state, rx_r, rx_i, mic, rxw, modes, txw, tx_modes):
            st, rx_audio, tx_iq, aux = self.chain.step(
                state, jax.lax.complex(rx_r, rx_i), mic, rxw, modes, txw,
                tx_modes)
            return st, rx_audio, jnp.real(tx_iq), jnp.imag(tx_iq), aux

        self._step = jax.jit(_step_planes)
        self.state = jax.jit(lambda: self.chain.init_state(C))()
        # VFOs + offsets (host side, like the TRX struct — but per channel)
        self._vfo_a = np.zeros(C, np.float64)
        self._vfo_b = np.zeros(C, np.float64)
        self._split = np.zeros(C, bool)
        self._rit = np.zeros(C, np.float64)  # RX incremental tuning (Hz)
        self._xit = np.zeros(C, np.float64)  # TX incremental tuning (Hz)
        self._rx_vfo = np.zeros(C, np.int32)  # receive VFO select: 0=A, 1=B
        self._modes = np.zeros(C, np.int32)
        self._ptt = False
        self.band_memory = BandMemory()
        self.last_aux = None

    # -- VFO / band control (reference: TRX_setFrequency, bands.c) -----------

    def tune(self, channel: int, freq_hz: float):
        self._vfo_a[channel] = freq_hz

    def vfo_b(self, channel: int, freq_hz: float):
        self._vfo_b[channel] = freq_hz

    def swap_vfo(self, channel: int):
        a = self._vfo_a[channel]
        self._vfo_a[channel] = self._vfo_b[channel]
        self._vfo_b[channel] = a

    def split(self, channel: int, enabled: bool):
        self._split[channel] = enabled

    def select_rx_vfo(self, channel: int, which: int):
        """Absolute receive-VFO selection (0=A, 1=B) — idempotent, unlike
        swap_vfo; CAT FR re-asserts this on every client reconnect."""
        self._rx_vfo[channel] = 1 if which else 0

    def rx_vfo(self, channel: int) -> int:
        return int(self._rx_vfo[channel])

    def rit(self, channel: int, offset_hz: float):
        self._rit[channel] = offset_hz

    def xit(self, channel: int, offset_hz: float):
        self._xit[channel] = offset_hz

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    def set_band(self, channel: int, name: str):
        """Recall the band memory (or the band-plan default) for ``name``;
        stores the current frequency into its own band first (bands.c
        band-stack behavior)."""
        self.band_memory.store(self._vfo_a[channel], self.mode(channel))
        freq, mode = self.band_memory.recall(name)
        self.tune(channel, freq)
        self.set_mode(channel, mode)

    # -- PTT (reference: trx_manager RX<->TX switching) -----------------------

    def ptt(self, keyed: bool):
        self._ptt = bool(keyed)

    @property
    def transmitting(self) -> bool:
        return self._ptt

    def rx_frequency(self, channel: int) -> float:
        vfo = self._vfo_b if self._rx_vfo[channel] else self._vfo_a
        return float(vfo[channel] + self._rit[channel])

    def tx_frequency(self, channel: int) -> float:
        vfo = self._vfo_b if self._split[channel] else self._vfo_a
        return float(vfo[channel] + self._xit[channel])

    # -- data plane ------------------------------------------------------------

    def process(self, rx_iq, mic_audio):
        """One block. Returns (rx_audio, tx_iq); tx_iq is zeros when PTT is
        up, rx_audio is muted while transmitting (reference semantics)."""
        C = self.rx_cfg.channels
        rx_f = np.array([self.rx_frequency(c) for c in range(C)])
        tx_f = np.array([self.tx_frequency(c) for c in range(C)])
        rx_words = jnp.asarray(nco.freq_word(rx_f, self.rx_cfg.fs_in))
        tx_words = jnp.asarray(nco.freq_word(tx_f, self.tx_cfg.fs_out))
        modes = jnp.asarray(self._modes)
        # the TX modulator bank has no SAM entry (SAM is a receive technique;
        # its transmit form IS plain AM) — map it so the gather never clamps
        # out of range into the wrong modulator
        from radioframe.ops import demod as demod_op

        tx_modes = jnp.asarray(np.where(self._modes == demod_op.SAM,
                                        demod_op.AM, self._modes).astype(np.int32))
        iq = np.asarray(rx_iq)
        if iq.ndim == 1:
            iq = iq[None, :]
        rx_r = jnp.asarray(np.ascontiguousarray(iq.real, np.float32))
        rx_i = jnp.asarray(np.ascontiguousarray(iq.imag, np.float32))
        mic = jnp.asarray(mic_audio, jnp.float32)
        if mic.ndim == 1:
            mic = jnp.broadcast_to(mic[None, :], (C, mic.shape[0]))
        self.state, rx_audio, tx_r, tx_i, aux = self._step(
            self.state, rx_r, rx_i, mic, rx_words, modes, tx_words, tx_modes)
        self.last_aux = aux
        rx_audio = np.asarray(rx_audio)
        tx_iq = (np.asarray(tx_r) + 1j * np.asarray(tx_i)).astype(np.complex64)
        if self._ptt:
            rx_audio = np.zeros_like(rx_audio)
        else:
            tx_iq = np.zeros_like(tx_iq)
        return rx_audio, tx_iq

    # -- observability ----------------------------------------------------------

    def s_meter(self, channel: int) -> str:
        if self.last_aux is None:
            return "S0"
        pw = float(np.asarray(self.last_aux["power_in"])[channel])
        return s_meter(pw)
