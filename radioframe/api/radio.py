"""Radio — the user-facing control plane.

Replaces the reference's CAT protocol + trx_manager state machine
(SURVEY.md §2.2 #16/#21, §3.4/§3.5): instead of Kenwood-style text commands
over USB CDC mutating a global TRX struct, a plain Python object owns the
jitted chain, its device state, and the runtime tuning arrays. Retunes and
mode switches update device arrays — never recompile (§3.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radioframe.core.config import RxConfig
from radioframe.ops import demod as demod_op
from radioframe.ops import nco
from radioframe.ops.spectrum import snap_to_peak
from radioframe.pipelines.rx_chain import RxChain

MODE_BY_NAME = dict(demod_op.MODE_NAMES)
# canonical name per code ("usb" is an alias of "ssb")
NAME_BY_MODE = {demod_op.SSB: "ssb", demod_op.CW: "cw", demod_op.AM: "am",
                demod_op.NFM: "nfm", demod_op.LSB: "lsb", demod_op.SAM: "sam"}


class Radio:
    """Multi-channel receiver with runtime tune/mode control.

    >>> r = Radio(RxConfig(channels=4))
    >>> r.tune(0, 37_000.0); r.set_mode(0, "ssb")
    >>> audio = r.process(iq_block)          # (C, T/decim) numpy float32
    """

    def __init__(self, config: RxConfig, mesh=None):
        self.config = config
        self.chain = RxChain(config)
        C = config.channels
        self._freqs = np.zeros(C, dtype=np.float64)
        self._modes = np.zeros(C, dtype=np.int32)
        if mesh is not None:
            from radioframe.shard.rx import ShardedRxChain

            self._impl = ShardedRxChain(self.chain, mesh)
        else:
            self._impl = self.chain
        def _step_planes(state, ir, ii, words, modes):
            return self._impl.step(state, jax.lax.complex(ir, ii), words,
                                   modes)

        self._step = jax.jit(_step_planes)
        self.state = jax.jit(lambda: self.chain.init_state(C))()
        self.last_aux = None
        self._words_dev = None  # cached device array; invalidated by tune()

    # -- control plane (SURVEY §3.4: runtime arrays, no recompile) ----------

    def tune(self, channel: int, freq_hz: float):
        self._freqs[channel] = freq_hz
        self._words_dev = None

    def frequency(self, channel: int) -> float:
        return float(self._freqs[channel])

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    # -- data plane ----------------------------------------------------------

    def process(self, iq_block) -> np.ndarray:
        """Feed one IQ block ((T,) shared wideband or (C, T)); returns audio."""
        # f32 I/Q planes host-side, complex formed on the device
        iq = np.asarray(iq_block)
        if iq.ndim == 1:
            iq = iq[None, :]
        ir = jnp.asarray(np.ascontiguousarray(iq.real, np.float32))
        ii = jnp.asarray(np.ascontiguousarray(iq.imag, np.float32))
        if self._words_dev is None:
            self._words_dev = jnp.asarray(nco.freq_word(self._freqs, self.config.fs_in))
        words = self._words_dev
        modes = jnp.asarray(self._modes)
        self.state, audio, aux = self._step(self.state, ir, ii, words, modes)
        self.last_aux = aux
        return np.asarray(audio)

    # -- observability -------------------------------------------------------

    def capabilities(self) -> dict:
        """Feature/interop status map (surfaced in the CLI `info` command).

        Flags the digital modes whose code tables are PROVISIONAL stand-ins
        (zero-egress build; see ops/ft8.py / ops/wspr.py headers): they
        round-trip against this framework's own encoders but do not claim
        on-air interop until the published tables land.
        """
        from radioframe.ops import ft8, wspr

        caps = {"modes": sorted(set(MODE_BY_NAME)), "ft8": True, "wspr": True}
        if ft8.INTEROP_PROVISIONAL:
            caps["ft8_interop"] = "PROVISIONAL: " + ", ".join(ft8.PROVISIONAL_ITEMS)
        if wspr.INTEROP_PROVISIONAL:
            caps["wspr_interop"] = "PROVISIONAL: " + ", ".join(wspr.PROVISIONAL_ITEMS)
        return caps

    def metrics(self) -> dict:
        """Per-channel metrics from the last processed block."""
        if self.last_aux is None:
            return {}
        out = {k: np.asarray(v) for k, v in self.last_aux.items() if k != "spectrum"}
        return out

    def waterfall(self):
        if self.last_aux is None or "spectrum" not in self.last_aux:
            return None
        return np.asarray(self.last_aux["spectrum"])

    def snap(self, channel: int, search_hz: float = 1000.0):
        """Auto frequency snap: retune to the strongest peak near the current
        frequency (reference `[U:snap.c]`)."""
        wf = self.waterfall()
        assert wf is not None, "enable emit_spectrum in RxConfig to use snap"
        line = jnp.asarray(wf[:, -1, :])
        # spectrum is taken post-mix at audio rate, so a peak's bin offset is
        # directly the tuning error relative to the current frequency
        off = snap_to_peak(line, self.config.fs_audio, search_hz, self.config.spectrum_nfft)
        self._freqs[channel] += float(np.asarray(off)[channel])
        self._words_dev = None
        return self._freqs[channel]

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str, epoch: int = 0):
        from radioframe.core.checkpoint import StreamCheckpointer

        ck = StreamCheckpointer(directory)
        return ck.save(epoch, {"state": self.state,
                               "freqs": jnp.asarray(self._freqs),
                               "modes": jnp.asarray(self._modes)})

    def load(self, directory: str, epoch: int | None = None):
        from radioframe.core.checkpoint import StreamCheckpointer

        ck = StreamCheckpointer(directory)
        if epoch is None:
            epoch = ck.latest_epoch()
        like = {"state": self.state, "freqs": jnp.asarray(self._freqs),
                "modes": jnp.asarray(self._modes)}
        restored = ck.restore(epoch, like)
        self.state = restored["state"]
        self._freqs = np.asarray(restored["freqs"]).astype(np.float64)
        self._modes = np.asarray(restored["modes"]).astype(np.int32)
        self._words_dev = None
        return epoch
