"""Monitor — the high-level API for the wideband channelizer (config 5).

What `Radio` is to the per-channel RX chain, `Monitor` is to the
PFB channelizer: one wideband stream in, EVERY channel demodulated out,
with runtime per-channel mode control and the panorama waterfall. The
reference has no analog — one MCU demodulates one channel at a time
(`[U:audio_processor.c]`); this is the capability the batched formulation
unlocks (SURVEY.md §7 P6, BASELINE config 5).

>>> from radioframe.core import presets
>>> m = Monitor(presets.channelizer_61m44(4096))
>>> m.set_mode(37, "am"); m.set_mode_all("ssb")
>>> audio = m.process(wideband_block)     # (M, T/M) numpy float32
>>> lines = m.waterfall()                 # dB lines from the last block
"""

from __future__ import annotations

import jax
import numpy as np

from radioframe.api.radio import MODE_BY_NAME, NAME_BY_MODE
from radioframe.pipelines.channelizer import ChannelizerChain, ChannelizerConfig


class Monitor:
    """Every-channel receiver over one wideband stream.

    ``mesh``: a 1-D jax mesh shards the channelizer across devices
    (radioframe/shard/channelizer.py): time-sharded PFB -> all_to_all ->
    channel-sharded demod and AGC."""

    def __init__(self, config: ChannelizerConfig, mesh=None):
        self.config = config
        self.chain = ChannelizerChain(config)
        self._mesh = mesh
        M = config.num_channels
        self._modes = np.zeros(M, dtype=np.int32)
        if mesh is not None:
            from radioframe.shard.channelizer import ShardedChannelizer
            from radioframe.shard.mesh import place_state

            self._impl = ShardedChannelizer(self.chain, mesh)
            self.state = place_state(jax.jit(self.chain.init_state)(),
                                     self._impl.state_specs(), mesh)
        else:
            self._impl = self.chain
            self.state = jax.jit(self.chain.init_state)()
        # f32 I/Q planes cross the host boundary; the complex view is
        # formed on the device inside the jitted step
        def _step_planes(state, wr, wi, mode):
            return self._impl.step(state, jax.lax.complex(wr, wi), mode)

        self._step = jax.jit(_step_planes)
        self.last_aux = None
        self._modes_dev = None  # cached device array; invalidated by set_mode

    # -- control plane (runtime arrays, never a recompile) -------------------

    @property
    def num_channels(self) -> int:
        return self.config.num_channels

    def channel_frequency(self, channel: int) -> float:
        """Center of ``channel`` relative to the wideband center (channel c
        sits at +c*fs/M; channels above M/2 alias to negative offsets)."""
        M = self.config.num_channels
        c = channel if channel < M // 2 else channel - M
        return c * self.config.fs_channel

    def set_mode(self, channel: int, mode: str):
        self._modes[channel] = MODE_BY_NAME[mode.lower()]
        self._modes_dev = None

    def set_mode_all(self, mode: str):
        self._modes[:] = MODE_BY_NAME[mode.lower()]
        self._modes_dev = None

    def mode(self, channel: int) -> str:
        return NAME_BY_MODE[int(self._modes[channel])]

    # -- data plane -----------------------------------------------------------

    def process(self, wideband) -> np.ndarray:
        """One block step: wideband (T,) complex, T a multiple of
        ``chain.min_block`` -> (M, T/M) float32 audio."""
        import jax.numpy as jnp

        if self._modes_dev is None:
            self._modes_dev = jnp.asarray(self._modes)
        wideband = np.asarray(wideband)
        wr = jnp.asarray(np.ascontiguousarray(wideband.real, np.float32))
        wi = jnp.asarray(np.ascontiguousarray(wideband.imag, np.float32))
        self.state, audio, aux = self._step(self.state, wr, wi,
                                            self._modes_dev)
        self.last_aux = aux
        return np.asarray(audio)

    def waterfall(self):
        """dB waterfall lines from the last processed block (or None)."""
        if self.last_aux is None or "waterfall" not in self.last_aux:
            return None
        return np.asarray(self.last_aux["waterfall"])

    def channel_power(self):
        """Per-channel mean power from the last processed block (or None)."""
        if self.last_aux is None:
            return None
        return np.asarray(self.last_aux["channel_power"])

    # -- checkpoint/resume (VERDICT r4 ask #7: config 5's stream state —
    # PFB history, demod carries, AGC envelopes — resumable through its
    # API, mirroring Radio.save/load) ---------------------------------------

    def save(self, directory: str, epoch: int = 0):
        """Checkpoint the channelizer stream state + per-channel modes."""
        import jax.numpy as jnp

        from radioframe.core.checkpoint import StreamCheckpointer

        ck = StreamCheckpointer(directory)
        return ck.save(epoch, {"state": self.state,
                               "modes": jnp.asarray(self._modes)})

    def load(self, directory: str, epoch: int | None = None):
        """Restore stream state + modes; resume is bit-exact
        (tests/test_api_aux.py::TestMonitorCheckpoint)."""
        import jax.numpy as jnp

        from radioframe.core.checkpoint import StreamCheckpointer

        ck = StreamCheckpointer(directory)
        if epoch is None:
            epoch = ck.latest_epoch()
        like = {"state": self.state, "modes": jnp.asarray(self._modes)}
        restored = ck.restore(epoch, like)
        self.state = restored["state"]
        if self._mesh is not None:
            # re-place restored leaves on their program shardings so the
            # first donated step can alias them (donation hygiene)
            from radioframe.shard.mesh import place_state

            self.state = place_state(self.state, self._impl.state_specs(),
                                     self._mesh)
        self._modes = np.asarray(restored["modes"]).astype(np.int32)
        self._modes_dev = None
        return epoch
