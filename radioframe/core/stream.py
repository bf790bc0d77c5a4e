"""Block streaming — the replacement for ISR-driven double buffering.

Reference analog (SURVEY.md §2.1 #5, §3.2): `[U:fpga.c]` EXTI ISR filling
ring-buffer halves that trigger the audio block loop. Here the "ISR" is an
async host->device prefetch one block ahead of the jitted step — the same
double-buffer discipline, expressed as dataflow:

    feed(block b+1) -> device   ||   step(state, block b) on device

Sources are plain iterables of numpy/jax blocks (fixtures, WAV readers, or
on-device synthetic generators for benchmarking, SURVEY.md §7 hard-part #4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class BlockStream:
    """Runs a (state, block, *args) -> (state, out, aux) step over a source.

    Prefetches the next block to the device while the current one computes;
    with donated state the loop is a steady-state two-deep pipeline.
    """

    def __init__(self, step, state, device=None, donate: bool = True):
        self._step = jax.jit(step, donate_argnums=0) if donate else jax.jit(step)
        self.state = state
        self._device = device or jax.devices()[0]
        self._to_complex = jax.jit(jax.lax.complex)

    def _put(self, block):
        def put_one(b):
            if not isinstance(b, jax.Array) and np.iscomplexobj(b):
                # plane-transfer convention (same as the APIs): ship f32
                # I/Q planes and form the complex view on the device
                b = np.asarray(b)
                wr = jax.device_put(np.ascontiguousarray(b.real, np.float32),
                                    self._device)
                wi = jax.device_put(np.ascontiguousarray(b.imag, np.float32),
                                    self._device)
                return self._to_complex(wr, wi)
            return jax.device_put(jnp.asarray(b), self._device)

        return jax.tree.map(put_one, block)

    def run(self, source, *args, collect: bool = True):
        """Iterate ``source`` blocks through the step; returns (outs, auxs)."""
        outs, auxs = [], []
        it = iter(source)
        try:
            nxt = self._put(next(it))
        except StopIteration:
            return outs, auxs
        while nxt is not None:
            cur = nxt
            try:
                nxt = self._put(next(it))  # prefetch overlaps device compute
            except StopIteration:
                nxt = None
            self.state, out, aux = self._step(self.state, cur, *args)
            if collect:
                outs.append(out)
                auxs.append(aux)
        return outs, auxs


class CaptureSource:
    """Capture thread -> lock-free ring -> block iterator.

    The full `[U:fpga.c]` ISR-boundary replacement (SURVEY.md §2.1 #5): a
    producer thread plays the bus-read ISR — it pulls interleaved int16 IQ
    chunks from ``producer``, converts them to complex64 in native code
    (radioframe.native.iq_i16_to_c64), and pushes them into the lock-free
    SPSC ring (native/iqtransport.c). The consumer side (this iterator,
    normally driven by BlockStream.run) pops fixed-length blocks, exactly
    like the reference's audio loop firing on ring-half-full. A full ring
    blocks the producer briefly, then drops the chunk and increments
    ``overruns`` — the reference's ISR overrun counter.

    >>> src = CaptureSource(pcm_chunks, block_len=4096)
    >>> outs, auxs = BlockStream(chain.step, state).run(src, words, mode)
    """

    def __init__(self, producer, block_len: int, channels: int = 1,
                 capacity_blocks: int = 8, scale: float = 1.0 / 32767.0,
                 overrun_wait_s: float = 0.005, overrun_retries: int = 20,
                 raw_i16: bool = False):
        from radioframe.native import RingBuffer

        self.block_len = int(block_len)
        self.channels = int(channels)
        self._scale = scale
        # raw_i16: int16-ingest fast path (RxConfig.int16_ingest) — the ring
        # carries deinterleaved int16 planes (half the bytes of complex64)
        # and the iterator yields (xr, xi) int16 plane blocks for step_i16;
        # the host never touches f32 (the device upcasts).
        self.raw_i16 = bool(raw_i16)
        if self.raw_i16 and abs(scale - 1.0 / 32767.0) > 1e-12:
            # the i16 route never applies ``scale``: the chain scales int16
            # counts by 2**-15 (RxConfig.int16_ingest). A custom scale
            # (e.g. a 12-bit ADC) silently getting the wrong gain is worse
            # than refusing.
            raise ValueError("raw_i16=True ignores CaptureSource scale; "
                             "set the chain's int16 input_scale instead")
        sample_bytes = 4 if raw_i16 else 8
        self._block_bytes = self.channels * self.block_len * sample_bytes
        self.ring = RingBuffer(capacity_blocks * self._block_bytes)
        self._producer = producer
        self.overruns = 0
        self._wait = overrun_wait_s
        self._retries = overrun_retries
        self._done = False
        self._thread = None

    # -- producer side (the "ISR") -------------------------------------------

    def _capture_loop(self):
        import time

        import numpy as np

        from radioframe.native import iq_i16_to_c64

        for pcm in self._producer:
            if self.raw_i16:
                # ring carries the raw interleaved int16 words — zero
                # producer-side work (pure bus-to-ring, the ISR's job);
                # the consumer deinterleaves per popped block
                payload = np.ascontiguousarray(pcm, dtype=np.int16)
            else:
                payload = iq_i16_to_c64(pcm, self._scale)
            for attempt in range(self._retries):
                if self.ring.write(payload):
                    break
                time.sleep(self._wait)  # consumer catching up
            else:
                self.overruns += 1  # ring stayed full: drop (ISR semantics)
        self._done = True

    def start(self):
        import threading

        self._thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._thread.start()
        return self

    # -- consumer side (the block loop) ---------------------------------------

    def __iter__(self):
        import time

        if self._thread is None:
            self.start()
        import numpy as np

        from radioframe.native import iq_i16_deinterleave

        while True:
            if self.raw_i16:
                blk = self.ring.read(self._block_bytes, dtype=np.int16)
                if blk is not None:
                    xr, xi = iq_i16_deinterleave(blk)
                    yield (xr.reshape(self.channels, self.block_len),
                           xi.reshape(self.channels, self.block_len))
                    continue
            else:
                blk = self.ring.read(self._block_bytes)
                if blk is not None:
                    yield blk.reshape(self.channels, self.block_len)
                    continue
            if self._done and self.ring.fill < self._block_bytes:
                return  # drained (partial tail < one block is discarded)
            time.sleep(0.0005)  # underrun: wait for the capture thread


def wav_blocks(path: str, block_len: int):
    """Yield complex64 IQ blocks from a stereo WAV capture (zero-pad tail)."""
    from radioframe.io.wav import read_wav

    iq, _fs = read_wav(path)
    for i in range(0, len(iq), block_len):
        b = iq[i : i + block_len]
        if len(b) < block_len:
            b = np.pad(b, (0, block_len - len(b)))
        yield b[None, :]


def synthetic_blocks(generator, block_len: int, num_blocks: int, channels: int = 1, seed: int = 0):
    """Deterministic synthetic block source (benchmark ingest without host I/O)."""
    rng = np.random.default_rng(seed)
    for _ in range(num_blocks):
        yield generator(rng, channels, block_len)
