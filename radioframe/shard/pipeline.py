"""Stage-pipelined RX executor — the PP analog (SURVEY.md §2.3 row 5).

The reference runs its signal path as two asynchronous engines: the FPGA
DDC pipeline at ADC rate feeds, through a double-buffered ring, the MCU's
audio-rate block loop (SURVEY.md §3.2, `[U:fpga.c]`/`[U:audio_processor.c]`).
The analog here is NOT a lockstep SPMD stage axis: the two stages are
*heterogeneous* computations, and under SPMD every device would execute both
halves densely (a `lax.cond` on `axis_index` lowers to select-of-both), so a
stage mesh axis buys no throughput. Instead the JAX runtime's asynchronous
dispatch is the pipeline scheduler:

  - the full-rate front half (``RxChain.step_front``: NCO + decimators) is
    jitted with its inputs committed to device A;
  - the audio-rate back half (``step_back``: OLS bank .. AGC/spectrum) to
    device B;
  - the decimated block crosses devices with an async ``device_put`` (ICI
    between cards — the payload is ``decim``× smaller than the input, the
    same rate reduction that makes the reference's FPGA→MCU bus feasible).

Enqueueing block k+1's front program returns immediately, so it executes
concurrently with block k's back program: a depth-2 pipeline with one block
of latency — exactly the FPGA∥MCU structure. Throughput gain is bounded by
t_back/t_front (Amdahl on the slower stage); measure both stage times
before relying on it (SURVEY.md §2.3's "measure first" note). Channel/time sharding (shard/rx.py)
remains the primary scaling axis; this executor composes with it by handing
each stage a mesh instead of a single device (front/back callables are any
jitted (state, ...) -> (state, ...) programs).
"""

from __future__ import annotations

import jax


class PipelinedRx:
    """Two-stage pipelined RX over two devices.

    ``run(fstate, bstate, blocks, words, mode)`` streams a list of input
    blocks through the pipeline and returns the per-block audio in order —
    numerically identical to sequential ``RxChain.step`` (tests/test_pipeline
    .py), modulo cross-program fp fusion differences.
    """

    def __init__(self, chain, device_front=None, device_back=None):
        devs = jax.devices()
        self.chain = chain
        self.dev_front = device_front if device_front is not None else devs[0]
        self.dev_back = device_back if device_back is not None else devs[min(1, len(devs) - 1)]
        # No buffer donation here: the cross-device device_put of (x, pw) is
        # asynchronous, and letting the next front/back dispatch reuse input
        # buffers while a transfer may still be reading them produced rare
        # garbage blocks on the CPU backend (observed: ~1% of samples
        # clobbered, nondeterministic). State is audio-rate-small; copying
        # it is noise next to the block compute.
        self._front = jax.jit(chain.step_front)
        self._back = jax.jit(chain.step_back)

    def init_states(self, num_channels: int):
        """(front_state on dev A, back_state on dev B)."""
        f, b = self.chain.split_state(self.chain.init_state(num_channels))
        return (jax.device_put(f, self.dev_front), jax.device_put(b, self.dev_back))

    def run(self, fstate, bstate, blocks, words, mode):
        """Stream ``blocks`` (iterable of (C, T) c64) through the pipeline.

        Returns (fstate, bstate, audio_blocks, aux_blocks). Front(k+1) is
        enqueued before back(k) completes; the devices overlap because the
        programs sit on different streams and only the decimated transfer
        links them.
        """
        words_f = jax.device_put(words, self.dev_front)
        mode_b = jax.device_put(mode, self.dev_back)
        audios, auxes = [], []
        pending = None  # (x, power_in) already in flight to dev_back
        for iq in blocks:
            iq = jax.device_put(iq, self.dev_front)
            fstate, x, pw = self._front(fstate, iq, words_f)
            nxt = jax.device_put((x, pw), self.dev_back)  # async D2D copy
            if pending is not None:
                bstate, audio, aux = self._back(bstate, pending[0], mode_b, pending[1])
                audios.append(audio)
                auxes.append(aux)
            pending = nxt
        if pending is not None:  # drain the pipeline
            bstate, audio, aux = self._back(bstate, pending[0], mode_b, pending[1])
            audios.append(audio)
            auxes.append(aux)
        return fstate, bstate, audios, auxes
