"""Benchmark harness — prints ONE JSON line.

Metric: aggregate DDC+demod throughput in input IQ samples/s per device
through the full RX block program (NCO -> CIC -> comp FIR -> OLS mode bank
-> demod bank -> AGC), the BASELINE.json north-star metric. The detail rows
time the other dataflows the same way.

Runs on the GPU and exits non-zero where JAX finds none: a CPU number is not
a device number. Input blocks are staged on the device and state is donated;
each timed run is one jitted ``fori_loop`` over blocks, ended with
``jax.block_until_ready`` — the benchmark measures the compute path, not
host I/O (SURVEY.md §7 hard-part #4).

    python bench.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from radioframe.core import presets
from radioframe.core.compile_cache import use_compile_cache
from radioframe.ops import nco


def timed_median(once, n_runs: int = 3):
    """Median-of-N wall time with the full spread recorded; ``once`` runs
    one timed repetition and returns its seconds."""
    dts = sorted(once() for _ in range(n_runs))
    med = dts[n_runs // 2]
    return med, {"median_s": med, "runs_s": dts}


def loop_timer(step, state, args, iters: int):
    """Compile and warm ``iters`` chained calls ``state, outs = step(state,
    *args)`` in one jitted fori_loop (every output folded into a scalar, so
    none is dead code); returns ``once()``, the seconds of one timed run."""

    def run(state, args, n):
        def body(_, carry):
            st, acc = carry
            st, outs = step(st, *args)
            return st, acc + sum(jnp.sum(jnp.abs(o[..., -1])) for o in outs)

        return jax.lax.fori_loop(0, n, body, (state, jnp.float32(0.0)))

    runj = jax.jit(run, static_argnames="n", donate_argnums=0)
    hold = [jax.block_until_ready(runj(state, args, n=iters))[0]]

    def once():
        t0 = time.perf_counter()
        st, _ = jax.block_until_ready(runj(hold[0], args, n=iters))
        hold[0] = st
        return time.perf_counter() - t0

    return once


def _loop_rate(step, state, args, iters: int, samples_per_iter: int, n_runs: int = 3):
    """Samples/s of ``loop_timer``'s loop, median of ``n_runs``."""
    dt, spread = timed_median(loop_timer(step, state, args, iters), n_runs)
    return samples_per_iter * iters / dt, {"iters": iters, **spread}


def _rx_row(cfg, T, seed, iters, n_runs=3):
    from radioframe.pipelines.rx_chain import RxChain

    chain = RxChain(cfg)
    C = cfg.channels
    rng = np.random.default_rng(seed)
    iq = jax.jit(jax.lax.complex)(
        jnp.asarray(rng.standard_normal((C, T)), jnp.float32),
        jnp.asarray(rng.standard_normal((C, T)), jnp.float32))
    words = jnp.asarray(nco.freq_word(np.linspace(-0.4, 0.4, C) * cfg.fs_in / 2, cfg.fs_in))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)

    def step(st, iq, words, mode):
        st, audio, _ = chain.step(st, iq, words, mode)
        return st, (audio,)

    state = jax.jit(lambda: chain.init_state(C))()
    rate, info = _loop_rate(step, state, (iq, words, mode), iters, C * T, n_runs)
    return rate, {"channels": C, "block_T": T, "decim": cfg.decim,
                  "front_end": "triton" if chain.frontend is not None else "xla",
                  **info}


def bench_flagship():
    """BASELINE configs 1+2 at 128 channels: 1.536 Msps -> 48 kHz."""
    cfg = presets.wideband_1536k(128, ols_hop=512, enabled_modes=(0, 1, 2, 3))
    from radioframe.pipelines.rx_chain import RxChain

    return _rx_row(cfg, 8 * RxChain(cfg).min_block, 0, 256, n_runs=5)


def bench_adc_rate():
    """ADC-rate dataflow: 61.44 Msps -> 48 kHz (R=1280) per channel."""
    cfg = presets.adc_61m44(channels=128, enabled_modes=(0, 1, 2, 3))
    from radioframe.pipelines.rx_chain import RxChain

    return _rx_row(cfg, RxChain(cfg).min_block, 1, 64)


def bench_channelizer():
    """Config-5 dataflow: 61.44 Msps wideband -> 4096-channel PFB ->
    per-channel demod/AGC + waterfall. Returns wideband samples/s."""
    from radioframe.pipelines.channelizer import ChannelizerChain

    cfg = presets.channelizer_61m44(4096, enabled_modes=(0, 1, 2, 3))
    chain = ChannelizerChain(cfg)
    M = cfg.num_channels
    T = 128 * chain.min_block
    rng = np.random.default_rng(2)
    wide = jax.jit(jax.lax.complex)(jnp.asarray(rng.standard_normal(T), jnp.float32),
                                    jnp.asarray(rng.standard_normal(T), jnp.float32))
    mode = jnp.asarray(np.arange(M) % 4, jnp.int32)

    def step(st, wide, mode):
        st, audio, aux = chain.step(st, wide, mode)
        return st, (audio, aux["waterfall"])

    state = jax.jit(chain.init_state)()
    rate, info = _loop_rate(step, state, (wide, mode), 64, T)
    return rate, {"channels": M, "block_T": T, **info}


def bench_tx():
    """DAC-rate DUC dataflow: 48 kHz audio -> 61.44 Msps IQ (L=1280) per
    channel. Returns OUTPUT IQ samples/s (the DAC-rate side)."""
    from radioframe.pipelines.tx_chain import TxChain

    cfg = presets.tx_adc_61m44(channels=64)
    chain = TxChain(cfg)
    C, Ta = cfg.channels, chain.min_block
    rng = np.random.default_rng(3)
    audio = jnp.asarray(rng.standard_normal((C, Ta)), jnp.float32)
    words = jnp.asarray(nco.freq_word(np.linspace(-20e6, 20e6, C), cfg.fs_out))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)

    def step(st, audio, words, mode):
        st, iq = chain.step(st, audio, words, mode)
        return st, (iq,)

    state = jax.jit(lambda: chain.init_state(C))()
    rate, info = _loop_rate(step, state, (audio, words, mode), 32, C * Ta * cfg.interp)
    return rate, {"channels": C, "audio_T": Ta, "interp": cfg.interp, **info}


def bench_duplex():
    """Config-4 dataflow: RX DDC + TX DUC in ONE jitted program (1.536 Msps
    <-> 48 kHz). Returns RX input IQ samples/s."""
    from radioframe.core.config import CicStage, TxConfig
    from radioframe.pipelines.duplex import DuplexChain

    C = 128
    rx_cfg = presets.wideband_1536k(C, ols_hop=512, enabled_modes=(0, 1, 2, 3))
    tx_cfg = TxConfig(fs_out=1_536_000.0, channels=C,
                      interp_stages=(4, CicStage(R=8, N=4)))
    duplex = DuplexChain(rx_cfg, tx_cfg)
    T = 8 * duplex.rx.min_block
    Ta = T // rx_cfg.decim
    rng = np.random.default_rng(4)
    iq = jax.jit(jax.lax.complex)(
        jnp.asarray(rng.standard_normal((C, T)), jnp.float32),
        jnp.asarray(rng.standard_normal((C, T)), jnp.float32))
    audio = jnp.asarray(rng.standard_normal((C, Ta)), jnp.float32)
    words = jnp.asarray(nco.freq_word(np.linspace(-5e5, 5e5, C), rx_cfg.fs_in))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)

    def step(st, iq, audio, words, mode):
        st, rx_audio, tx_iq, _ = duplex.step(st, iq, audio, words, mode, words, mode)
        return st, (rx_audio, tx_iq)

    state = jax.jit(lambda: duplex.init_state(C))()
    rate, info = _loop_rate(step, state, (iq, audio, words, mode), 64, C * T)
    return rate, {"channels": C, "block_T": T, "rx_decim": rx_cfg.decim,
                  "tx_interp": tx_cfg.interp, **info}


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    use_compile_cache()
    rate, detail = bench_flagship()
    detail = {"flagship": detail}
    for name, fn in (("adc_rate_r1280", bench_adc_rate),
                     ("channelizer_4096", bench_channelizer),
                     ("tx_adc_r1280", bench_tx),
                     ("duplex", bench_duplex)):
        r, info = fn()
        detail[name] = {"samples_per_s": r, **info}
    print(json.dumps({
        "metric": "ddc_chain_input_samples_per_s_per_device",
        "value": rate,
        "unit": "IQ samples/s/device",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
