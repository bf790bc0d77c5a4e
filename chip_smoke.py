"""Bring-up smoke run on NVIDIA GPUs: the main paths through the entry
points a user calls, at full width, each compared with its reference.

    python chip_smoke.py           # one card: RX, ADC-rate RX, channelizer,
                                   # TX/duplex, stream resume, then rates
    python chip_smoke.py --multi   # four cards: configs 3 and 5 sharded,
                                   # each against the one-card result

Every comparison prints one line with its tolerance and precision; a
failing phase raises and the script exits non-zero. It also exits non-zero,
printing no result, when JAX finds no GPU. The last line of standard output
is one JSON object, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

import numpy as np

PHASES_ONE = ("flagship_rx", "adc_rx", "channelizer", "duplex", "resume")
PHASES_MULTI = ("config3_sharded_rx", "config5_sharded_channelizer")
F32 = "float32 (matmuls and convs at HIGHEST)"


def select_phases(multi: bool):
    return PHASES_MULTI if multi else PHASES_ONE


def compare(name, got, want, *, atol, rtol=0.0, precision=F32):
    """Print got-vs-want with its tolerance; raise if they disagree."""
    got, want = np.asarray(got), np.asarray(want)
    same = got.shape == want.shape and got.size > 0
    err = float(np.max(np.abs(got - want))) if same else float("inf")
    ok = same and bool(np.all(np.isfinite(got))) and bool(
        np.allclose(got, want, atol=atol, rtol=rtol))
    print(f"[{name}] max_abs_err={err:.3e} atol={atol:g} rtol={rtol:g} "
          f"shape={got.shape} precision={precision} -> {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} (shapes {got.shape} "
                             f"vs {want.shape}) outside atol={atol} rtol={rtol}")
    return err


def check(name, value, lo=None, hi=None, *, unit="", precision=F32):
    """Print a scalar against its bound(s); raise if outside."""
    ok = np.isfinite(value) and (lo is None or value >= lo) and (hi is None or value <= hi)
    bound = " ".join(b for b in (f">= {lo:g}" if lo is not None else "",
                                 f"<= {hi:g}" if hi is not None else "") if b)
    print(f"[{name}] value={value:.4f}{unit} bound: {bound}{unit} precision={precision}"
          f" -> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {value} outside {bound}")
    return value


def last_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform,
                                              "kind": d.device_kind,
                                              "count": len(devices)}})


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def report_rate(phase, rate, card, what="input samples/s"):
    print(f"[rate {phase}] {rate:.6e} {what} (steady state, jax.block_until_ready; "
          f"card: {card.splitlines()[0]})", flush=True)


def _xla_front(chain):
    """The same chain with its front end held to the plain XLA form (the
    reference the Triton kernel is compared and timed against)."""
    chain.frontend, chain.frontend_stages = None, 0
    return chain


def _abba(samples, once_a, once_b):
    """Rates (samples/s) of two compiled loops timed in the order a, b, b, a;
    returns each one's mean and the four rates in order."""
    r = [samples / f() for f in (once_a, once_b, once_b, once_a)]
    return (r[0] + r[3]) / 2, (r[1] + r[2]) / 2, r


# ---------------------------------------------------------------- one card

def phase_flagship_rx(card, C=128, n_blocks=4):
    """BASELINE configs 1+2 at 128 channels through Radio: 4-signal capture,
    state carried over blocks, audio SNR within 1 dB of the golden chain."""
    import jax
    import jax.numpy as jnp

    from bench import loop_timer
    from radioframe.api.radio import Radio
    from radioframe.core import presets
    from radioframe.diag.metrics import audio_snr_db
    from radioframe.golden.rx import golden_rx
    from radioframe.io import fixtures as FX
    from radioframe.ops import nco
    from radioframe.pipelines.rx_chain import RxChain

    cfg = presets.wideband_1536k(C)
    radio = Radio(cfg)
    FS = cfg.fs_in
    T = 8 * radio.chain.min_block
    n = n_blocks * T
    sigs = (("ssb", 370e3, FX.ssb_capture), ("cw", 700e3, FX.cw_capture),
            ("am", 200e3, FX.am_capture), ("nfm", -150e3, FX.nfm_capture))
    wide, truth = np.zeros(n, np.complex128), {}
    for mode, off, gen in sigs:
        iq, truth[mode] = gen(FS, n, off)
        wide += iq
    wide = wide.astype(np.complex64)
    for c in range(C):
        radio.tune(c, sigs[c % 4][1])
        radio.set_mode(c, sigs[c % 4][0])
    print(f"flagship: {C} channels x {T} samples/block ({C * T * 8 / 1e6:.0f} MB "
          f"complex64), front end: {'triton' if radio.chain.frontend else 'xla'}",
          flush=True)
    audio = np.concatenate([radio.process(np.broadcast_to(b, (C, T)))
                            for b in np.split(wide, n_blocks)], axis=-1)
    settle = audio.shape[-1] // 4  # AM DC-block and AGC turn-on
    for c, (mode, off, _) in enumerate(sigs):
        gold = golden_rx(radio.chain, wide, off, mode)
        if mode == "cw":  # truth is the keying envelope: score vs golden
            check(f"flagship cw vs golden audio SNR", audio_snr_db(gold, audio[c]),
                  lo=30.0, unit=" dB")
            continue
        ref, out, g = truth[mode], audio[c], gold
        if mode in ("am", "nfm"):
            ref, out, g = ref[settle:], out[settle:], g[settle:]
        s_dev = audio_snr_db(ref, out, trim=1024)
        s_gold = audio_snr_db(ref, g, trim=1024)
        print(f"flagship {mode}: device SNR {s_dev:.2f} dB, golden {s_gold:.2f} dB",
              flush=True)
        check(f"flagship {mode} |device - golden| SNR", abs(s_dev - s_gold),
              hi=1.0, unit=" dB")
    compare("flagship channels c and c+4 identical", audio[4:8], audio[0:4], atol=1e-5)

    # the Triton front end against the plain XLA front end, same width
    chain_k, chain_x = RxChain(cfg), _xla_front(RxChain(cfg))
    rng = np.random.default_rng(0)
    iq = jax.jit(jax.lax.complex)(jnp.asarray(rng.standard_normal((C, T)), jnp.float32),
                                  jnp.asarray(rng.standard_normal((C, T)), jnp.float32))
    words = jnp.asarray(nco.freq_word(np.linspace(-0.4, 0.4, C) * FS / 2, FS))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)
    outs = {}
    for name, ch in (("triton", chain_k), ("xla", chain_x)):
        st = jax.jit(lambda ch=ch: ch.init_state(C))()
        fst, _ = ch.split_state(st)
        _, x, pw = jax.jit(ch.step_front)(fst, iq, words)
        _, a, _ = jax.jit(ch.step)(st, iq, words, mode)
        outs[name] = (np.asarray(x), np.asarray(pw), np.asarray(a))
    if chain_k.frontend is not None:
        xk, pk, ak = outs["triton"]
        xx, px, ax = outs["xla"]
        compare("flagship triton vs xla front-end output", xk, xx, atol=2e-5)
        compare("flagship triton vs xla power_in", pk, px, atol=0, rtol=1e-5)
        # white-noise input: NFM's arctan2 and the AGC's gain amplify the
        # front end's last-bit differences, so the audio bound is -54 dB
        # re the AGC target (0.5) rather than the front end's own
        compare("flagship triton vs xla audio (after 512-sample warm-up)",
                ak[:, 512:], ax[:, 512:], atol=2e-3)

    def timer(ch):
        def step(st, iq, words, mode):
            st, a, _ = ch.step(st, iq, words, mode)
            return st, (a,)
        st = jax.jit(lambda: ch.init_state(C))()
        return loop_timer(step, st, (iq, words, mode), 64)

    rk, rx, runs = _abba(64 * C * T, timer(chain_k), timer(chain_x))
    print(f"flagship end to end, triton front end {rk:.6e} vs xla front end "
          f"{rx:.6e} input samples/s (runs a,b,b,a: {runs})", flush=True)
    return rk


def phase_adc_rx(card, C=128, n_blocks=3):
    """ADC-rate RX (R=1280) at 128 channels with int16 ingest through
    step_i16, against a chain without int16 ingest fed counts * 2**-15."""
    import jax
    import jax.numpy as jnp

    from bench import loop_timer
    from radioframe.core import presets
    from radioframe.ops import nco
    from radioframe.pipelines.rx_chain import RxChain

    ch16 = RxChain(presets.adc_61m44(C, int16_ingest=True))
    ch32 = RxChain(presets.adc_61m44(C))
    T = ch16.min_block
    fs = ch16.cfg.fs_in
    words = jnp.asarray(nco.freq_word(np.linspace(-20e6, 20e6, C), fs))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)

    @jax.jit
    def counts(key):
        k1, k2 = jax.random.split(key)
        t = jnp.arange(T, dtype=jnp.float32) / fs
        tone = 0.3 * jnp.cos(2 * np.pi * 1.0e6 * t)
        q = lambda v: jnp.clip(jnp.round(v * 32768.0), -32768, 32767).astype(jnp.int16)
        return (q(0.1 * jax.random.normal(k1, (C, T)) + tone),
                q(0.1 * jax.random.normal(k2, (C, T))))

    scale = jnp.float32(2.0 ** -15)
    to_c = jax.jit(lambda a, b: jax.lax.complex(a.astype(jnp.float32) * scale,
                                                b.astype(jnp.float32) * scale))
    s16 = jax.jit(lambda: ch16.init_state(C))()
    s32 = jax.jit(lambda: ch32.init_state(C))()
    step16, step32 = jax.jit(ch16.step_i16), jax.jit(ch32.step)
    a16s, a32s = [], []
    for b in range(n_blocks):
        cr, ci = counts(jax.random.PRNGKey(b))
        s16, a16, x16 = step16(s16, cr, ci, words, mode)
        s32, a32, x32 = step32(s32, to_c(cr, ci), words, mode)
        a16s.append(np.asarray(a16))
        a32s.append(np.asarray(a32))
    print(f"adc: {C} channels x {T} int16 samples/block, front end: "
          f"{'triton' if ch16.frontend else 'xla'}", flush=True)
    compare("adc int16 step_i16 vs float chain on counts*2^-15",
            np.concatenate(a16s, -1)[:, 512:], np.concatenate(a32s, -1)[:, 512:],
            atol=2e-4)
    compare("adc int16 vs float power_in", x16["power_in"], x32["power_in"],
            atol=0, rtol=1e-4)

    chx = _xla_front(RxChain(presets.adc_61m44(C, int16_ingest=True)))
    if ch16.frontend is not None:
        sk = jax.jit(lambda: ch16.init_state(C))()
        sx = jax.jit(lambda: chx.init_state(C))()
        stepx = jax.jit(chx.step_i16)
        for b in range(2):  # the second block, past the filters' warm-up
            cr, ci = counts(jax.random.PRNGKey(b))
            sk, ak, _ = step16(sk, cr, ci, words, mode)
            sx, ax, _ = stepx(sx, cr, ci, words, mode)
        compare("adc triton vs xla front end, audio of block 2 (see flagship)",
                ak, ax, atol=2e-3)

    def timer(ch):
        def step(st, cr, ci, words, mode):
            st, a, _ = ch.step_i16(st, cr, ci, words, mode)
            return st, (a,)
        st = jax.jit(lambda: ch.init_state(C))()
        return loop_timer(step, st, (cr, ci, words, mode), 16)

    rk, rx, runs = _abba(16 * C * T, timer(ch16), timer(chx))
    print(f"adc end to end, triton front end {rk:.6e} vs xla front end "
          f"{rx:.6e} input samples/s (runs a,b,b,a: {runs})", flush=True)
    return rk


def phase_channelizer(card, n_blocks=3, M=4096, frames=1024):
    """Config 5 through Monitor: 61.44 Msps blocks into 4096 channels; tone
    channels and the waterfall against the golden PFB model."""
    import jax
    import jax.numpy as jnp

    from bench import _loop_rate
    from radioframe.api.monitor import Monitor
    from radioframe.core import presets
    from radioframe.golden import model as G
    from radioframe.ops import demod as demod_op
    from radioframe.ops import filter_design as FD

    cfg = presets.channelizer_61m44(M)
    mon = Monitor(cfg)
    mon.set_mode_all("am")
    T = frames * M
    assert T % mon.chain.min_block == 0
    rng = np.random.default_rng(5)
    tones = (M // 40, M // 4, M // 2 - 1, 3 * M // 4)
    n = np.arange(n_blocks * T)
    wide = 1e-3 * (rng.standard_normal(n.size) + 1j * rng.standard_normal(n.size))
    for i, c in enumerate(tones):
        wide += (0.2 + 0.1 * i) * np.exp(2j * np.pi * c * n / M)
    wide = wide.astype(np.complex64)
    blocks = np.split(wide, n_blocks)
    audio = [mon.process(blocks[0])]
    wf0 = np.asarray(mon.waterfall())
    audio += [mon.process(b) for b in blocks[1:]]
    audio = np.concatenate(audio, -1)
    check("channelizer audio finite", float(np.all(np.isfinite(audio))), lo=1.0)
    compare("channelizer audio shape", np.array(audio.shape), np.array([M, n_blocks * frames]),
            atol=0)
    top = sorted(int(c) for c in np.argsort(mon.channel_power())[::-1][:len(tones)])
    compare("channelizer strongest channels are the tone channels",
            np.array(top), np.array(tones), atol=0)
    gold = G.pfb_channelize(blocks[0].astype(np.complex128), M,
                            FD.pfb_prototype_taps(M, cfg.taps_per_channel))  # (F, M)
    A = cfg.waterfall_frame_avg
    p = (np.abs(gold) ** 2).reshape(-1, A, M).mean(axis=1)
    lines = np.roll(10 * np.log10(np.maximum(p, 1e-24)), M // 2, axis=-1)
    loud = lines > lines.max() - 60.0
    compare("channelizer waterfall vs golden PFB (dB, bins within 60 dB of peak)",
            wf0[loud], lines[loud], atol=0.05)

    wide_d = jax.jit(jax.lax.complex)(jnp.asarray(wide[:T].real), jnp.asarray(wide[:T].imag))
    mode = jnp.full((M,), demod_op.AM, jnp.int32)

    def step(st, w, m):
        st, a, aux = mon.chain.step(st, w, m)
        return st, (a, aux["waterfall"])

    return _loop_rate(step, jax.jit(mon.chain.init_state)(), (wide_d, mode), 16, T)[0]


def phase_duplex(card, n_blocks=24, C=64):
    """TX DUC at 61.44 Msps and an RX half in one DuplexChain program: each
    block's TX IQ is the next block's RX input; audio SNR of the loopback.
    Then one Transceiver block with PTT keyed and one with it up."""
    import jax
    import jax.numpy as jnp

    from bench import _loop_rate
    from radioframe.api.transceiver import Transceiver
    from radioframe.core import presets
    from radioframe.diag.metrics import audio_snr_db
    from radioframe.io import fixtures as FX
    from radioframe.ops import demod as demod_op
    from radioframe.ops import nco
    from radioframe.pipelines.duplex import DuplexChain

    rx_cfg = presets.adc_61m44(C)
    tx_cfg = presets.tx_adc_61m44(C, compressor_max_gain=1.0)
    dpx, dpx_x = DuplexChain(rx_cfg, tx_cfg), DuplexChain(rx_cfg, tx_cfg)
    _xla_front(dpx_x.rx)
    T = dpx.rx.min_block
    Ta = T // rx_cfg.decim
    offs = np.linspace(-20e6, 20e6, C)
    words = jnp.asarray(nco.freq_word(offs, rx_cfg.fs_in))
    mode = jnp.full((C,), demod_op.SSB, jnp.int32)
    truth = FX.tone_audio(tx_cfg.fs_audio, n_blocks * Ta).astype(np.float32)
    def loopback(d):
        step = jax.jit(d.step)
        st = jax.jit(lambda: d.init_state(C))()
        rx_in = jnp.zeros((C, T), jnp.complex64)
        outs = []
        for b in range(n_blocks):
            mic = jnp.broadcast_to(jnp.asarray(truth[b * Ta:(b + 1) * Ta]), (C, Ta))
            st, rx_audio, rx_in, _ = step(st, rx_in, mic, words, mode, words, mode)
            outs.append(np.asarray(rx_audio))
        got = np.concatenate(outs[1:], -1)  # RX of block b is the TX of block b-1
        settle = 4 * Ta
        return np.array([audio_snr_db(truth[settle:len(truth) - Ta], got[c, settle:],
                                      trim=512) for c in range(C)]), rx_in

    snr_k, rx_in = loopback(dpx)
    snr_x, _ = loopback(dpx_x)
    for name, snrs in (("triton", snr_k), ("xla", snr_x)):
        print(f"duplex loopback SNR, {name} RX front end, {C} channels: min "
              f"{snrs.min():.2f} dB, median {float(np.median(snrs)):.2f} dB; by channel "
              f"{np.round(snrs, 1).tolist()}", flush=True)
    check("duplex TX->RX loopback audio SNR (worst channel)", float(snr_k.min()),
          lo=15.0, unit=" dB")
    compare("duplex loopback SNR, triton vs xla RX front end (dB)", snr_k, snr_x, atol=1.0)

    trx = Transceiver(rx_cfg, tx_cfg)
    for c in range(C):
        trx.tune(c, float(offs[c]))
    trx.ptt(True)
    rx_a, tx_iq = trx.process(np.zeros((C, T), np.complex64), truth[:Ta])
    check("transceiver PTT keyed: TX IQ power", float(np.mean(np.abs(tx_iq) ** 2)), lo=1e-6)
    compare("transceiver PTT keyed: RX muted", rx_a, np.zeros_like(rx_a), atol=0)
    trx.ptt(False)
    rx_a, tx_iq = trx.process(np.zeros((C, T), np.complex64), truth[:Ta])
    compare("transceiver PTT up: TX silent", np.abs(tx_iq), np.zeros(tx_iq.shape), atol=0)

    mic = jnp.broadcast_to(jnp.asarray(truth[:Ta]), (C, Ta))

    def dstep(st, rx_in, mic, words, mode):
        st, a, tx, _ = dpx.step(st, rx_in, mic, words, mode, words, mode)
        return st, (a, tx)

    return _loop_rate(dstep, jax.jit(lambda: dpx.init_state(C))(),
                      (rx_in, mic, words, mode), 16, C * T)[0]


def phase_resume(card, C=128, n_blocks=4):
    """Radio.save/load on the card resumes the stream bit-exactly."""
    from radioframe.api.radio import Radio
    from radioframe.core import presets

    cfg = presets.wideband_1536k(C)
    r1 = Radio(cfg)
    T = r1.chain.min_block
    rng = np.random.default_rng(9)
    blocks = [(rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
              .astype(np.complex64) for _ in range(n_blocks)]
    for c in range(C):
        r1.tune(c, 1e3 * (c - C // 2))
        r1.set_mode(c, ("ssb", "cw", "am", "nfm")[c % 4])
    half = n_blocks // 2
    for b in blocks[:half]:
        r1.process(b)
    with tempfile.TemporaryDirectory() as d:
        r1.save(d, epoch=1)
        want = np.concatenate([r1.process(b) for b in blocks[half:]], -1)
        r2 = Radio(cfg)
        r2.load(d)
    got = np.concatenate([r2.process(b) for b in blocks[half:]], -1)
    compare("resume after Radio.save/load, bit-exact", got, want, atol=0)
    return None


# ---------------------------------------------------------------- four cards

def _distinct_devices(name, arr, n):
    devs = {s.device for s in arr.addressable_shards}
    check(f"{name}: shards on distinct devices", float(len(devs)), lo=float(n))


def phase_config3_sharded_rx(card, C=64, block_mult=8, n_blocks=3):
    """Config 3: ShardedRxChain, 64 channels of wideband_1536k on a 2x2
    ('channel', 'time') mesh with ppermute halos, against one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from bench import _loop_rate
    from radioframe.core import presets
    from radioframe.ops import nco
    from radioframe.pipelines.rx_chain import RxChain
    from radioframe.shard.mesh import place_state
    from radioframe.shard.rx import ShardedRxChain

    devs = jax.devices()[:4]
    chain = RxChain(presets.wideband_1536k(C))
    mesh = jax.make_mesh((2, 2), ("channel", "time"), devices=devs,
                         axis_types=(AxisType.Auto,) * 2)
    sharded = ShardedRxChain(chain, mesh)
    T = block_mult * chain.min_block
    fs = chain.cfg.fs_in
    rng = np.random.default_rng(3)
    one = jax.sharding.SingleDeviceSharding(devs[0])
    words = nco.freq_word(np.linspace(-6e5, 6e5, C), fs)
    mode = (np.arange(C) % 4).astype(np.int32)
    st1 = jax.jit(lambda: chain.init_state(C), out_shardings=one)()
    stm = place_state(chain.init_state(C), sharded.state_specs(), mesh)
    s_cp = NamedSharding(mesh, P("channel"))
    w_m, m_m = jax.device_put(words, s_cp), jax.device_put(mode, s_cp)
    w_1, m_1 = jax.device_put(words, one), jax.device_put(mode, one)
    step1, stepm = jax.jit(chain.step), jax.jit(sharded.step)
    a1s, ams = [], []
    for b in range(n_blocks):
        x = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
        st1, a1, _ = step1(st1, jax.device_put(x, one), w_1, m_1)
        xm = jax.device_put(x, NamedSharding(mesh, P("channel", "time")))
        stm, am, _ = stepm(stm, xm, w_m, m_m)
        if b == 0:
            _distinct_devices("config3 input", xm, 4)
            _distinct_devices("config3 audio", am, 4)
        a1s.append(np.asarray(a1))
        ams.append(np.asarray(am))
    compare("config3 sharded 2x2 vs one card, audio (after 512-sample warm-up)",
            np.concatenate(ams, -1)[:, 512:], np.concatenate(a1s, -1)[:, 512:], atol=2e-4)
    compare("config3 sharded vs one card, DDS accumulators", stm["nco"], st1["nco"], atol=0)

    xm = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("channel", "time")))

    def step(st, x, w, m, impl=sharded):
        st, a, _ = impl.step(st, x, w, m)
        return st, (a,)

    r1 = _loop_rate(lambda *a: step(*a, impl=chain), st1,
                    (jax.device_put(x, one), w_1, m_1), 32, C * T)[0]
    rm = _loop_rate(step, stm, (xm, w_m, m_m), 32, C * T)[0]
    print(f"config3 input samples/s: one card {r1:.6e}, four cards {rm:.6e} "
          f"({rm / r1:.3f}x)", flush=True)
    return rm


def phase_config5_sharded_channelizer(card, M=4096, frames=1024, n_blocks=2):
    """Config 5: ShardedChannelizer (all_to_all form), M=4096 on a 1-D mesh
    of 4 cards, against the one-card channelizer."""
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from bench import _loop_rate
    from radioframe.core import presets
    from radioframe.pipelines.channelizer import ChannelizerChain
    from radioframe.shard.channelizer import ShardedChannelizer
    from radioframe.shard.mesh import place_state

    devs = jax.devices()[:4]
    chain = ChannelizerChain(presets.channelizer_61m44(M))
    mesh = jax.make_mesh((4,), ("dev",), devices=devs, axis_types=(AxisType.Auto,))
    sharded = ShardedChannelizer(chain, mesh)
    T = frames * M
    one = jax.sharding.SingleDeviceSharding(devs[0])
    rng = np.random.default_rng(4)
    mode = (np.arange(M) % 4).astype(np.int32)
    st1 = jax.jit(chain.init_state, out_shardings=one)()
    stm = place_state(chain.init_state(), sharded.state_specs(), mesh)
    m_m = jax.device_put(mode, NamedSharding(mesh, P("dev")))
    m_1 = jax.device_put(mode, one)
    step1, stepm = jax.jit(chain.step), jax.jit(sharded.step)
    a1s, ams, wf1, wfm = [], [], [], []
    for b in range(n_blocks):
        x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
        st1, a1, x1 = step1(st1, jax.device_put(x, one), m_1)
        xm = jax.device_put(x, NamedSharding(mesh, P("dev")))
        stm, am, xmx = stepm(stm, xm, m_m)
        if b == 0:
            _distinct_devices("config5 input", xm, 4)
            _distinct_devices("config5 audio", am, 4)
        a1s.append(np.asarray(a1))
        ams.append(np.asarray(am))
        wf1.append(np.asarray(x1["waterfall"]))
        wfm.append(np.asarray(xmx["waterfall"]))
    K = chain.pfb.K  # PFB warm-up frames
    compare("config5 sharded x4 vs one card, audio (after PFB warm-up)",
            np.concatenate(ams, -1)[:, K:], np.concatenate(a1s, -1)[:, K:], atol=2e-4)
    compare("config5 sharded x4 vs one card, waterfall dB",
            np.concatenate(wfm), np.concatenate(wf1), atol=1e-2)

    def step(st, x, m, impl=sharded):
        st, a, aux = impl.step(st, x, m)
        return st, (a, aux["waterfall"])

    r1 = _loop_rate(lambda *a: step(*a, impl=chain), st1,
                    (jax.device_put(x, one), m_1), 16, T)[0]
    rm = _loop_rate(step, stm, (xm, m_m), 16, T)[0]
    print(f"config5 wideband samples/s: one card {r1:.6e}, four cards {rm:.6e} "
          f"({rm / r1:.3f}x)", flush=True)
    return rm


def run(phases, card):
    rates = {}
    for name in phases:
        print(f"=== phase {name}", flush=True)
        rates[name] = globals()[f"phase_{name}"](card)
    for name, r in rates.items():
        if r is not None:
            report_rate(name, r, card)
    return rates


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phases (configs 3 and 5)")
    args = ap.parse_args(argv)
    import jax

    devices = jax.devices()
    need = 4 if args.multi else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke.py needs {need} NVIDIA GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)", file=sys.stderr)
        return 2
    from radioframe.core.compile_cache import use_compile_cache

    use_compile_cache()
    card = card_name()
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}", flush=True)
    run(select_phases(args.multi), card)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
