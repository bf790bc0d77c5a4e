"""radioframe CLI — the system-menu/CAT analog for humans and scripts.

    radioframe rx --wav cap.wav --freq 37000 --mode ssb --out audio.wav
    radioframe demo [--blocked] [--snr DB]
    radioframe decode --wav audio.wav [--cw|--rtty] [--tone HZ]
    radioframe info

Reference analogs: `[U:system_menu.c]` (parameters -> flags) and `[U:cat.c]`
(external control -> this CLI / the Python Radio API).
"""

from __future__ import annotations

import argparse
import sys


def _cmd_info(args):
    import jax

    import radioframe

    print(f"radioframe {radioframe.__version__}")
    print(f"jax {jax.__version__}, devices: {jax.devices()}")
    from radioframe.core.config import RxConfig
    from radioframe.pipelines.rx_chain import RxChain

    chain = RxChain(RxConfig())
    print(f"default RX chain: fs_in={chain.cfg.fs_in:.0f} Hz, decim={chain.cfg.decim}, "
          f"audio fs={chain.cfg.fs_audio:.0f} Hz, min block={chain.min_block}")
    from radioframe.ops import ft8, wspr

    for name, mod in (("FT8", ft8), ("WSPR", wspr)):
        if getattr(mod, "INTEROP_PROVISIONAL", False):
            print(f"{name}: on-air interop PROVISIONAL "
                  f"(stand-in tables: {', '.join(mod.PROVISIONAL_ITEMS)})")
    return 0


def _cmd_rx(args):
    import numpy as np

    from radioframe.api.radio import Radio
    from radioframe.core.config import RxConfig
    from radioframe.io.wav import read_wav, write_wav

    iq, fs = read_wav(args.wav)
    cfg = RxConfig(fs_in=fs, channels=1, emit_spectrum=args.waterfall is not None)
    r = Radio(cfg)
    r.tune(0, args.freq)
    r.set_mode(0, args.mode)
    chain_min = r.chain.min_block
    n = (len(iq) // chain_min) * chain_min
    if n == 0:
        print(f"capture too short: {len(iq)} < one block ({chain_min})", file=sys.stderr)
        return 1
    audio = r.process(iq[:n])[0]
    write_wav(args.out, audio, cfg.fs_audio)
    m = r.metrics()
    print(f"{args.wav}: {n} IQ samples @ {fs:.0f} Hz -> {len(audio)} audio samples "
          f"@ {cfg.fs_audio:.0f} Hz ({args.mode} @ {args.freq:+.0f} Hz)")
    print(f"input power {10*np.log10(float(m['power_in'][0])+1e-30):.1f} dB, "
          f"AGC gain {float(m['agc_gain_last'][0]):.2f}")
    if args.waterfall:
        wf = r.waterfall()[0]
        np.save(args.waterfall, wf)
        print(f"waterfall ({wf.shape[0]} lines x {wf.shape[1]} bins) -> {args.waterfall}")
    print(f"audio -> {args.out}")
    return 0


def _cmd_decode(args):
    from radioframe.io.wav import read_wav
    from radioframe.ops.decoders import cw_decode, rtty_decode

    audio, fs = read_wav(args.wav)
    if args.rtty:
        text = rtty_decode(audio, fs)
    else:
        text = cw_decode(audio, fs, args.tone)
    print(text)
    return 0


def _cmd_tx(args):
    import jax.numpy as jnp
    import numpy as np

    from radioframe.core.config import TxConfig
    from radioframe.io.wav import read_wav, write_wav
    from radioframe.ops import demod as demod_op
    from radioframe.ops import nco
    from radioframe.pipelines.tx_chain import TxChain

    audio, fs = read_wav(args.wav)
    if np.iscomplexobj(audio):
        print("tx expects a MONO audio WAV", file=sys.stderr)
        return 1
    tx = TxChain(TxConfig(channels=1, fs_audio=fs, fs_out=fs * 4,
                          mic_eq_bands=tuple(args.eq or ())))
    n = (len(audio) // tx.min_block) * tx.min_block
    if n == 0:
        print(f"audio too short: {len(audio)} < one block ({tx.min_block})",
              file=sys.stderr)
        return 1
    import jax

    w = jnp.asarray([nco.freq_word(args.freq, tx.cfg.fs_out)], jnp.int32)
    mode = jnp.asarray([demod_op.MODE_NAMES[args.mode]], jnp.int32)
    # jit the whole step and fetch f32 I/Q planes, interleaving host-side
    st = jax.jit(lambda: tx.init_state(1))()

    def _step(st, a, w, m):
        st, iq = tx.step(st, a, w, m)
        return st, jnp.real(iq), jnp.imag(iq)

    st, ir, ii = jax.jit(_step)(st, jnp.asarray(audio[None, :n], jnp.float32),
                                w, mode)
    iq = np.asarray(ir)[0] + 1j * np.asarray(ii)[0]
    write_wav(args.out, iq.astype(np.complex64), tx.cfg.fs_out)
    print(f"{args.wav}: {n} audio samples @ {fs:.0f} Hz -> {len(iq)} IQ samples "
          f"@ {tx.cfg.fs_out:.0f} Hz ({args.mode} @ {args.freq:+.0f} Hz) -> {args.out}")
    return 0


def _cmd_demo(args):
    import examples.rx_demo  # noqa: F401  (runs via its main)
    sys.argv = ["rx_demo"] + (["--blocked"] if args.blocked else [])
    if args.snr is not None:
        sys.argv += ["--snr", str(args.snr)]
    examples.rx_demo.main()
    return 0


def _cmd_cat(args):
    """Serve the Kenwood-dialect CAT protocol over TCP while a duplex
    stream processes synthetic blocks — a rig-control client (hamlib,
    wsjtx) can connect and tune/mode/key it live (`[U:usbd_*]` analog)."""
    import threading
    import time as _time

    import jax
    import numpy as np

    from radioframe.api.cat import CatServer
    from radioframe.api.cat_tcp import CatTcpServer
    from radioframe.api.transceiver import Transceiver
    from radioframe.core.config import RxConfig, TxConfig

    trx = Transceiver(RxConfig(channels=1), TxConfig(channels=1))
    chain = trx.chain.rx
    B, fs = chain.min_block, trx.rx_cfg.fs_in
    stop = threading.Event()
    srv = CatTcpServer(CatServer(trx), port=args.port)
    # warm the jit before serving so the first client command never waits
    # behind a multi-second compile inside the dispatch lock
    trx.process(np.zeros((1, B), np.complex64),
                np.zeros(B // trx.rx_cfg.decim, np.float32))

    def stream():
        rng = np.random.default_rng(0)
        n = 0
        while not stop.is_set():
            t = (np.arange(B) + n * B) / fs
            iq = (args.tone_amp * np.exp(2j * np.pi * args.tone * t)
                  + 0.01 * (rng.standard_normal(B) + 1j * rng.standard_normal(B)))
            # hold the CAT dispatch lock for the control-plane snapshot so a
            # multi-part command (FA...;MD...;) never half-applies to a block
            with srv.lock:
                trx.process(iq.astype(np.complex64)[None, :],
                            np.zeros(B // trx.rx_cfg.decim, np.float32))
            n += 1

    th = threading.Thread(target=stream, daemon=True)
    th.start()
    with srv:
        print(f"CAT server on {srv.host}:{srv.port}  "
              f"(synthetic tone at {args.tone:+.0f} Hz; ctrl-C to stop)")
        try:
            while True:
                _time.sleep(1.0)
        except KeyboardInterrupt:
            pass
    stop.set()
    th.join(timeout=5)
    return 0


def _cmd_monitor(args):
    """Wideband WAV -> every-channel demod + waterfall (config 5 dataflow)."""
    import numpy as np

    from radioframe.api.monitor import Monitor
    from radioframe.core import presets
    from radioframe.io.wav import read_wav, write_wav

    iq, fs = read_wav(args.wav)
    M = args.channels
    if not 0 <= args.channel < M:
        print(f"--channel {args.channel} out of range [0, {M})",
              file=sys.stderr)
        return 1
    cfg = presets.channelizer_61m44(M, fs_in=fs)
    mon = Monitor(cfg)
    mon.set_mode_all(args.mode)
    nmin = mon.chain.min_block
    n = (len(iq) // nmin) * nmin
    if n == 0:
        print(f"capture too short: {len(iq)} < one block ({nmin})",
              file=sys.stderr)
        return 1
    audio = mon.process(iq[:n])
    cp = mon.channel_power()
    top = np.argsort(cp)[::-1][:5]
    print(f"{args.wav}: {n} wideband samples @ {fs:.0f} Hz -> "
          f"{M} channels x {audio.shape[1]} audio samples "
          f"@ {cfg.fs_channel:.0f} Hz")
    for c in top:
        print(f"  ch {int(c):4d} ({mon.channel_frequency(int(c)):+11.0f} Hz): "
              f"{10 * np.log10(max(float(cp[c]), 1e-30)):6.1f} dB")
    if args.audio_out is not None:
        write_wav(args.audio_out, audio[args.channel], cfg.fs_channel)
        print(f"channel {args.channel} audio -> {args.audio_out}")
    if args.waterfall is not None:
        np.save(args.waterfall, mon.waterfall())
        print(f"waterfall -> {args.waterfall}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="radioframe")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="environment + default chain info")

    rx = sub.add_parser("rx", help="demodulate a WAV IQ capture")
    rx.add_argument("--wav", required=True)
    rx.add_argument("--freq", type=float, required=True, help="carrier offset Hz")
    rx.add_argument("--mode", default="ssb", choices=["ssb", "cw", "am", "nfm"])
    rx.add_argument("--out", default="audio.wav")
    rx.add_argument("--waterfall", default=None, help="save waterfall .npy")

    dec = sub.add_parser("decode", help="decode CW/RTTY from audio WAV")
    dec.add_argument("--wav", required=True)
    dec.add_argument("--rtty", action="store_true")
    dec.add_argument("--tone", type=float, default=600.0)

    tx = sub.add_parser("tx", help="modulate a mono audio WAV to an IQ WAV (DUC)")
    tx.add_argument("--wav", required=True, help="mono audio WAV input")
    tx.add_argument("--freq", type=float, default=0.0, help="TX carrier offset Hz")
    tx.add_argument("--mode", default="ssb", choices=["ssb", "lsb", "cw", "am", "nfm"])
    tx.add_argument("--out", default="tx_iq.wav")
    tx.add_argument("--eq", type=lambda s: tuple(float(v) for v in s.split(",")),
                    nargs="*", help="mic EQ bands as freq,gain_db,Q triples")

    demo = sub.add_parser("demo", help="run the 4-mode synthetic demo")
    demo.add_argument("--blocked", action="store_true")
    demo.add_argument("--snr", type=float, default=None)

    mon = sub.add_parser(
        "monitor", help="channelize a wideband IQ WAV: every-channel demod")
    mon.add_argument("--wav", required=True, help="wideband IQ WAV input")
    mon.add_argument("--channels", type=int, default=64)
    mon.add_argument("--mode", default="ssb",
                     choices=["ssb", "cw", "am", "nfm", "lsb"])
    mon.add_argument("--channel", type=int, default=0,
                     help="channel for --audio-out")
    mon.add_argument("--audio-out", default=None, help="save one channel's audio WAV")
    mon.add_argument("--waterfall", default=None, help="save waterfall .npy")

    cat = sub.add_parser("cat", help="serve CAT over TCP with a live stream")
    cat.add_argument("--port", type=int, default=4532, help="0 = ephemeral")
    cat.add_argument("--tone", type=float, default=39_000.0)
    cat.add_argument("--tone-amp", type=float, default=0.3)

    args = ap.parse_args(argv)
    from radioframe.core.compile_cache import use_compile_cache

    use_compile_cache()
    return {"info": _cmd_info, "rx": _cmd_rx, "tx": _cmd_tx, "decode": _cmd_decode,
            "demo": _cmd_demo, "cat": _cmd_cat,
            "monitor": _cmd_monitor}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
