"""Demo: full-duplex TRX — TX a voice SSB signal and RX it back, one program.

Usage: python examples/duplex_demo.py [--mode ssb|am|nfm] [--offset HZ]
                                      [--rx-offset HZ]

Drives DuplexChain (BASELINE.json config 4): the TX DUC chain modulates audio
up to +offset inside a 192 kHz IQ spectrum; the RX DDC chain tunes
--rx-offset (default = offset) and demodulates. Prints TX spectrum peak and
loopback audio SNR.
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="ssb", choices=["ssb", "am", "nfm"])
    ap.add_argument("--offset", type=float, default=25_000.0)
    ap.add_argument("--rx-offset", type=float, default=None)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radioframe.core.config import RxConfig, TxConfig
    from radioframe.diag.metrics import audio_snr_db
    from radioframe.io import fixtures as FX
    from radioframe.ops import demod as demod_op
    from radioframe.ops import nco
    from radioframe.pipelines.duplex import DuplexChain

    FS, FA = 192_000.0, 48_000.0
    rx_off = args.offset if args.rx_offset is None else args.rx_offset
    n = 96 * 2048 // 4  # audio samples (~1 s)
    if args.mode == "ssb":
        audio = FX.voicelike_audio(FA, n)
    else:
        t = np.arange(n) / FA
        audio = (0.6 * np.sin(2 * np.pi * 800.0 * t)).astype(np.float32)

    dpx = DuplexChain(RxConfig(channels=1), TxConfig(channels=1, compressor_max_gain=1.0))
    txw = jnp.asarray([nco.freq_word(args.offset, FS)], jnp.int32)
    rxw = jnp.asarray([nco.freq_word(rx_off, FS)], jnp.int32)
    m = jnp.asarray([demod_op.MODE_NAMES[args.mode]], jnp.int32)
    step = jax.jit(dpx.step)

    st = dpx.init_state(1)
    st, _, tx_iq, _ = step(st, jnp.zeros((1, 4 * n), jnp.complex64),
                           jnp.asarray(audio[None, :], jnp.float32), rxw, m, txw, m)
    tx = np.asarray(tx_iq)[0]
    X = np.abs(np.fft.fft(tx))
    f = np.fft.fftfreq(len(tx), 1 / FS)
    peak = f[np.argmax(X)]
    print(f"TX: mode={args.mode} requested +{args.offset/1e3:.1f} kHz, "
          f"spectrum peak at {peak/1e3:+.2f} kHz, power {10*np.log10(np.mean(np.abs(tx)**2)):.1f} dB")

    st2 = dpx.init_state(1)
    st2, rx_audio, _, aux = step(st2, tx_iq, jnp.zeros((1, n), jnp.float32), rxw, m, txw, m)
    out = np.asarray(rx_audio)[0]
    settle = 16 * 1024
    snr = audio_snr_db(audio[settle:], out[settle:], trim=1024)
    print(f"RX @ {rx_off/1e3:+.1f} kHz: loopback audio SNR {snr:.1f} dB "
          f"(vs raw mic audio; AGC + band edges included)")


if __name__ == "__main__":
    main()
