"""Demo: the jitted RxChain over a 4-signal wideband capture, 4 modes at once.

Usage: python examples/rx_demo.py [--channels N] [--snr DB]

One wideband 192 kHz IQ stream carries SSB/CW/AM/NFM signals; N receiver
channels tune to them simultaneously in a single jitted block program
(BASELINE.json configs 1+2). Prints per-mode audio SNR vs the clean
modulating audio.
"""

import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--blocks", type=int, default=96)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from radioframe.core.config import RxConfig
    from radioframe.diag.metrics import audio_snr_db
    from radioframe.golden import model as G
    from radioframe.io import fixtures as FX
    from radioframe.ops import demod as demod_op
    from radioframe.ops import filter_design as FD
    from radioframe.ops import nco
    from radioframe.pipelines.rx_chain import RxChain

    FS = 192_000.0
    C = args.channels
    chain = RxChain(RxConfig(channels=C))
    n = args.blocks * chain.min_block

    print(f"generating fixtures ({n/FS:.2f} s of 192 kHz IQ)...")
    ssb_iq, ssb_truth = FX.ssb_capture(FS, n, 37_000.0, snr_db=args.snr)
    am_iq, am_truth = FX.am_capture(FS, n, 20_000.0, snr_db=args.snr)
    nfm_iq, nfm_truth = FX.nfm_capture(FS, n, -15_000.0, snr_db=args.snr)
    cw_iq, cw_key = FX.cw_capture(FS, n, 70_000.0, snr_db=args.snr)
    wideband = (ssb_iq + am_iq + nfm_iq + cw_iq).astype(np.complex64)

    base_freqs = [37_000.0, 70_000.0, 20_000.0, -15_000.0]
    base_modes = [demod_op.SSB, demod_op.CW, demod_op.AM, demod_op.NFM]
    freqs = [base_freqs[i % 4] for i in range(C)]
    modes = [base_modes[i % 4] for i in range(C)]
    words = jnp.asarray(nco.freq_word(freqs, FS))
    mode = jnp.asarray(modes, jnp.int32)

    step = jax.jit(chain.step)
    st = chain.init_state(C)
    iq_dev = jnp.asarray(wideband[None, :])

    t0 = time.perf_counter()
    st, audio, aux = jax.block_until_ready(step(st, iq_dev, words, mode))
    t1 = time.perf_counter()
    st = chain.init_state(C)
    st, audio, aux = jax.block_until_ready(step(st, iq_dev, words, mode))
    t2 = time.perf_counter()
    audio = np.asarray(audio)

    settle = 32 * 1024 if audio.shape[-1] >= 48 * 1024 else 0
    print(f"devices: {jax.devices()}  channels: {C}")
    print(f"compile+run {t1-t0:.2f} s, steady-state run {t2-t1:.3f} s "
          f"({n * C / (t2-t1) / 1e6:.1f} M chan-samples/s)")
    print(f"  SSB @ +37 kHz: {audio_snr_db(ssb_truth, audio[0]):6.1f} dB")
    if C >= 3:
        print(f"  AM  @ +20 kHz: {audio_snr_db(am_truth[settle:], audio[2][settle:], trim=1024):6.1f} dB")
    if C >= 4:
        print(f"  NFM @ -15 kHz: {audio_snr_db(nfm_truth[settle:], audio[3][settle:], trim=1024):6.1f} dB")
    if C >= 2:
        env = np.abs(audio[1])
        lp = FD.lowpass_taps(65, 100.0, 48_000.0)
        env_s, _ = G.fir_decimate(env.astype(np.complex128), lp, 1)
        key48 = cw_key[::4][: len(env_s)]
        c = np.corrcoef(np.real(env_s), key48)[0, 1]
        print(f"  CW  @ +70 kHz: keying correlation {c:.3f}")


if __name__ == "__main__":
    sys.exit(main())
