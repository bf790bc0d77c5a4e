"""Demo: PFB channelizer — wideband in, waterfall PNG + per-channel audio out.

Usage: python examples/channelizer_demo.py [--channels 64] [--out waterfall.png]

Synthesizes a wideband capture holding several signals (AM carriers, an FM
station, CW), channelizes with the polyphase filterbank, demodulates every
channel simultaneously, and renders the wideband waterfall + channel power
map (BASELINE config 5 shape, single-host).
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--out", default="waterfall.png")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from radioframe.ops import demod as demod_op
    from radioframe.pipelines.channelizer import ChannelizerChain, ChannelizerConfig

    M = args.channels
    if M < 8:
        ap.error(f"--channels {M}: need >= 8 (the demo places AM/NFM/CW "
                 "signals on three distinct channels)")
    fs_ch = 48_000.0
    cfg = ChannelizerConfig(fs_in=fs_ch * M, num_channels=M,
                            emit_spectrum=True, spectrum_nfft=1024)
    chain = ChannelizerChain(cfg)
    F = 16384  # channel-rate samples
    T = F * M
    fs = cfg.fs_in
    t = np.arange(T) / fs
    rng = np.random.default_rng(0)

    wide = 0.02 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    # AM / FM / CW signals on three channels, scaled to the channel count
    # (fixed indices broke --channels below 41 — caught by the examples
    # drift-guard test)
    ch_am, ch_fm, ch_cw = M // 6, M * 2 // 5, M * 5 // 8
    tt = np.arange(F) / fs_ch
    am = (1 + 0.8 * np.sin(2 * np.pi * 800.0 * tt)).astype(np.complex128)
    wide += np.repeat(am, M) * np.exp(2j * np.pi * (ch_am * fs_ch) * t) * 0.5
    fm_phase = 2 * np.pi * 2500.0 / fs_ch * np.cumsum(0.7 * np.sin(2 * np.pi * 400.0 * tt))
    wide += np.repeat(np.exp(1j * fm_phase), M) * np.exp(2j * np.pi * (ch_fm * fs_ch) * t) * 0.5
    key = (np.sin(2 * np.pi * 2.0 * tt) > 0).astype(np.float64)
    wide += np.repeat(key, M) * np.exp(2j * np.pi * (ch_cw * fs_ch) * t) * 0.4
    wide = wide.astype(np.complex64)

    mode = np.full(M, demod_op.SSB, np.int32)
    mode[ch_am] = demod_op.AM
    mode[ch_fm] = demod_op.NFM
    mode[ch_cw] = demod_op.CW
    st = chain.init_state()
    st, audio, aux = jax.jit(chain.step)(st, jnp.asarray(wide), jnp.asarray(mode))
    audio = np.asarray(audio)
    wf = np.asarray(aux["waterfall"])
    cp = 10 * np.log10(np.asarray(aux["channel_power"]) + 1e-12)

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8),
                                   gridspec_kw={"height_ratios": [3, 1]})
    ax1.imshow(wf, aspect="auto", origin="lower", cmap="viridis",
               extent=[-fs / 2e6, fs / 2e6, 0, wf.shape[0]])
    ax1.set_xlabel("MHz"); ax1.set_ylabel("time (frames)")
    ax1.set_title(f"wideband waterfall ({fs/1e6:.2f} Msps, {M} channels)")
    ax2.bar(np.arange(M), cp, width=0.9)
    ax2.set_xlabel("channel"); ax2.set_ylabel("power (dB)")
    for ch, name in [(ch_am, "AM"), (ch_fm, "NFM"), (ch_cw, "CW")]:
        ax2.annotate(name, (ch, cp[ch]), textcoords="offset points", xytext=(0, 5),
                     ha="center")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"waterfall -> {args.out}")
    print(f"channel powers (dB): AM ch{ch_am} {cp[ch_am]:.1f}, "
          f"NFM ch{ch_fm} {cp[ch_fm]:.1f}, "
          f"CW ch{ch_cw} {cp[ch_cw]:.1f}, noise floor {np.median(cp):.1f}")
    # the demodulated audio exists for every channel:
    print(f"audio matrix: {audio.shape} (channels x samples @ {fs_ch/1e3:.0f} kHz)")


if __name__ == "__main__":
    main()
