"""Demo: the Monitor API — every-channel receiver with checkpoint/resume.

Usage:
  python examples/monitor_demo.py                 # one device
  python examples/monitor_demo.py --mesh 4        # sharded over 4 devices
                                                  # (4 virtual devices when
                                                  # JAX runs on the CPU)

Synthesizes a wideband capture (AM tone + CW beacon over noise), drives it
through `api.monitor.Monitor` (BASELINE config 5's user surface) in two
halves with a checkpoint between them, restores into a FRESH Monitor, and
verifies the resumed stream is bit-exact — the `[U:settings.c]`
EEPROM-persistence analog for the channelizer's stream state (PFB history,
demod carries, AGC envelopes) plus the per-channel mode map.
"""

import argparse
import os
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over N devices")
    args = ap.parse_args()
    if args.mesh:
        # only the CPU platform reads this: N virtual devices there
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.mesh}")
    import jax
    import numpy as np

    from radioframe.api.monitor import Monitor
    from radioframe.core import presets

    M = args.channels
    fs = 15_000.0 * M
    cfg = presets.channelizer_61m44(M, fs_in=fs, waterfall_frame_avg=4)
    mesh = None
    if args.mesh:
        mesh = jax.make_mesh((args.mesh,), ("dev",),
                             devices=jax.devices()[: args.mesh])
    mon = Monitor(cfg, mesh=mesh)
    mon.set_mode_all("ssb")
    mon.set_mode(9, "am")
    mon.set_mode(23, "cw")

    # wideband: AM tone on channel 9, keyed CW on channel 23, noise floor
    rng = np.random.default_rng(7)
    blocks = max(2, 2 * (args.mesh or 1))
    T = blocks * mon.chain.min_block
    fs_ch = cfg.fs_channel
    t = np.arange(T) / fs
    f_audio = np.sin(2 * np.pi * 1000.0 * np.arange(T // M) / fs_ch)
    am = (1.0 + 0.8 * np.repeat(f_audio, M)) * np.exp(2j * np.pi * (9 * fs_ch) * t)
    key = (np.arange(T) // (T // 8)) % 2 == 0
    cw = 0.5 * key * np.exp(2j * np.pi * (23 * fs_ch + 600.0) * t)
    wide = (0.7 * am + cw + 0.02 * (rng.standard_normal(T)
            + 1j * rng.standard_normal(T))).astype(np.complex64)
    halves = np.split(wide, 2)

    a1 = mon.process(halves[0])
    with tempfile.TemporaryDirectory() as ck:
        mon.save(ck, epoch=1)
        a2 = mon.process(halves[1])

        # fresh Monitor restores mid-stream and continues bit-exactly
        mon2 = Monitor(cfg, mesh=mesh)
        assert mon2.load(ck) == 1
        assert mon2.mode(9) == "am" and mon2.mode(23) == "cw"
        b2 = mon2.process(halves[1])
    exact = np.array_equal(a2, b2)

    cp = mon.channel_power()
    top = np.argsort(cp)[::-1][:3]
    form = ("sharded single-pass (no all_to_all)" if mesh is not None
            else "single-pass kernel")
    print(f"monitor [{form}]: {M} channels x {a1.shape[1] + a2.shape[1]} "
          f"audio samples @ {fs_ch:.0f} Hz")
    for c in top:
        print(f"  ch {int(c):3d} ({mon.channel_frequency(int(c)):+9.0f} Hz, "
              f"{mon.mode(int(c)):>3s}): {10*np.log10(cp[c] + 1e-12):6.1f} dB")
    print(f"  checkpoint resume bit-exact: {exact}")
    assert int(top[0]) in (9, 23) and exact
    print("OK")


if __name__ == "__main__":
    main()
