"""Block streaming (double-buffer feed) + CLI end-to-end."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from conftest import jrun, jwrap

from radioframe.core.config import RxConfig
from radioframe.core.stream import BlockStream, wav_blocks
from radioframe.diag.metrics import audio_snr_db
from radioframe.diag.timing import StageTimer
from radioframe.io import fixtures as FX
from radioframe.io.wav import read_wav, write_wav
from radioframe.ops import demod as demod_op
from radioframe.ops import nco
from radioframe.pipelines.rx_chain import RxChain

FS = 192_000.0


class TestBlockStream:
    def test_stream_equals_oneshot(self):
        chain = RxChain(RxConfig(channels=1))
        iq, truth = FX.ssb_capture(FS, 8 * chain.min_block, 37_000.0)
        words = jnp.asarray([nco.freq_word(37_000.0, FS)], jnp.int32)
        mode = jnp.asarray([demod_op.SSB], jnp.int32)

        _, whole, _ = jrun(lambda iq, w, m: chain.step(
            chain.init_state(1), iq, w, m),
            iq[None, :].astype(np.complex64), words, mode)

        # device-resident state (complex leaves never cross the host)
        bs = BlockStream(chain.step, jax.jit(lambda: chain.init_state(1))(),
                         donate=False)
        outs, auxs = bs.run((b[None, :] for b in np.split(iq, 8)), words, mode)
        got = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        np.testing.assert_allclose(got[:, 512:], np.asarray(whole)[:, 512:], atol=2e-5)
        assert len(auxs) == 8

    def test_stage_timer(self):
        t = StageTimer()
        x = jnp.ones((128, 128))
        mul = jax.jit(lambda v: v * 2)
        with t.stage("mul", sync_on=mul(x)):
            y = mul(x)
        assert "mul" in t.report() and t.counts["mul"] == 1
        assert float(jnp.sum(y)) == 2 * 128 * 128


class TestCli:
    def test_rx_and_decode_cw(self, tmp_path):
        # make a CW capture WAV, demodulate via CLI, decode via CLI
        from radioframe.ops.decoders import cw_encode_envelope

        env = cw_encode_envelope("CQ TEST", FS, wpm=25.0)
        n = ((len(env) // 8192) + 1) * 8192
        env = np.pad(env, (0, n - len(env)))
        t = np.arange(n) / FS
        iq = (env * np.exp(2j * np.pi * 7_000.0 * t)).astype(np.complex64)
        cap = str(tmp_path / "cap.wav")
        out = str(tmp_path / "audio.wav")
        write_wav(cap, iq, FS, scale=0.5)

        cmd = [sys.executable, "-m", "radioframe.cli", "rx", "--wav", cap,
               "--freq", "7000", "--mode", "cw", "--out", out]
        p = subprocess.run(cmd, capture_output=True, text=True,
                           env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                                "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert p.returncode == 0, p.stderr[-2000:]
        assert "audio ->" in p.stdout

        p2 = subprocess.run([sys.executable, "-m", "radioframe.cli", "decode",
                             "--wav", out, "--tone", "600"],
                            capture_output=True, text=True,
                            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert p2.returncode == 0, p2.stderr[-2000:]
        assert "CQ TEST" in p2.stdout, p2.stdout

    def test_info(self):
        p = subprocess.run([sys.executable, "-m", "radioframe.cli", "info"],
                           capture_output=True, text=True,
                           env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                                "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert p.returncode == 0
        assert "default RX chain" in p.stdout


def test_cli_tx_roundtrip(tmp_path):
    """CLI tx: mono audio WAV -> IQ WAV at 4x rate; rx chain can receive it."""
    import numpy as np

    from radioframe.cli import main as cli_main
    from radioframe.io.wav import read_wav, write_wav

    fs = 48_000.0
    t = np.arange(4 * 2048) / fs
    audio = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    wav_in = str(tmp_path / "voice.wav")
    wav_out = str(tmp_path / "iq.wav")
    write_wav(wav_in, audio, fs)
    rc = cli_main(["tx", "--wav", wav_in, "--freq", "12000", "--mode", "am",
                   "--out", wav_out])
    assert rc == 0
    iq, fs_iq = read_wav(wav_out)
    assert fs_iq == 4 * fs and np.iscomplexobj(iq)
    # AM carrier is at +12 kHz: spectrum peak there
    X = np.abs(np.fft.fft(iq))
    f = np.fft.fftfreq(len(iq), 1.0 / fs_iq)
    assert abs(f[int(np.argmax(X))] - 12_000.0) < 50.0


class TestMonitorApi:
    """api/monitor.Monitor + presets.channelizer_61m44 + `radioframe
    monitor` (the config-5 dataflow's user surface, r4)."""

    def test_monitor_matches_chain(self):
        import jax
        import jax.numpy as jnp

        from radioframe.api.monitor import Monitor
        from radioframe.core import presets

        M = 64
        cfg = presets.channelizer_61m44(M, fs_in=M * 15_000.0)
        assert cfg.waterfall_from_pfb
        mon = Monitor(cfg)
        mon.set_mode_all("ssb")
        mon.set_mode(5, "am")
        assert mon.mode(5) == "am" and mon.mode(6) == "ssb"
        rng = np.random.default_rng(0)
        T = 2 * mon.chain.min_block
        wide = (rng.standard_normal(T)
                + 1j * rng.standard_normal(T)).astype(np.complex64)
        audio = mon.process(wide)
        assert audio.shape == (M, T // M)
        assert mon.waterfall() is not None
        assert mon.channel_power().shape == (M,)
        # parity vs driving the chain directly
        from radioframe.pipelines.channelizer import ChannelizerChain

        chain = ChannelizerChain(cfg)
        mode = np.full(M, 0, np.int32)
        mode[5] = 2
        _, a_ref, _ = jrun(lambda w, m: chain.step(chain.init_state(), w, m),
                           wide, mode)
        np.testing.assert_array_equal(audio, np.asarray(a_ref))

    def test_monitor_sharded(self):
        import jax
        import jax.numpy as jnp

        from radioframe.api.monitor import Monitor
        from radioframe.core import presets

        M, D = 64, 4
        cfg = presets.channelizer_61m44(M, fs_in=M * 15_000.0,
                                        waterfall_frame_avg=4)
        mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
        mon = Monitor(cfg, mesh=mesh)
        mon.set_mode_all("nfm")
        rng = np.random.default_rng(1)
        T = D * 2 * mon.chain.min_block
        wide = (rng.standard_normal(T)
                + 1j * rng.standard_normal(T)).astype(np.complex64)
        audio = mon.process(wide)
        assert audio.shape == (M, T // M)

    def test_cli_monitor(self, tmp_path):
        from radioframe.cli import main
        from radioframe.io.wav import write_wav

        M = 32
        fs = M * 15_000.0
        rng = np.random.default_rng(2)
        # a tone at channel 7's center over a noise floor
        T = 32 * M * 8
        n = np.arange(T) / fs
        wide = (0.5 * np.exp(2j * np.pi * (7 * 15_000.0) * n)
                + 0.01 * (rng.standard_normal(T)
                          + 1j * rng.standard_normal(T))).astype(np.complex64)
        wav = tmp_path / "wide.wav"
        write_wav(str(wav), wide, fs)
        out = tmp_path / "ch7.wav"
        wf = tmp_path / "wf.npy"
        rc = main(["monitor", "--wav", str(wav), "--channels", str(M),
                   "--mode", "am", "--channel", "7",
                   "--audio-out", str(out), "--waterfall", str(wf)])
        assert rc == 0
        assert out.exists() and wf.exists()
        assert np.load(wf).shape[-1] == M
