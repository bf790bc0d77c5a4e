"""Aux subsystems: Radio API, checkpoint/resume (bit-exact), WAV I/O, snap."""

import numpy as np
import pytest

from radioframe.core.config import RxConfig
from radioframe.io import fixtures as FX
from radioframe.io.wav import read_wav, write_wav

FS = 192_000.0


class TestWav:
    def test_iq_round_trip(self, tmp_path, rng):
        iq = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
        p = str(tmp_path / "cap.wav")
        write_wav(p, iq, FS)
        back, fs = read_wav(p)
        assert fs == FS and back.dtype == np.complex64
        # 16-bit quantization: ~90 dB dynamic range, normalized scale
        g = np.vdot(back, iq).real / np.vdot(back, back).real
        err = iq - g * back
        assert 10 * np.log10(np.mean(np.abs(iq) ** 2) / np.mean(np.abs(err) ** 2)) > 55

    def test_mono(self, tmp_path, rng):
        a = rng.standard_normal(500).astype(np.float32) * 0.5
        p = str(tmp_path / "audio.wav")
        write_wav(p, a, 48_000.0)
        back, fs = read_wav(p)
        assert fs == 48_000.0 and back.ndim == 1 and not np.iscomplexobj(back)


class TestRadioApi:
    def test_tune_process_metrics(self):
        from radioframe.api.radio import Radio

        r = Radio(RxConfig(channels=2, emit_spectrum=True))
        iq, truth = FX.ssb_capture(FS, 8 * 4096, 37_000.0)
        r.tune(0, 37_000.0)
        r.set_mode(0, "ssb")
        r.tune(1, -15_000.0)
        r.set_mode(1, "nfm")
        audio = r.process(iq)
        assert audio.shape == (2, len(iq) // 4)
        m = r.metrics()
        assert "power_in" in m and m["power_in"].shape == (2,)
        wf = r.waterfall()
        assert wf is not None and wf.shape[0] == 2
        assert r.mode(1) == "nfm" and r.frequency(0) == 37_000.0

    def test_snap_retunes_to_carrier(self):
        from radioframe.api.radio import Radio

        # carrier at +20.3 kHz; tune 20.0 kHz; snap should pull within a bin
        n = 16 * 4096
        t = np.arange(n) / FS
        iq = np.exp(2j * np.pi * 20_300.0 * t).astype(np.complex64)
        r = Radio(RxConfig(channels=1, emit_spectrum=True))
        r.tune(0, 20_000.0)
        r.set_mode(0, "cw")
        r.process(iq)
        f = r.snap(0, search_hz=1000.0)
        bin_hz = 48_000.0 / r.config.spectrum_nfft
        assert abs(f - 20_300.0) <= bin_hz, f


class TestCheckpointResume:
    @pytest.mark.slow
    def test_bit_exact_stream_resume(self, tmp_path):
        from radioframe.api.radio import Radio

        iq, _ = FX.ssb_capture(FS, 4 * 8192, 37_000.0)
        blocks = np.split(iq, 4)

        r = Radio(RxConfig(channels=1))
        r.tune(0, 37_000.0)
        r.set_mode(0, "ssb")
        r.process(blocks[0])
        r.process(blocks[1])
        ckdir = str(tmp_path / "ck")
        r.save(ckdir, epoch=2)
        a3 = r.process(blocks[2])
        a4 = r.process(blocks[3])

        r2 = Radio(RxConfig(channels=1))
        assert r2.load(ckdir) == 2
        assert r2.frequency(0) == 37_000.0 and r2.mode(0) == "ssb"
        b3 = r2.process(blocks[2])
        b4 = r2.process(blocks[3])
        np.testing.assert_array_equal(a3, b3)
        np.testing.assert_array_equal(a4, b4)


class TestMonitorCheckpoint:
    """VERDICT r4 ask #7: config 5's stream state (PFB history, demod
    carries, AGC envelopes) + per-channel modes are resumable through the
    Monitor API, bit-exactly — mirrors TestCheckpointResume for Radio."""

    def _monitor(self):
        from radioframe.api.monitor import Monitor
        from radioframe.pipelines.channelizer import ChannelizerConfig

        M = 16
        return Monitor(ChannelizerConfig(
            fs_in=15_000.0 * M, num_channels=M, emit_spectrum=True,
            waterfall_from_pfb=True, spectrum_avg=0.0))

    def test_bit_exact_stream_resume(self, tmp_path, rng):
        m = self._monitor()
        M = m.num_channels
        T = 16 * m.chain.min_block
        wide = (rng.standard_normal(4 * T)
                + 1j * rng.standard_normal(4 * T)).astype(np.complex64)
        blocks = np.split(wide, 4)
        m.set_mode_all("am")
        m.set_mode(3, "nfm")
        m.process(blocks[0])
        m.process(blocks[1])
        ckdir = str(tmp_path / "ck")
        m.save(ckdir, epoch=2)
        a3 = m.process(blocks[2])
        wf3 = m.waterfall()
        a4 = m.process(blocks[3])

        m2 = self._monitor()
        assert m2.load(ckdir) == 2
        assert m2.mode(3) == "nfm" and m2.mode(0) == "am"
        b3 = m2.process(blocks[2])
        np.testing.assert_array_equal(a3, b3)
        np.testing.assert_array_equal(wf3, m2.waterfall())
        np.testing.assert_array_equal(a4, m2.process(blocks[3]))


class TestRadioOnMesh:
    def test_radio_with_sharded_backend(self):
        import jax

        from radioframe.api.radio import Radio

        mesh = jax.make_mesh((2, 4), ("channel", "time"), devices=jax.devices())
        r = Radio(RxConfig(channels=4), mesh=mesh)
        r.tune(0, 37_000.0)
        r.set_mode(0, "ssb")
        iq, truth = FX.ssb_capture(FS, 8 * r.chain.min_block, 37_000.0)
        audio = r.process(np.broadcast_to(iq, (4, len(iq))).copy())
        assert audio.shape == (4, len(iq) // 4)
        assert "power_in" in r.metrics()
        # must match the unsharded Radio exactly (post AGC warm-up)
        r2 = Radio(RxConfig(channels=4))
        r2.tune(0, 37_000.0)
        r2.set_mode(0, "ssb")
        ref = r2.process(np.broadcast_to(iq, (4, len(iq))).copy())
        np.testing.assert_allclose(audio[:, 512:], ref[:, 512:], atol=1e-3)


def test_capabilities_flags_provisional_digital_modes():
    """VERDICT r1 #8: the FT8/WSPR stand-in tables are user-visible."""
    from radioframe.api.radio import Radio
    from radioframe.core.config import RxConfig

    caps = Radio(RxConfig(channels=1)).capabilities()
    assert "ssb" in caps["modes"] and caps["ft8"] and caps["wspr"]
    assert caps["ft8_interop"].startswith("PROVISIONAL")
    assert caps["wspr_interop"].startswith("PROVISIONAL")


import jax.numpy as jnp  # noqa: E402


class TestCheckpointMigration:
    """settings.c-style schema versioning: older state layouts migrate
    forward on restore (core/checkpoint.py MIGRATIONS)."""

    def _chain(self):

        from radioframe.core.config import RxConfig
        from radioframe.ops import demod as demod_op
        from radioframe.ops import nco
        from radioframe.pipelines.rx_chain import RxChain

        chain = RxChain(RxConfig(channels=2, ols_hop=512))
        words = jnp.asarray(nco.freq_word(np.array([10e3, -20e3]), 192e3))
        mode = jnp.asarray([demod_op.SSB, demod_op.NFM], jnp.int32)
        return chain, words, mode

    def _forge_v1(self, state):
        """Round-1 layout: scalar AGC envelope, no deemph key."""
        old = dict(state)
        old["agc"] = np.asarray(state["agc"]["env"])
        old.pop("deemph")
        return old

    def test_versioned_v1_state_migrates(self, tmp_path, rng):
        import jax

        from radioframe.core.checkpoint import StreamCheckpointer

        from conftest import jrun, jwrap, to_host

        chain, words, mode = self._chain()
        iq = (rng.standard_normal((2, 2048)) +
              1j * rng.standard_normal((2, 2048))).astype(np.complex64)
        step = jwrap(chain.step)
        st, _, _ = step(jrun(lambda: chain.init_state(2)), iq, words, mode)

        ck = StreamCheckpointer(str(tmp_path / "ck"))
        ck.save(0, self._forge_v1(st), version=1)
        restored = to_host(ck.restore(0, jrun(lambda: chain.init_state(2))))
        # structure matches the current schema; migrated leaves preserved
        np.testing.assert_array_equal(np.asarray(restored["agc"]["env"]),
                                      np.asarray(st["agc"]["env"]))
        np.testing.assert_array_equal(np.asarray(restored["nco"]),
                                      np.asarray(st["nco"]))
        assert restored["deemph"] == () and restored["agc"]["hist"] == ()
        # the stream continues: migrated state == native state, bit-exact
        # (lpf is inert at instant attack)
        st2a, a, _ = step(st, iq, words, mode)
        st2b, b, _ = step(restored, iq, words, mode)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_unversioned_round1_checkpoint_migrates(self, tmp_path, rng):
        """Raw (pre-versioning) on-disk snapshots restore via the v1 path."""
        from radioframe.core.checkpoint import StreamCheckpointer, write_snapshot

        from conftest import jrun, jwrap

        chain, words, mode = self._chain()
        iq = (rng.standard_normal((2, 2048)) +
              1j * rng.standard_normal((2, 2048))).astype(np.complex64)
        st, _, _ = jwrap(chain.step)(jrun(lambda: chain.init_state(2)),
                                     iq, words, mode)
        ck = StreamCheckpointer(str(tmp_path / "ck"))
        # simulate a round-1 file: raw state, no version
        write_snapshot(ck._path(3), self._forge_v1(st), version=None)
        restored = ck.restore(3, jrun(lambda: chain.init_state(2)))
        np.testing.assert_array_equal(np.asarray(restored["agc"]["env"]),
                                      np.asarray(st["agc"]["env"]))

    def test_current_version_roundtrip_unchanged(self, tmp_path, rng):
        import jax

        from radioframe.core.checkpoint import StreamCheckpointer

        from conftest import jrun, jwrap, to_host

        chain, words, mode = self._chain()
        iq = (rng.standard_normal((2, 2048)) +
              1j * rng.standard_normal((2, 2048))).astype(np.complex64)
        st, _, _ = jwrap(chain.step)(jrun(lambda: chain.init_state(2)),
                                     iq, words, mode)
        ck = StreamCheckpointer(str(tmp_path / "ck"))
        ck.save(7, st)
        restored = to_host(ck.restore(7, jrun(lambda: chain.init_state(2))))
        for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
