"""Config 5 core: PFB channelizer op, pipeline, and pod-sharded version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import jrun, jwrap

from radioframe.diag.metrics import audio_snr_db
from radioframe.golden import model as G
from radioframe.ops import demod as demod_op
from radioframe.ops import filter_design as FD
from radioframe.ops.pfb import PfbChannelizer
from radioframe.pipelines.channelizer import ChannelizerChain, ChannelizerConfig
from radioframe.shard.channelizer import ShardedChannelizer


def _wideband(rng, T):
    return (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)


class TestPfbOp:
    def test_vs_golden(self, rng):
        M, K = 16, 8
        op = PfbChannelizer(M, K)
        x = _wideband(rng, 64 * M)
        y, _ = jrun(lambda x: op(op.init_state(1), x), x[None, :])
        proto = FD.pfb_prototype_taps(M, K)
        ref = G.pfb_channelize(x.astype(np.complex128), M, proto)  # (F, M)
        np.testing.assert_allclose(np.asarray(y)[0], ref.T, atol=1e-4)

    def test_streaming(self, rng):
        M, K = 8, 4
        op = PfbChannelizer(M, K)
        x = _wideband(rng, 96 * M)
        whole, _ = jrun(lambda x: op(op.init_state(1), x), x[None, :])
        st = jrun(lambda: op.init_state(1))
        step = jwrap(op)
        outs = []
        for blk in np.split(x, 3):
            y, st = step(st, blk[None, :])
            outs.append(np.asarray(y))
        got = np.concatenate(outs, axis=-1)
        np.testing.assert_allclose(got, np.asarray(whole), atol=1e-5)

    def test_tone_channel_isolation(self, rng):
        M, K = 32, 8
        op = PfbChannelizer(M, K)
        fs = 32_000.0
        c = 11
        t = np.arange(64 * M) / fs
        x = np.exp(2j * np.pi * (c * fs / M) * t).astype(np.complex64)
        y, _ = jrun(lambda x: op(op.init_state(1), x), x[None, :])
        p = np.mean(np.abs(np.asarray(y)[0][:, K:]) ** 2, axis=-1)
        assert np.argmax(p) == c
        assert 10 * np.log10(p[c] / np.delete(p, c).max()) > 30.0


class TestChannelizerChain:
    def test_am_channel_demod(self):
        """AM signal at channel 37's center -> channel 37 demods the tone."""
        M = 64
        cfg = ChannelizerConfig(fs_in=64_000.0 * M, num_channels=M,
                                emit_spectrum=True, spectrum_nfft=1024)
        chain = ChannelizerChain(cfg)
        fs_ch = cfg.fs_channel  # 64 kHz
        F = 4096  # frames (channel-rate samples)
        T = F * M
        tt = np.arange(F) / fs_ch
        tone = 0.7 * np.sin(2 * np.pi * 1000.0 * tt)
        base = (1.0 + 0.8 * tone).astype(np.complex128)
        # upconvert the AM baseband to channel 37's center at wideband rate
        n = np.arange(T) / cfg.fs_in
        up = np.repeat(base, M)  # crude ZOH interpolation is fine within a channel
        wide = (up * np.exp(2j * np.pi * (37 * fs_ch) * n)).astype(np.complex64)
        mode = jnp.full((M,), demod_op.AM, jnp.int32)
        st = jrun(chain.init_state)
        st, audio, aux = jwrap(chain.step)(st, wide, mode)
        audio = np.asarray(audio)
        # channel 37 carries the tone
        snr = audio_snr_db(tone[512:], audio[37][512:], trim=128)
        assert snr > 15.0, f"channelized AM SNR {snr:.1f} dB"
        # channel power concentrated at 37
        cp = np.asarray(aux["channel_power"])
        assert np.argmax(cp) == 37
        assert aux["waterfall"].shape[-1] == 1024


class TestShardedChannelizer:
    @pytest.mark.parametrize("D", [2, 8])
    def test_matches_unsharded(self, rng, D):
        M = 64
        cfg = ChannelizerConfig(fs_in=64_000.0 * M, num_channels=M,
                                emit_spectrum=True, spectrum_nfft=512)
        chain = ChannelizerChain(cfg)
        mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
        sharded = ShardedChannelizer(chain, mesh)
        T = D * 16 * chain.min_block // 8
        wide = _wideband(rng, T)
        mode = jnp.asarray(np.arange(M) % 4, jnp.int32)

        st = jrun(chain.init_state)
        ref_st, ref_audio, ref_aux = jwrap(chain.step)(st, wide, mode)
        st2 = jrun(chain.init_state)
        got_st, got_audio, got_aux = jwrap(sharded.step)(st2, wide, mode)
        # skip the PFB warm-up (K-1 = 7 frames): near-zero partial-conv
        # output there makes NFM's arctan2 ill-conditioned under CPU-mesh
        # fp nondeterminism (see tests/test_sharded.py WARMUP note)
        W = chain.pfb.K
        np.testing.assert_allclose(np.asarray(got_audio)[:, W:],
                                   np.asarray(ref_audio)[:, W:], atol=2e-4)
        np.testing.assert_allclose(np.asarray(got_aux["waterfall"]),
                                   np.asarray(ref_aux["waterfall"]), atol=1e-2)
        np.testing.assert_allclose(np.asarray(got_st["agc"]["env"]),
                                   np.asarray(ref_st["agc"]["env"]), atol=2e-4)
        np.testing.assert_allclose(np.asarray(got_st["pfb"]), np.asarray(ref_st["pfb"]),
                                   atol=1e-5)

    @pytest.mark.slow
    def test_config5_full_scale_4096_channels(self, rng):
        """BASELINE config 5 at its TRUE scale: M=4096 channels on the
        8-device mesh, sharded == unsharded, plus per-channel AGC/demod and
        the wideband waterfall. Minimum legal block (T = 8 shards x 32768;
        halo (K-1)*M = 28672 <= T_loc = 32768)."""
        M, D = 4096, 8
        cfg = ChannelizerConfig(fs_in=61_440_000.0, num_channels=M,
                                emit_spectrum=True, spectrum_nfft=4096)
        chain = ChannelizerChain(cfg)
        mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
        sharded = ShardedChannelizer(chain, mesh)
        T = D * chain.min_block  # 262144 wideband samples, F=64 frames/channel
        wide = _wideband(rng, T)
        mode = jnp.asarray(np.arange(M) % 6, jnp.int32)  # all six modes in play

        st = jrun(chain.init_state)
        ref_st, ref_audio, ref_aux = jwrap(chain.step)(st, wide, mode)
        st2 = jrun(chain.init_state)
        got_st, got_audio, got_aux = jwrap(sharded.step)(st2, wide, mode)
        assert got_audio.shape == (M, T // M)
        W = chain.pfb.K  # PFB warm-up frames (see note above)
        np.testing.assert_allclose(np.asarray(got_audio)[:, W:],
                                   np.asarray(ref_audio)[:, W:], atol=2e-4)
        np.testing.assert_allclose(np.asarray(got_aux["channel_power"]),
                                   np.asarray(ref_aux["channel_power"]), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(got_aux["waterfall"]),
                                   np.asarray(ref_aux["waterfall"]), atol=1e-2)
        np.testing.assert_allclose(np.asarray(got_st["agc"]["env"]),
                                   np.asarray(ref_st["agc"]["env"]), atol=2e-4)

    def test_sharded_streaming(self, rng):
        """Multi-block streaming: pfb/demod/AGC carry handoff AND the EMA
        waterfall's cross-shard affine-scan completion, sharded == unsharded
        (VERDICT r2 ask #8)."""
        M, D = 32, 4
        cfg = ChannelizerConfig(fs_in=32_000.0 * M, num_channels=M,
                                emit_spectrum=True, spectrum_nfft=256,
                                spectrum_avg=0.7)
        chain = ChannelizerChain(cfg)
        mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
        sharded = ShardedChannelizer(chain, mesh)
        T = D * 2 * chain.min_block
        wide = _wideband(rng, 2 * T)
        mode = jnp.asarray(np.arange(M) % 4, jnp.int32)

        st = jrun(chain.init_state)
        ref, ref_wf = [], []
        step = jwrap(chain.step)
        for b in np.split(wide, 2):
            st, a, aux = step(st, b, mode)
            ref.append(np.asarray(a))
            ref_wf.append(np.asarray(aux["waterfall"]))
        ref_st = st
        ref = np.concatenate(ref, axis=-1)
        st = jrun(chain.init_state)
        got, got_wf = [], []
        sstep = jwrap(sharded.step)
        for b in np.split(wide, 2):
            st, a, aux = sstep(st, b, mode)
            got.append(np.asarray(a))
            got_wf.append(np.asarray(aux["waterfall"]))
        got = np.concatenate(got, axis=-1)
        W = chain.pfb.K  # PFB warm-up frames (see note above)
        np.testing.assert_allclose(got[:, W:], ref[:, W:], atol=2e-4)
        # EMA waterfall lines agree across the stream (block 2 depends on
        # block 1's carried EMA state — the handoff under sharding)
        np.testing.assert_allclose(np.concatenate(got_wf),
                                   np.concatenate(ref_wf), atol=1e-2)
        # end-of-stream state parity: every carried leaf
        np.testing.assert_allclose(np.asarray(st["pfb"]),
                                   np.asarray(ref_st["pfb"]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(st["spec"]),
                                   np.asarray(ref_st["spec"]), atol=1e-2)
        np.testing.assert_allclose(np.asarray(st["agc"]["env"]),
                                   np.asarray(ref_st["agc"]["env"]), atol=2e-4)


class TestPfbWaterfall:
    """waterfall_from_pfb: the PFB output IS the panorama (prototype-windowed
    periodogram); lines must localize tones correctly and shard exactly."""

    def test_tone_lands_in_its_bin(self, rng):
        M = 64
        cfg = ChannelizerConfig(fs_in=64_000.0 * M, num_channels=M,
                                emit_spectrum=True, waterfall_from_pfb=True,
                                waterfall_frame_avg=4)
        chain = ChannelizerChain(cfg)
        T = 8 * chain.min_block
        c = 11  # tone centered on channel 11 (+c*fs/M)
        t = np.arange(T) / cfg.fs_in
        wide = (np.exp(2j * np.pi * (c * cfg.fs_in / M) * t)
                + 0.01 * _wideband(rng, T)).astype(np.complex64)
        st = jrun(chain.init_state)
        assert st["spec"] == ()  # stateless waterfall: no dead leaf
        _, _, aux = jwrap(chain.step)(st, wide, 
                                        jnp.zeros((M,), jnp.int32))
        wf = np.asarray(aux["waterfall"])  # (F/avg, M) dB, low..high
        assert wf.shape == (T // M // 4, M)
        # lines are fftshift-rolled: channel c sits at column M//2 + c
        peak_col = int(np.argmax(wf[-1]))
        assert peak_col == (M // 2 + c) % M, (peak_col, M // 2 + c)
        assert wf[-1, peak_col] - np.median(wf[-1]) > 20.0  # tone >> floor

    def test_sharded_matches_unsharded(self, rng):
        M, D = 64, 4
        cfg = ChannelizerConfig(fs_in=64_000.0 * M, num_channels=M,
                                emit_spectrum=True, waterfall_from_pfb=True,
                                waterfall_frame_avg=4)
        chain = ChannelizerChain(cfg)
        mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
        sharded = ShardedChannelizer(chain, mesh)
        T = D * 2 * chain.min_block
        wide = _wideband(rng, T)
        mode = jnp.asarray(np.arange(M) % 4, jnp.int32)
        st = jrun(chain.init_state)
        _, ref_audio, ref_aux = jwrap(chain.step)(st, wide, mode)
        st2 = jrun(chain.init_state)
        _, got_audio, got_aux = jwrap(sharded.step)(st2, wide, mode)
        W = chain.pfb.K
        np.testing.assert_allclose(np.asarray(got_audio)[:, W:],
                                   np.asarray(ref_audio)[:, W:], atol=2e-4)
        np.testing.assert_allclose(np.asarray(got_aux["waterfall"]),
                                   np.asarray(ref_aux["waterfall"]), atol=1e-2)


class TestEnabledModes:
    def test_subset_matches_full_bank(self, rng):
        """Static mode-subset gating: channels using enabled modes produce
        identical audio to the full bank; disabled-mode states pass through."""
        M = 32
        full = ChannelizerConfig(fs_in=32_000.0 * M, num_channels=M,
                                 emit_spectrum=False)
        sub = ChannelizerConfig(fs_in=32_000.0 * M, num_channels=M,
                                emit_spectrum=False,
                                enabled_modes=(0, 1, 2, 3))
        mode = jnp.asarray(np.arange(M) % 4, jnp.int32)  # only modes 0-3 used
        wide = _wideband(rng, 4 * ChannelizerChain(full).min_block)
        outs = []
        for cfg in (full, sub):
            chain = ChannelizerChain(cfg)
            st = jrun(chain.init_state)
            st, audio, _ = jwrap(chain.step)(st, wide, mode)
            outs.append((np.asarray(audio), st))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        # disabled SAM's state untouched in the subset chain
        np.testing.assert_array_equal(
            np.asarray(outs[1][1]["demod"]["sam_carrier"]),
            np.zeros((2, M), np.float32))
