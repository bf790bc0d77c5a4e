"""Triton front-end kernel (kernels/frontend.py) against the plain XLA front
end (nco.mix_down + FirDecimator), in interpret mode on the CPU; the choice
of kernel (kernels.frontend_for); the int16 ingest paths; and the chain and
the sharded chain with the kernel swapped in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import jrun, jwrap

from radioframe import kernels
from radioframe.core import presets
from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.kernels.frontend import TritonFrontend
from radioframe.ops import filter_design as FD
from radioframe.ops import nco
from radioframe.ops.fir import FirDecimator
from radioframe.pipelines.rx_chain import RxChain


def _iq(rng, C, T):
    return (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)


def _counts(rng, C, T):
    x = _iq(rng, C, T)
    cr = np.clip(np.round(np.real(x) * 32768.0), -32768, 32767).astype(np.int16)
    ci = np.clip(np.round(np.imag(x) * 32768.0), -32768, 32767).astype(np.int16)
    return cr, ci


def _taps(R, L):
    return (FD.cic_equivalent_taps(R, 4, 1) if L == 4 * (R - 1) + 1
            else FD.lowpass_taps(L, 0.4 / R, 1.0))


def _composed(taps1, R1, taps2, R2, words, blocks):
    """Plain XLA reference: mix_down, then one or two FirDecimators,
    streamed over ``blocks`` with state carried."""
    d1 = FirDecimator(taps1, R1)
    d2 = FirDecimator(taps2, R2) if taps2 is not None else None
    C = words.shape[0]

    def step(acc, t1, t2, b):
        m, acc = nco.mix_down(b, words, acc)
        y, t1 = d1(t1, m)
        if d2 is not None:
            y, t2 = d2(t2, y)
        return acc, t1, t2, y

    step = jwrap(step)
    acc = np.zeros(C, np.int32)
    t1 = jrun(lambda: d1.init_state(C))
    t2 = jrun(lambda: d2.init_state(C)) if d2 is not None else np.zeros(0)
    outs = []
    for b in blocks:
        acc, t1, t2, y = step(acc, t1, t2, b)
        outs.append(y)
    return np.concatenate(outs, -1), acc


def _kernel_stream(fe, words, blocks):
    step = jwrap(lambda s, b: fe.step(s, b, words, return_power=True))
    st = jrun(lambda: fe.init_state(words.shape[0]))
    outs, pows = [], []
    for b in blocks:
        st, y, pw = step(st, b)
        outs.append(y)
        pows.append(pw)
    return np.concatenate(outs, -1), st, pows


class TestFusedFrontend:
    @pytest.mark.parametrize("R,L,C,T", [
        (8, 29, 4, 2048),     # CIC(8,4)-equivalent taps
        (4, 97, 3, 1024),     # long FIR, odd channel count
        (2, 7, 128, 512),     # short taps, many channels
    ])
    def test_matches_composed_path(self, rng, R, L, C, T):
        """Single-stage mode (R2 = 1) == mix_down + one FirDecimator,
        streaming over three blocks with the raw tail carried."""
        taps = _taps(R, L)
        fe = TritonFrontend(taps, R, interpret=True)
        words = jnp.asarray(nco.freq_word(np.linspace(-0.3, 0.3, C) * 48e3, 192e3))
        blocks = np.split(_iq(rng, C, 3 * T), 3, axis=-1)
        want, acc = _composed(taps, R, None, 1, words, blocks)
        got, st, _ = _kernel_stream(fe, words, blocks)
        np.testing.assert_allclose(got, want, atol=3e-5)
        # DDS accumulators advance identically (bit-exact int32 wrap)
        np.testing.assert_array_equal(acc, st["acc"])

    @pytest.mark.parametrize("R2", [1, 2, 4, 5])
    def test_two_stage_matches_composed(self, rng, R2):
        """Both stages in one pass == mix_down + two FirDecimators; R2 = 1
        is single-stage mode, 5 shows the band matrix needs no power of two."""
        R1, C = 8, 3
        taps1 = _taps(R1, 29)
        taps2 = FD.lowpass_taps(33, 0.4 / R2, 1.0) if R2 > 1 else None
        fe = TritonFrontend(taps1, R1, taps2, R2, interpret=True)
        T = 1024 * R1 * R2 // 4
        words = jnp.asarray(nco.freq_word(np.linspace(-0.3, 0.3, C) * 5e5, 1.536e6))
        blocks = np.split(_iq(rng, C, 3 * T), 3, axis=-1)
        want, acc = _composed(taps1, R1, taps2, R2, words, blocks)
        got, st, _ = _kernel_stream(fe, words, blocks)
        np.testing.assert_allclose(got, want, atol=5e-5)
        np.testing.assert_array_equal(acc, st["acc"])

    @pytest.mark.parametrize("C", [1, 5, 13])
    def test_channel_counts(self, rng, C):
        """One program per channel: any channel count, with output tiles
        (M2 = 96) that are not a power of two in number."""
        taps1, taps2 = _taps(8, 29), FD.lowpass_taps(97, 0.1, 1.0)
        fe = TritonFrontend(taps1, 8, taps2, 4, interpret=True)
        T = 96 * 32
        words = jnp.asarray(nco.freq_word(np.linspace(-0.4, 0.4, C) * 5e5, 1.536e6))
        blocks = np.split(_iq(rng, C, 2 * T), 2, axis=-1)
        want, _ = _composed(taps1, 8, taps2, 4, words, blocks)
        got, _, _ = _kernel_stream(fe, words, blocks)
        np.testing.assert_allclose(got, want, atol=5e-5)

    def test_wideband_broadcast(self, rng):
        """(1, T) shared input fans out across per-channel NCO words inside
        the kernel, without a (C, T) copy."""
        taps1, taps2 = _taps(4, 13), FD.lowpass_taps(33, 0.2, 1.0)
        fe = TritonFrontend(taps1, 4, taps2, 2, interpret=True)
        C = 5
        words = jnp.asarray(nco.freq_word(np.linspace(1e3, 9e3, C), 192e3))
        x = _iq(rng, 1, 1024)
        want, _ = _composed(taps1, 4, taps2, 2, words, [np.repeat(x, C, axis=0)])
        got, st, pows = _kernel_stream(fe, words, [x])
        np.testing.assert_allclose(got, want, atol=3e-5)
        np.testing.assert_allclose(pows[0], np.full(C, np.sum(np.abs(x) ** 2)), rtol=1e-5)
        assert st["tail"].shape == (C, fe.tail_len)

    @pytest.mark.parametrize("name,R2,want", [
        ("flagship", 4, (32, 256, 256)),
        ("adc", 8, (16, 256, 64)),
    ])
    def test_tiles(self, name, R2, want):
        """Tile choice at the two measured shapes (PERF.md): the stage-2
        outputs per program with the fewest stage-1 positions each."""
        cfg = presets.wideband_1536k(1) if name == "flagship" else presets.adc_61m44(1)
        ch = RxChain(cfg)
        fe = TritonFrontend(ch._stage_taps[0], ch.decimators[0].R,
                            ch._stage_taps[1], ch.decimators[1].R)
        T = 8 * ch.min_block if name == "flagship" else ch.min_block
        assert fe.R2 == R2 and fe.tiles(T // fe.decim) == want

    def test_band_matrix(self):
        """B2[n, p] = h2[N1 - (TO - p) R2 - n]: each column holds the
        stage-2 taps, reversed, ending at its output's last input."""
        h2 = np.arange(1.0, 8.0)
        fe = TritonFrontend(_taps(2, 5), 2, h2, 3)
        TO, N1 = 4, 32
        b = fe.band(TO, N1)
        for p in range(TO):
            last = N1 - (TO - p) * 3
            np.testing.assert_array_equal(b[last - 6:last + 1, p], h2[::-1])
            assert np.count_nonzero(b[:, p]) == len(h2)


class TestInt16Ingest:
    """int16 ADC ingest: the kernel reads count planes with the 2**-15
    scale folded into its taps; the XLA path upcasts and scales."""

    def test_kernel_power_matches_mean_abs2(self, rng):
        """The kernel's per-tile power partials, summed in XLA, == the plain
        sum |x|^2 per channel."""
        fe = TritonFrontend(_taps(8, 29), 8, FD.lowpass_taps(97, 0.1, 1.0), 4,
                            interpret=True)
        C, T = 3, 4096
        words = jnp.asarray(nco.freq_word(np.zeros(C), 1.536e6))
        x = _iq(rng, C, T)
        _, _, pows = _kernel_stream(fe, words, [x])
        np.testing.assert_allclose(pows[0], np.sum(np.abs(x) ** 2, axis=-1), rtol=1e-5)

    def test_kernel_int16_matches_float_planes(self, rng):
        taps1, taps2 = _taps(8, 29), FD.lowpass_taps(97, 0.1, 1.0)
        f32 = TritonFrontend(taps1, 8, taps2, 4, interpret=True)
        i16 = TritonFrontend(taps1, 8, taps2, 4, input_scale=2.0 ** -15, interpret=True)
        C, T = 2, 4096
        cr, ci = _counts(rng, C, T)
        words = jnp.asarray(nco.freq_word(np.array([5e4, -2e5]), 1.536e6))
        _, y32, p32 = jrun(lambda a, b: f32.step_planes(
            f32.init_state(C), a.astype(jnp.float32) / 32768.0,
            b.astype(jnp.float32) / 32768.0, words, return_power=True), cr, ci)
        _, y16, p16 = jrun(lambda a, b: i16.step_planes(
            i16.init_state(C), a, b, words, return_power=True), cr, ci)
        np.testing.assert_allclose(y16, y32, atol=1e-6)
        np.testing.assert_allclose(p16 * 2.0 ** -30, p32, rtol=1e-5)

    def _chains(self):
        base = dict(fs_in=1_536_000.0, channels=4,
                    stages=(CicStage(R=8, N=4),
                            FirStage(R=4, numtaps=97, passband_hz=15_000.0)))
        return RxChain(RxConfig(**base)), RxChain(RxConfig(**base, int16_ingest=True))

    def test_streaming_matches_one_shot(self, rng):
        _, ch = self._chains()
        C = 4
        T = 2 * ch.min_block
        words = jnp.asarray(nco.freq_word(np.array([1e5, -1e5, 0.0, 2e5]), 1.536e6))
        mode = jnp.asarray([0, 1, 2, 3], jnp.int32)
        cr, ci = _counts(rng, C, 2 * T)
        step16 = jwrap(ch.step_i16)
        _, a_one, _ = step16(jrun(lambda: ch.init_state(C)), cr, ci, words, mode)
        s2 = jrun(lambda: ch.init_state(C))
        outs = []
        for b in range(2):
            s2, a, _ = step16(s2, cr[:, b * T:(b + 1) * T],
                              ci[:, b * T:(b + 1) * T], words, mode)
            outs.append(a)
        np.testing.assert_allclose(np.concatenate(outs, axis=-1), a_one, atol=2e-5)

    def test_xla_step_i16_matches_scaled_complex(self, rng):
        """The XLA int16 path == a chain without int16 ingest fed the same
        counts scaled by 2**-15 (the reference the chip smoke uses)."""
        ch32, ch16 = self._chains()
        assert ch16.frontend is None  # CPU: the plain XLA form
        C, T = 4, 2 * ch32.min_block
        words = jnp.asarray(nco.freq_word(np.array([5e4, -2e5, 3e5, 0.0]), 1.536e6))
        mode = jnp.asarray(np.arange(C) % 4, jnp.int32)
        cr, ci = _counts(rng, C, T)
        xq = (cr / 32768.0 + 1j * ci / 32768.0).astype(np.complex64)
        _, a32, aux32 = jrun(lambda x: ch32.step(ch32.init_state(C), x, words, mode), xq)
        _, a16, aux16 = jrun(lambda a, b: ch16.step_i16(ch16.init_state(C), a, b,
                                                        words, mode), cr, ci)
        np.testing.assert_allclose(a16, a32, atol=1e-5)
        np.testing.assert_allclose(aux16["power_in"], aux32["power_in"], rtol=1e-5)

    @pytest.mark.parametrize("wrong", ["complex_into_i16", "i16_into_complex"])
    def test_ingest_mismatch_rejected(self, rng, wrong):
        ch32, ch16 = self._chains()
        C, T = 4, ch32.min_block
        words = jnp.zeros((C,), jnp.int32)
        mode = jnp.zeros((C,), jnp.int32)
        cr, ci = _counts(rng, C, T)
        with pytest.raises(AssertionError, match="int16_ingest"):
            if wrong == "complex_into_i16":
                ch16.step(ch16.init_state(C), jnp.asarray(cr + 1j * ci), words, mode)
            else:
                ch32.step_i16(ch32.init_state(C), cr, ci, words, mode)


class TestKernelChoice:
    """kernels.frontend_for: the one place the front end is chosen."""

    @pytest.mark.parametrize("platform,preset,want", [
        ("gpu", "wideband_1536k", (8, 4)),
        ("gpu", "adc_61m44", (32, 8)),
        ("gpu", "capture_192k", (2, 2)),
        ("cpu", "wideband_1536k", None),
        ("METAL", "wideband_1536k", None),
    ])
    def test_presets(self, platform, preset, want):
        ch = RxChain(getattr(presets, preset)(1))
        fe = kernels.frontend_for(ch._stage_taps, [d.R for d in ch.decimators], platform)
        if want is None:
            assert fe is None
        else:
            assert (fe.R, fe.R2) == want and not fe.interpret

    def test_odd_first_stage_stays_xla(self):
        taps = FD.lowpass_taps(31, 0.1, 1.0)
        assert kernels.frontend_for([taps, taps], [3, 2], "gpu") is None

    def test_complex_second_stage_runs_single_stage(self):
        real = FD.lowpass_taps(31, 0.1, 1.0)
        cplx = FD.complex_bandpass_taps(31, 100.0, 900.0, 8000.0)
        fe = kernels.frontend_for([real, cplx], [4, 2], "gpu")
        assert fe.R == 4 and fe.h2 is None

    def test_int16_scale_folded(self):
        taps = FD.lowpass_taps(31, 0.1, 1.0)
        fe = kernels.frontend_for([taps], [4], "gpu", input_scale=2.0 ** -15)
        assert fe.input_scale == 2.0 ** -15
        np.testing.assert_allclose(fe.hp.sum(), taps.sum() * 2.0 ** -15, rtol=1e-6)

    def test_chain_on_cpu_uses_xla(self):
        ch = RxChain(presets.wideband_1536k(2))
        assert ch.frontend is None and ch.frontend_stages == 0
        assert len(ch.init_state(2)["decim"]) == 2


def _interpret_choice(monkeypatch):
    """Make chains built after this call take the kernel in interpret mode."""
    gpu_choice = kernels.frontend_for

    def choose(stage_taps, stage_R, platform, input_scale=1.0):
        fe = gpu_choice(stage_taps, stage_R, "gpu", input_scale)
        if fe is not None:
            fe.interpret = True
        return fe

    monkeypatch.setattr(kernels, "frontend_for", choose)


class TestChainWithKernel:
    @pytest.mark.parametrize("stages,fs_in", [
        ((CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)), 1_536_000.0),
        ((CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0),
          FirStage(R=2, numtaps=33, passband_hz=15_000.0)), 3_072_000.0),
    ])
    def test_chain_matches_xla(self, rng, monkeypatch, stages, fs_in):
        """RxChain with the kernel == RxChain on the XLA front end, over
        blocks with state carried (a third stage stays in XLA)."""
        base = dict(fs_in=fs_in, channels=3, stages=stages)
        ch_ref = RxChain(RxConfig(**base))
        _interpret_choice(monkeypatch)
        ch_k = RxChain(RxConfig(**base))
        assert ch_k.frontend_stages == 2
        assert len(ch_k.init_state(3)["decim"]) == len(stages) - 1
        C = 3
        words = jnp.asarray(nco.freq_word(np.array([5e4, -2e5, 3e5]), fs_in))
        mode = jnp.asarray([0, 1, 2], jnp.int32)
        s_ref, s_k = jrun(lambda: ch_ref.init_state(C)), jrun(lambda: ch_k.init_state(C))
        step_ref, step_k = jwrap(ch_ref.step), jwrap(ch_k.step)
        T = ch_ref.min_block
        for blk in range(3):
            x = _iq(rng, C, T)
            s_ref, a_ref, x_ref = step_ref(s_ref, x, words, mode)
            s_k, a_k, x_k = step_k(s_k, x, words, mode)
            np.testing.assert_allclose(x_k["power_in"], x_ref["power_in"], rtol=1e-5)
            if blk:  # mode-filter warm-up (see test_sharded.py)
                np.testing.assert_allclose(a_k, a_ref, atol=2e-4)
        np.testing.assert_array_equal(s_k["nco"], s_ref["nco"])

    def test_chain_int16_matches_xla(self, rng, monkeypatch):
        cfg = RxConfig(fs_in=1_536_000.0, channels=2, int16_ingest=True,
                       stages=(CicStage(R=8, N=4),
                               FirStage(R=4, numtaps=97, passband_hz=15_000.0)))
        ch_ref = RxChain(cfg)
        _interpret_choice(monkeypatch)
        ch_k = RxChain(cfg)
        assert ch_k.frontend.input_scale == 2.0 ** -15
        C, T = 2, 2 * ch_ref.min_block
        words = jnp.asarray(nco.freq_word(np.array([5e4, -2e5]), 1.536e6))
        mode = jnp.asarray([0, 3], jnp.int32)
        cr, ci = _counts(rng, C, T)
        _, a_ref, x_ref = jrun(lambda a, b: ch_ref.step_i16(ch_ref.init_state(C), a, b,
                                                            words, mode), cr, ci)
        _, a_k, x_k = jrun(lambda a, b: ch_k.step_i16(ch_k.init_state(C), a, b,
                                                      words, mode), cr, ci)
        np.testing.assert_allclose(a_k[:, 512:], a_ref[:, 512:], atol=2e-4)
        np.testing.assert_allclose(x_k["power_in"], x_ref["power_in"], rtol=1e-5)

    def test_sharded_matches_unsharded(self, rng, monkeypatch):
        """Kernel under a ('channel', 'time') mesh: raw halo + per-shard DDS
        offset == the unsharded kernel chain, across blocks."""
        from radioframe.shard.rx import ShardedRxChain

        _interpret_choice(monkeypatch)
        C = 4
        chain = RxChain(RxConfig(channels=C, ols_hop=512,
                                 stages=(CicStage(R=2, N=4), FirStage(R=2, numtaps=49))))
        assert chain.frontend_stages == 2
        mesh = jax.make_mesh((2, 2), ("channel", "time"), devices=jax.devices()[:4])
        sharded = ShardedRxChain(chain, mesh)
        T = 2 * chain.min_block
        words = jnp.asarray(nco.freq_word(np.linspace(-80e3, 80e3, C), 192e3))
        mode = jnp.asarray(np.arange(C) % 4, jnp.int32)
        st_r, st_s = chain.init_state(C), chain.init_state(C)
        step_r, step_s = jax.jit(chain.step), jax.jit(sharded.step)
        for blk in range(2):
            x = jnp.asarray(_iq(rng, C, T))
            st_r, a_r, _ = step_r(st_r, x, words, mode)
            st_s, a_s, _ = step_s(st_s, x, words, mode)
            skip = 512 if blk == 0 else 0
            np.testing.assert_allclose(np.asarray(a_s)[:, skip:],
                                       np.asarray(a_r)[:, skip:], atol=2e-4)
        np.testing.assert_array_equal(np.asarray(st_s["nco"]), np.asarray(st_r["nco"]))
        np.testing.assert_allclose(np.asarray(st_s["decim"][0]),
                                   np.asarray(st_r["decim"][0]), atol=1e-6)


@pytest.mark.card
def test_compiled_kernel_matches_xla(card, rng):
    """The kernel as compiled for the GPU == the plain XLA front end."""
    ch = RxChain(presets.wideband_1536k(8))
    assert ch.frontend is not None
    C, T = 8, 8 * ch.min_block
    words = jnp.asarray(nco.freq_word(np.linspace(-3e5, 3e5, C), 1.536e6))
    taps = ch._stage_taps
    x = _iq(rng, C, T)
    want, _ = _composed(taps[0], 8, taps[1], 4, words, [x])
    got, _, _ = _kernel_stream(ch.frontend, words, [x])
    np.testing.assert_allclose(got, want, atol=5e-5)
