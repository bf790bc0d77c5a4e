"""Config 3: sharded DDC with halo exchange (SURVEY.md §4.2 #4/#5).

The sharded chain on a faked 8-device CPU mesh must reproduce the unsharded
chain bit-near-exactly: same block, any mesh split (channel x time), and
across multi-block streaming (carry handoff through halos)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from radioframe.core.config import RxConfig
from radioframe.ops import demod as demod_op
from radioframe.ops import nco
from radioframe.pipelines.rx_chain import RxChain
from radioframe.shard.rx import ShardedRxChain

FS = 192_000.0

# Audio-sample comparison starts AFTER the mode-filter warm-up transient.
#
# Root cause of the (former) order-dependent flake in
# test_sharded_streaming_matches_unsharded, established by a 12-run probe
# (2026-08-20): XLA:CPU execution of the 8-virtual-device mesh is NOT
# run-to-run fp-deterministic — concurrent per-device programs share the
# host thread pool and intra-op work partitioning varies, so the sharded
# audio differs between runs at the few-ulp level (the unsharded chain is
# bitwise stable). Those ulps are harmless everywhere except the first
# numtaps-1 = 512 audio samples, where the OLS bank's output is a
# near-zero partial-convolution transient: NFM's arctan2 and AM's
# envelope+DC-block are ill-conditioned there and amplify ulp noise to
# O(1) flips (observed: err 16.3 at t<=128 on an NFM channel; post-512
# max over 12 runs = 4.5e-5). Skipping the warm-up removes the
# ill-conditioned region entirely — the post-warm-up tolerance is
# TIGHTENED vs the old test (5e-4 -> 2e-4), not widened.
WARMUP = 512  # == ModeFilters.numtaps - 1 at fs_audio


def _mk(mesh_shape, C=8, emit_spectrum=False):
    chain = RxChain(RxConfig(channels=C, ols_hop=512, emit_spectrum=emit_spectrum))
    devs = jax.devices()[: mesh_shape[0] * mesh_shape[1]]
    mesh = jax.make_mesh(mesh_shape, ("channel", "time"), devices=devs)
    return chain, ShardedRxChain(chain, mesh)


def _inputs(chain, C, blocks=1, seed=0):
    rng = np.random.default_rng(seed)
    T = blocks * 8 * chain.min_block  # 8 time shards max -> T_local >= min_block
    iq = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    words = jnp.asarray(nco.freq_word(np.linspace(-80e3, 80e3, C), FS))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)
    return jnp.asarray(iq), words, mode


@pytest.mark.parametrize("mesh_shape", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_sharded_matches_unsharded_single_block(mesh_shape):
    C = 8
    chain, sharded = _mk(mesh_shape, C)
    iq, words, mode = _inputs(chain, C)
    st = chain.init_state(C)
    ref_state, ref_audio, ref_aux = jax.jit(chain.step)(st, iq, words, mode)
    st2 = chain.init_state(C)
    got_state, got_audio, got_aux = jax.jit(sharded.step)(st2, iq, words, mode)
    np.testing.assert_allclose(np.asarray(got_audio)[:, WARMUP:],
                               np.asarray(ref_audio)[:, WARMUP:], atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_aux["power_in"]),
                               np.asarray(ref_aux["power_in"]), rtol=1e-5)
    # carried state must agree (it feeds the next block)
    for name in ("nco", "bpf"):
        np.testing.assert_allclose(np.asarray(got_state[name]), np.asarray(ref_state[name]),
                                   atol=2e-4, err_msg=name)
    for name in ("env", "lpf", "hist"):
        np.testing.assert_allclose(np.asarray(got_state["agc"][name]),
                                   np.asarray(ref_state["agc"][name]),
                                   atol=2e-4, err_msg=f"agc.{name}")
    for a, b in zip(got_state["decim"], ref_state["decim"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_sharded_streaming_matches_unsharded():
    C = 8
    chain, sharded = _mk((2, 4), C)
    iq, words, mode = _inputs(chain, C, blocks=3)
    blocks = np.split(np.asarray(iq), 3, axis=-1)

    st = chain.init_state(C)
    ref = []
    step = jax.jit(chain.step)
    for b in blocks:
        st, a, _ = step(st, jnp.asarray(b), words, mode)
        ref.append(np.asarray(a))
    ref = np.concatenate(ref, axis=-1)

    st = chain.init_state(C)
    got = []
    sstep = jax.jit(sharded.step)
    for b in blocks:
        st, a, _ = sstep(st, jnp.asarray(b), words, mode)
        got.append(np.asarray(a))
    got = np.concatenate(got, axis=-1)
    np.testing.assert_allclose(got[:, WARMUP:], ref[:, WARMUP:], atol=2e-4)


def test_sharded_spectrum_output():
    C = 8
    chain, sharded = _mk((2, 4), C, emit_spectrum=True)
    iq, words, mode = _inputs(chain, C)
    st = chain.init_state(C)
    _, _, ref_aux = jax.jit(chain.step)(st, iq, words, mode)
    st2 = chain.init_state(C)
    _, _, got_aux = jax.jit(sharded.step)(st2, iq, words, mode)
    np.testing.assert_allclose(np.asarray(got_aux["spectrum"]),
                               np.asarray(ref_aux["spectrum"]), atol=1e-2)


def test_explicit_device_placement():
    """Inputs/state explicitly placed with shardings still work end to end."""
    C = 8
    chain, sharded = _mk((2, 4), C)
    iq, words, mode = _inputs(chain, C)
    mesh = sharded.mesh
    iq = jax.device_put(iq, NamedSharding(mesh, P("channel", "time")))
    words = jax.device_put(words, NamedSharding(mesh, P("channel")))
    mode = jax.device_put(mode, NamedSharding(mesh, P("channel")))
    st = chain.init_state(C)
    _, audio, _ = jax.jit(sharded.step)(st, iq, words, mode)
    assert audio.shape == (C, iq.shape[-1] // chain.cfg.decim)


def test_sharded_with_fighters_and_ema_spectrum():
    """NB+NR+notch+VAD and EMA waterfall all shard: sharded == unsharded."""
    C = 4
    cfg = RxConfig(channels=C, ols_hop=512, emit_spectrum=True, spectrum_avg=0.7,
                   nb_enabled=True, nr_enabled=True, notch_enabled=True,
                   vad_enabled=True)
    chain = RxChain(cfg)
    mesh = jax.make_mesh((2, 4), ("channel", "time"), devices=jax.devices())
    sharded = ShardedRxChain(chain, mesh)
    rng = np.random.default_rng(7)
    T = 8 * chain.min_block
    iq = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    words = jnp.asarray(nco.freq_word(np.linspace(-50e3, 50e3, C), FS))
    mode = jnp.asarray(np.arange(C) % 4, jnp.int32)

    st = chain.init_state(C)
    ref_st, ref_audio, ref_aux = jax.jit(chain.step)(st, jnp.asarray(iq), words, mode)
    st2 = chain.init_state(C)
    got_st, got_audio, got_aux = jax.jit(sharded.step)(st2, jnp.asarray(iq), words, mode)
    np.testing.assert_allclose(np.asarray(got_audio)[:, WARMUP:],
                               np.asarray(ref_audio)[:, WARMUP:], atol=2e-4)
    # NB blanking decisions near the 6-sigma threshold can flip under fp
    # reassociation, nudging individual spectrum bins — compare statistically
    dspec = np.abs(np.asarray(got_aux["spectrum"]) - np.asarray(ref_aux["spectrum"]))
    assert np.mean(dspec > 0.06) < 0.01 and dspec.max() < 1.0, (np.mean(dspec > 0.06), dspec.max())
    np.testing.assert_allclose(np.asarray(got_st["nr"]), np.asarray(ref_st["nr"]), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(got_st["vad"]), np.asarray(ref_st["vad"]), rtol=2e-3)
    # per-frame voice flags identical (booleans; threshold flips would show)
    np.testing.assert_array_equal(np.asarray(got_aux["vad_active"]),
                                  np.asarray(ref_aux["vad_active"]))
    np.testing.assert_allclose(np.asarray(got_st["notch"]), np.asarray(ref_st["notch"]), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(got_st["nb"]), np.asarray(ref_st["nb"]), rtol=5e-3)
    dsp = np.abs(np.asarray(got_st["spec"]) - np.asarray(ref_st["spec"]))
    assert np.mean(dsp > 0.06) < 0.01 and dsp.max() < 1.0


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_biquad_full_precision(D):
    """Sharded biquad cascade (NFM de-emphasis, pole near |z| = 1) == the
    unsharded cascade at float32 tolerance, and every contraction in the
    sharded program asks for HIGHEST precision: a default-precision einsum
    runs in TF32 on a GPU, which this tolerance would not admit."""
    from jax.sharding import PartitionSpec as P

    from radioframe.ops import filter_design as FD
    from radioframe.ops.biquad import BiquadCascade
    from radioframe.shard.halo import sharded_biquad_cascade

    casc = BiquadCascade(FD.deemphasis_sos(531e-6, 48_000.0))
    C, T = 4, 4096
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))
    s0 = casc.init_state(C)
    want, want_st = jax.jit(casc)(s0, x)
    mesh = jax.make_mesh((D,), ("time",), devices=jax.devices()[:D])
    fn = jax.shard_map(lambda st, v: sharded_biquad_cascade(casc, st, v, "time"),
                       mesh=mesh, in_specs=(P(), P(None, "time")),
                       out_specs=(P(None, "time"), P()), check_vma=False)
    got, got_st = jax.jit(fn)(s0, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(got_st), jax.tree.leaves(want_st)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    text = str(jax.make_jaxpr(fn)(s0, x))
    n_dots = text.count("dot_general")
    assert n_dots > 0 and text.count("precision=(Precision.HIGHEST, Precision.HIGHEST)") >= n_dots
