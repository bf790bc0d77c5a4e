"""Stage-pipelined executor (shard/pipeline.py) == sequential RxChain.

SURVEY.md §2.3 'stage pipelining' row: front half on device 0, back half on
device 1, decimated block crossing devices asynchronously. The pipeline must
be a pure re-scheduling — same audio, same final state.
"""

import jax
import jax.numpy as jnp
import numpy as np

from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.ops import nco
from radioframe.pipelines.rx_chain import RxChain
from radioframe.shard.pipeline import PipelinedRx

# Audio comparison skips the mode-filter warm-up transient in block 0 ONLY
# (same root cause as tests/test_sharded.py WARMUP note): during the first
# numtaps-1 = 512 audio samples the OLS bank emits a near-zero partial
# convolution, where cold-start AGC (envelope ~ 0 -> max gain) amplifies
# ~1e-7 fp-fusion differences between the separately-jitted front/back halves
# and the monolithic jit by ~1e7 (observed max 17.4 at t<=199; blocks 1-2
# agree to 3.6e-5). The executor is a pure re-scheduling; only the
# ill-conditioned cold-start region is excluded, tolerances are NOT widened.
WARMUP = 512  # == ModeFilters.numtaps - 1 at fs_audio


def _cfg():
    return RxConfig(
        fs_in=192_000.0,
        channels=4,
        stages=(CicStage(R=2, N=3), FirStage(R=2, numtaps=33, passband_hz=15_000.0)),
        ols_hop=256,
        emit_spectrum=True,
    )


def test_pipelined_matches_sequential(rng):
    chain = RxChain(_cfg())
    C, T = 4, 4 * chain.min_block
    n_blocks = 3
    words = jnp.asarray(nco.freq_word(np.linspace(-20e3, 20e3, C), chain.cfg.fs_in))
    mode = jnp.asarray([0, 1, 2, 3], jnp.int32)
    blocks = [
        jnp.asarray((rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
                    .astype(np.complex64))
        for _ in range(n_blocks)
    ]

    # sequential reference
    state = chain.init_state(C)
    step = jax.jit(chain.step)
    ref_audio = []
    for iq in blocks:
        state, audio, aux = step(state, iq, words, mode)
        ref_audio.append(np.asarray(audio))

    # pipelined across two devices
    devs = jax.devices()
    assert len(devs) >= 2, "test mesh must expose >= 2 devices (conftest)"
    pipe = PipelinedRx(chain, devs[0], devs[1])
    fstate, bstate = pipe.init_states(C)
    fstate, bstate, audios, auxes = pipe.run(fstate, bstate, blocks, words, mode)

    assert len(audios) == n_blocks
    for b, (got, want) in enumerate(zip(audios, ref_audio)):
        skip = WARMUP if b == 0 else 0  # cold-start transient, see module note
        # post-warm-up bound matches tests/test_sharded.py (2e-4): fp-fusion
        # differences between separately-jitted halves reach a few e-5.
        np.testing.assert_allclose(np.asarray(got)[:, skip:], want[:, skip:],
                                   atol=2e-4, rtol=1e-5)

    # final state identical too (front keys on dev A, back keys on dev B).
    # State leaves (AGC envelope/gain, carries) inherit the same few-e-5
    # fp-fusion noise as the audio, hence the matching 2e-4 bound.
    fref, bref = chain.split_state(state)
    for ref_leaf, got_leaf in zip(jax.tree.leaves(fref), jax.tree.leaves(fstate)):
        np.testing.assert_allclose(np.asarray(got_leaf), np.asarray(ref_leaf),
                                   atol=2e-4, rtol=1e-5)
    for ref_leaf, got_leaf in zip(jax.tree.leaves(bref), jax.tree.leaves(bstate)):
        np.testing.assert_allclose(np.asarray(got_leaf), np.asarray(ref_leaf),
                                   atol=2e-4, rtol=1e-5)

    # placement really is split: front state on dev 0, back state on dev 1
    assert all(d.devices() == {devs[0]} for d in jax.tree.leaves(fstate)
               if hasattr(d, "devices"))
    assert all(d.devices() == {devs[1]} for d in jax.tree.leaves(bstate)
               if hasattr(d, "devices"))


def test_pipelined_aux_matches(rng):
    chain = RxChain(_cfg())
    C, T = 4, 2 * chain.min_block
    words = jnp.asarray(nco.freq_word(np.full(C, 7e3), chain.cfg.fs_in))
    mode = jnp.zeros((C,), jnp.int32)
    iq = jnp.asarray((rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
                     .astype(np.complex64))

    state = chain.init_state(C)
    state, audio, aux = jax.jit(chain.step)(state, iq, words, mode)

    devs = jax.devices()
    pipe = PipelinedRx(chain, devs[0], devs[1])
    fstate, bstate = pipe.init_states(C)
    _, _, audios, auxes = pipe.run(fstate, bstate, [iq], words, mode)
    np.testing.assert_allclose(np.asarray(auxes[0]["power_in"]),
                               np.asarray(aux["power_in"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(auxes[0]["spectrum"]),
                               np.asarray(aux["spectrum"]), atol=2e-4, rtol=1e-5)
