"""Config-5 properties on the dense channelizer path: every AGC profile
sharded equal to unsharded across mesh sizes, streaming equal to one-shot,
static mode subsets including LSB, and one state tree for every D."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import jrun, jwrap

from radioframe.core.config import AgcConfig
from radioframe.pipelines.channelizer import ChannelizerChain, ChannelizerConfig
from radioframe.shard.channelizer import ShardedChannelizer

M = 64

PROFILES = {
    "release": None,
    "attack": (
        AgcConfig(release_s=0.5, attack_s=0.002),   # SSB
        AgcConfig(release_s=0.25, attack_s=0.001),  # CW
        AgcConfig(release_s=0.8, attack_s=0.005),   # AM
        AgcConfig(),                                # NFM (bypassed)
        AgcConfig(release_s=0.5, attack_s=0.002),   # LSB
        AgcConfig(release_s=0.8, attack_s=0.005),   # SAM
    ),
    "hang": (
        AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.01),
        AgcConfig(release_s=0.25, hang_s=0.005),
        AgcConfig(release_s=0.8, attack_s=0.005, hang_s=0.02),
        AgcConfig(),
        AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.01),
        AgcConfig(release_s=0.8, hang_s=0.02),
    ),
}


def _chain(profile, **kw):
    base = dict(fs_in=15_000.0 * M, num_channels=M, emit_spectrum=True,
                waterfall_from_pfb=True, waterfall_frame_avg=4,
                enabled_modes=(0, 1, 2, 3), agc_modes=PROFILES[profile])
    base.update(kw)
    return ChannelizerChain(ChannelizerConfig(**base))


def _wideband(seed, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)


def _mode(modes=(0, 1, 2, 3)):
    return jnp.asarray(np.asarray(modes, np.int32)[np.arange(M) % len(modes)])


def _sharded(chain, D):
    mesh = jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D])
    return ShardedChannelizer(chain, mesh)


def _block(chain):
    return 16 * chain.min_block  # 8 shards of 2 min blocks: the same input for every D


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("profile", ["release", "attack", "hang"])
def test_sharded_matches_unsharded(profile, D):
    chain = _chain(profile)
    wide = _wideband(1, _block(chain))
    st_u, a_u, x_u = jwrap(chain.step)(jrun(chain.init_state), wide, _mode())
    st_s, a_s, x_s = jwrap(_sharded(chain, D).step)(jrun(chain.init_state), wide, _mode())
    K = chain.pfb.K  # PFB warm-up frames
    np.testing.assert_allclose(a_s[:, K:], a_u[:, K:], atol=2e-4)
    np.testing.assert_allclose(x_s["waterfall"], x_u["waterfall"], atol=1e-2)
    for leaf in ("env", "lpf"):
        np.testing.assert_allclose(st_s["agc"][leaf], st_u["agc"][leaf], atol=2e-4)


@pytest.mark.parametrize("profile", ["release", "attack", "hang"])
def test_streaming_matches_one_shot(profile):
    chain = _chain(profile)
    T = _block(chain)
    wide = _wideband(2, 2 * T)
    step = jwrap(chain.step)
    st_one, a_one, _ = step(jrun(chain.init_state), wide, _mode())
    st = jrun(chain.init_state)
    outs = []
    for b in np.split(wide, 2):
        st, a, _ = step(st, b, _mode())
        outs.append(a)
    K = chain.pfb.K
    np.testing.assert_allclose(np.concatenate(outs, -1)[:, K:], a_one[:, K:], atol=2e-4)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st_one)):
        np.testing.assert_allclose(a, b, atol=2e-4)


@pytest.mark.parametrize("subset", [(0, 4), (4,), (1, 3, 4), (0, 1, 2, 3, 4)])
def test_mode_subset_matches_full_bank(subset):
    """Channels whose modes are all enabled give the full bank's audio;
    subsets with LSB (mode 4) included."""
    full = _chain("release", enabled_modes=None)
    sub = _chain("release", enabled_modes=subset)
    wide = _wideband(3, 4 * full.min_block)
    mode = _mode(subset)
    _, a_full, _ = jrun(lambda w, m: full.step(full.init_state(), w, m), wide, mode)
    st, a_sub, _ = jrun(lambda w, m: sub.step(sub.init_state(), w, m), wide, mode)
    np.testing.assert_allclose(a_sub, a_full, atol=1e-6)
    # disabled SAM's state passes through untouched
    np.testing.assert_array_equal(st["demod"]["sam_carrier"], np.zeros((2, M), np.float32))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_state_tree_matches_across_mesh_sizes(D):
    """One state tree for every mesh size: the sharded chain's state has the
    unsharded chain's structure, shapes and values (hang history included),
    so checkpoints interoperate across D."""
    chain = _chain("hang")
    wide = _wideband(4, _block(chain))
    st_u, _, _ = jwrap(chain.step)(jrun(chain.init_state), wide, _mode())
    st_s, _, _ = jwrap(_sharded(chain, D).step)(jrun(chain.init_state), wide, _mode())
    assert jax.tree.structure(st_s) == jax.tree.structure(st_u)
    assert chain.agc_bank.hist_len > 0 and st_s["agc"]["hist"].shape == (M, chain.agc_bank.hist_len)
    for a, b in zip(jax.tree.leaves(st_s), jax.tree.leaves(st_u)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=2e-4)
