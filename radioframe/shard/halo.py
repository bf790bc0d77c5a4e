"""Halo exchange + cross-shard scan completion for time-sharded streams.

The centerpiece of the sharded design (SURVEY.md §2.3/§5): one contiguous
IQ stream is split across the mesh's ``time`` axis; causal filter state
(FIR/CIC tails) crosses shard boundaries as a neighbor ``ppermute`` halo, and
per-sample recursions (AGC envelope, DC blocker, FM phase) become
local associative scans finished by a tiny all-gather prefix across shards —
sequence parallelism for DSP state machines.

Layout convention inside shard_map: arrays are (C_local, T_local); the
``time`` mesh axis splits the last dim, shard d owning samples
[d*T_local, (d+1)*T_local) of the block. Block-to-block carry state is
replicated across the time axis (and sharded over ``channel``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from radioframe.ops.scans import affine_scan, maxdecay_scan

# 2x2 state-map products must stay float32: a GPU runs default-precision
# float32 contractions in TF32, which keeps about three decimal digits
_HIGHEST = lax.Precision.HIGHEST


def _wrap_perm(D):
    return [(i, (i + 1) % D) for i in range(D)]


def causal_halo(x_local, carry, H: int, axis: str = "time"):
    """Prepend each shard's left-neighbor tail (length H) to x_local.

    Shard 0 prepends ``carry`` (the previous block's global tail, replicated
    across the time axis); the value shard 0 receives from the wrap-around
    ppermute — the current block's global tail — becomes the next carry,
    broadcast back to all shards via a masked psum.

    Returns (x_with_halo (C, H+T_local), new_carry (C, H)).
    """
    if H == 0:
        return x_local, carry
    D = lax.axis_size(axis)
    d = lax.axis_index(axis)
    tail = x_local[..., -H:]
    if D == 1:
        return jnp.concatenate([carry, x_local], axis=-1), tail
    recv = lax.ppermute(tail, axis, _wrap_perm(D))
    is0 = (d == 0)
    prepend = jnp.where(is0, carry, recv)
    new_carry = lax.psum(jnp.where(is0, recv, jnp.zeros_like(recv)), axis)
    return jnp.concatenate([prepend, x_local], axis=-1), new_carry


def last_shard_value(x_last_local, axis: str = "time"):
    """Broadcast the last time-shard's value to all shards (replicated)."""
    D = lax.axis_size(axis)
    if D == 1:
        return x_last_local
    d = lax.axis_index(axis)
    mask = (d == D - 1)
    return lax.psum(jnp.where(mask, x_last_local, jnp.zeros_like(x_last_local)), axis)


def _shard_prefix_inputs(local_final, axis):
    """all_gather local aggregates -> (D, ...) array, plus this shard's index."""
    g = lax.all_gather(local_final, axis)  # (D, ...)
    return g, lax.axis_index(axis)


def _carry_chain(local_final, A, carry, axis, combine):
    """Generic cross-shard completion chain for a zero-seeded recursion.

    ``local_final`` (C,) is this shard's final value computed with a ZERO
    entering carry; ``A`` (scalar or (C,)) is the recursion's decay over
    one shard (a**T_local); ``combine(B_g, A*prev)`` folds the true
    entering value through one shard (affine: +, max-decay: max). Returns
    (my_in (C,), block_final (C,)): the TRUE value entering THIS shard and
    the carry leaving the block — identical on every shard (the D-length
    chain is recomputed redundantly from one all_gather; D is tiny)."""
    D = lax.axis_size(axis)
    if D == 1:
        return carry, combine(local_final, A * carry)
    B = lax.all_gather(local_final, axis)  # (D, C)
    d = lax.axis_index(axis)

    def body(j, ins):
        return ins.at[j + 1].set(combine(B[j], A * ins[j]))

    ins0 = jnp.zeros((D + 1,) + carry.shape, carry.dtype).at[0].set(carry)
    ins = lax.fori_loop(0, D, body, ins0)  # ins[D] = next block carry
    return ins[d], ins[D]


def affine_carry_chain(local_final, A, carry, axis: str = "time"):
    """Cross-shard chain for s[n] = a*s[n-1] + b[n] (see _carry_chain)."""
    return _carry_chain(local_final, A, carry, axis, lambda b, p: b + p)


def sharded_maxdecay_scan(a_const, v_local, carry, axis: str = "time",
                          a_table=None, a_index=None):
    """env[n] = max(a*env[n-1], v[n]) across the full time-sharded block.

    a_const: static scalar per-sample decay OR a (C,) per-channel decay
    array (e.g. per-mode AGC release constants). v_local (C, T_local);
    carry (C,) is the global env entering the block. Returns
    (env_local (C, T_local), new_carry (C,) replicated).

    ``a_table``: optional STATIC table the runtime coefficients are drawn
    from (e.g. the per-mode release table) — when the global-rescale bound
    holds for it at this T, the local scan uses the 3-4x-cheaper
    constant-coefficient cummax form (ops/scans.maxdecay_scan_const).
    ``a_index``: the integer index the coefficients were gathered with
    (a_const = a_table[a_index]); enables the transcendental-free
    decay-power build in the completion (decay_pows).
    """
    from radioframe.ops.scans import maxdecay_const_ok, maxdecay_scan_const

    C, T = v_local.shape
    ac = jnp.asarray(a_const, v_local.dtype)  # scalar or (C,)
    zero = jnp.zeros((C,), v_local.dtype)
    if a_table is not None and maxdecay_const_ok(a_table, T):
        a_ch = ac if ac.ndim else jnp.full((C,), ac, v_local.dtype)
        local_env = maxdecay_scan_const(a_ch, v_local, zero)
    else:
        a = jnp.broadcast_to(ac[..., None] if ac.ndim else ac, v_local.shape)
        local_env = maxdecay_scan(a, v_local, zero)  # scan from 0
    return sharded_maxdecay_complete(a_const, local_env, carry, axis,
                                     a_table=a_table, a_index=a_index)


def decay_pows(idx, a_table, T: int, dtype=jnp.float32):
    """(C, T) decay powers a_table[idx]**(1..T) with NO per-element
    transcendentals: the (n_vals, T) pow rows are host-precomputed from the
    small STATIC table (e.g. the per-mode AGC release constants) and
    selected by the INTEGER index the caller used to gather its
    coefficients — bit-exact by construction, no float matching (a
    float-value match would silently zero any off-table coefficient)."""
    import numpy as np

    tab = np.asarray(a_table, np.float64)
    pows = jnp.asarray(tab[:, None] ** (1 + np.arange(T))[None, :], dtype)
    out = jnp.zeros(idx.shape + (T,), dtype)
    for k in range(tab.shape[0]):
        out = jnp.where((idx == k)[..., None], pows[k], out)
    return out


def sharded_maxdecay_complete(a_const, local_env, carry, axis: str = "time",
                              a_table=None, a_index=None):
    """Complete a ZERO-SEEDED local max-decay envelope across shards.

    The completion tail of ``sharded_maxdecay_scan``. ``local_env`` (C, T_local) must be the env of
    the local samples scanned from a ZERO entering carry. ``a_table`` +
    ``a_index``: when the per-channel coefficients were gathered as
    a_table[a_index], the decay-power array is built transcendental-free
    from the static table (decay_pows). Returns (env, new_carry)."""
    C, T = local_env.shape
    ac = jnp.asarray(a_const, local_env.dtype)  # scalar or (C,)
    if a_table is not None and a_index is not None and ac.ndim:
        apow = decay_pows(a_index, a_table, T, local_env.dtype)
    else:
        apow = ac[..., None] ** (1 + jnp.arange(T, dtype=local_env.dtype))
    A = ac ** T
    my_in, fin = _carry_chain(local_env[:, -1], A, carry, axis, jnp.maximum)
    return jnp.maximum(local_env, my_in[..., None] * apow), fin


def sharded_biquad(bq, s0, x, axis: str = "time"):
    """One transposed-DF2 biquad section across the time-sharded block.

    Same 2x2 (matrix, vector) associative-scan formulation as
    ops/biquad.Biquad, completed across shards: all-gather each shard's
    total state map (A_prod, b_final), compose sequentially (D tiny) to get
    every shard's entering state, then finish locally.
    bq: ops.biquad.Biquad; s0 (C, 2) global entering state; x (C, T_loc)."""
    from radioframe.ops.biquad import _compose

    C, T = x.shape
    A = jnp.broadcast_to(jnp.asarray(bq.A), (C, T, 2, 2))
    bvec = x[..., None] * jnp.asarray(bq.B)  # (C, T, 2)
    As, bs = lax.associative_scan(_compose, (A, bvec), axis=1)
    D = lax.axis_size(axis)
    if D == 1:
        s = jnp.einsum("ctij,cj->cti", As, s0, precision=_HIGHEST) + bs
        s_prev = jnp.concatenate([s0[:, None, :], s[:, :-1, :]], axis=1)
        return bq.b0 * x + s_prev[..., 0], s[:, -1, :]
    Ag = lax.all_gather(As[:, -1], axis)  # (D, C, 2, 2)
    bg = lax.all_gather(bs[:, -1], axis)  # (D, C, 2)
    d = lax.axis_index(axis)

    def body(j, ins):
        nxt = jnp.einsum("cij,cj->ci", Ag[j], ins[j], precision=_HIGHEST) + bg[j]
        return ins.at[j + 1].set(nxt)

    ins0 = jnp.zeros((D + 1, C, 2), x.dtype).at[0].set(s0)
    ins = lax.fori_loop(0, D, body, ins0)
    my_in = ins[d]
    s = jnp.einsum("ctij,cj->cti", As, my_in, precision=_HIGHEST) + bs
    s_prev = jnp.concatenate([my_in[:, None, :], s[:, :-1, :]], axis=1)
    return bq.b0 * x + s_prev[..., 0], ins[D]


def sharded_biquad_cascade(cascade, state, x, axis: str = "time"):
    """ops/biquad.BiquadCascade across the time-sharded block."""
    new_states = []
    for bq, st in zip(cascade.sections, state):
        x, st2 = sharded_biquad(bq, st, x, axis)
        new_states.append(st2)
    return x, tuple(new_states)


def sharded_affine_scan(a_const, b_local, carry, axis: str = "time",
                        a_table=None):
    """s[n] = a*s[n-1] + b[n] across the time-sharded block.

    a_const: static scalar OR (C,) per-channel coefficient array.
    b_local (C, T_local); carry (C,). Returns (s_local, new_carry).

    ``a_table``: optional static coefficient table enabling the chunked
    triangular-matmul local form (ops/scans.affine_scan_const) when its
    rescale bound holds — same convention as sharded_maxdecay_scan."""
    from radioframe.ops.scans import affine_const_ok, affine_scan_const

    C, T = b_local.shape
    ac = jnp.asarray(a_const, b_local.dtype)  # scalar or (C,)
    apow = ac[..., None] ** (1 + jnp.arange(T, dtype=b_local.dtype))  # (T,) or (C,T)
    zero = jnp.zeros((C,), b_local.dtype)
    if a_table is not None and affine_const_ok(a_table):
        a_ch = ac if ac.ndim else jnp.full((C,), ac, b_local.dtype)
        local_s = affine_scan_const(a_ch, b_local, zero)
    else:
        a = jnp.broadcast_to(ac[..., None] if ac.ndim else ac, b_local.shape)
        local_s = affine_scan(a, b_local, zero)
    A = ac ** T
    my_in, fin = affine_carry_chain(local_s[:, -1], A, carry, axis)
    s = local_s + my_in[:, None] * apow
    return s, fin
