"""Mesh construction helpers for one host's devices (SURVEY.md §2.4).

XLA's collectives are the backend (NCCL between the cards of a GPU host);
the mesh shape follows the algorithm, since every card reaches every other
at the same rate.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(channel: int = 1, time: int = 1, devices=None) -> Mesh:
    """Single-process ('channel', 'time') mesh over local devices."""
    devices = devices if devices is not None else jax.devices()
    n = channel * time
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    return jax.make_mesh((channel, time), ("channel", "time"), devices=devices[:n])


def place_state(state, specs, mesh):
    """device_put a state pytree onto its shard_map PartitionSpecs.

    Donation hygiene (VERDICT r3 ask #6): a donated input whose sharding
    differs from the executable's expected input sharding cannot be aliased
    — XLA emits "Some donated buffers were not usable" and every such leaf
    costs one avoidable copy of sharded state per step. Chains
    build their init state unsharded (single-device); calling this once
    before the first donated step makes every leaf aliasable.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, PartitionSpec))
    return jax.tree.map(jax.device_put, state, shardings)
