"""Stream-state checkpoint/resume (SURVEY.md §5 checkpoint row).

Reference analog: `[U:settings.c]` versioned EEPROM persistence + watchdog
recovery. Here the full DSP ``ChainState`` pytree (NCO phase accumulators,
FIR/CIC tails, AGC envelopes, demod states) snapshots at block-epoch
boundaries; restoring yields bit-exact stream continuation (tested in
tests/test_api_aux.py and tests/test_fault.py). On multi-host failure the driver restarts from
the last epoch (SURVEY.md §5 failure-detection row).

On disk an epoch is a directory holding ``arrays.npz`` (every leaf, by
position) and ``tree.json`` (the nesting of dicts and tuples, plus the
schema version), so a snapshot restores with numpy alone and older layouts
can be walked and migrated without a template.
"""

from __future__ import annotations

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np

# State-schema version, bumped when the ChainState pytree layout changes —
# the analog of the reference's versioned settings struct whose loader
# migrates older EEPROM layouts (`[U:settings.c]`). v1 = round-1 layout
# (scalar AGC envelope, no deemph/eq keys); v2 = round-2 (AgcBank
# {hist, env, lpf} dict, deemph/eq feature keys).
CURRENT_VERSION = 2


def _migrate_v1_to_v2(state):
    """Round-1 -> round-2 layout for default-config chains.

    - RX 'agc' scalar envelope -> AgcBank {hist: (), env, lpf: 0} (lpf is
      inert at the v1-default instant attack, so zeros resume bit-exactly)
    - RX gains 'deemph': (), TX gains 'eq': () (features default-disabled).
    """
    def walk(d):
        if not isinstance(d, dict):
            return d
        d = {k: walk(v) for k, v in d.items()}
        if "agc" in d and not isinstance(d["agc"], dict):
            env = np.asarray(d["agc"])
            d["agc"] = {"hist": (), "env": env, "lpf": np.zeros_like(env)}
            d.setdefault("deemph", ())
        if "comp" in d and "ssb" in d:  # a TxChain state
            d.setdefault("eq", ())
        return d

    return walk(state)


MIGRATIONS = {1: _migrate_v1_to_v2}


def _encode(tree, arrays):
    """Pytree of dicts/tuples/lists/arrays -> JSON nesting; leaves appended
    to ``arrays`` and referenced by position."""
    if isinstance(tree, dict):
        return {"dict": {k: _encode(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"seq": [_encode(v, arrays) for v in tree]}
    arrays.append(np.asarray(tree))
    return {"leaf": len(arrays) - 1}


def _decode(node, arrays):
    if "dict" in node:
        return {k: _decode(v, arrays) for k, v in node["dict"].items()}
    if "seq" in node:
        return tuple(_decode(v, arrays) for v in node["seq"])
    return arrays[f"a{node['leaf']}"]


def write_snapshot(path: str, tree, version: int | None = CURRENT_VERSION) -> str:
    """Write ``tree`` under ``path``; ``version=None`` writes an unversioned
    (round-1 style) snapshot."""
    os.makedirs(path, exist_ok=True)
    arrays = []
    meta = {"tree": _encode(jax.device_get(tree), arrays)}
    if version is not None:
        meta["version"] = int(version)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(meta, f)
    return path


def read_snapshot(path: str):
    """(version, tree) from ``path``; unversioned snapshots read as v1."""
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        tree = _decode(meta["tree"], arrays)
    return int(meta.get("version", 1)), tree


class StreamCheckpointer:
    """Epoch-numbered state snapshots under a directory, schema-versioned."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:012d}")

    def save(self, epoch: int, state, version: int = CURRENT_VERSION) -> str:
        return write_snapshot(self._path(epoch), state, version)

    def epochs(self):
        pat = re.compile(r"^epoch_(\d{12})$")
        out = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_epoch(self):
        eps = self.epochs()
        return eps[-1] if eps else None

    def restore(self, epoch: int, like, migrations=None):
        """Restore epoch's state with the structure and dtypes of ``like``.

        Older-schema checkpoints (including unversioned round-1 snapshots)
        are migrated forward through ``MIGRATIONS`` before matching against
        ``like`` — settings.c-style version migration.
        """
        v, st = read_snapshot(self._path(epoch))
        migrations = MIGRATIONS if migrations is None else migrations
        while v < CURRENT_VERSION:
            if v not in migrations:
                raise ValueError(f"no migration from state-schema v{v}")
            st = migrations[v](st)
            v += 1
        leaves = jax.tree.leaves(st)
        ref = jax.tree.leaves(like)
        if len(leaves) != len(ref):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, the "
                             f"template {len(ref)}")
        return jax.tree.unflatten(
            jax.tree.structure(like),
            [jnp.asarray(np.asarray(x, dtype=r.dtype)) for x, r in zip(leaves, ref)])
