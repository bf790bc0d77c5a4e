"""FT8 skimmer: wideband -> PFB channelizer -> batched FT8 decode.

The config-5 dataflow put to work end to end: multiple simultaneous FT8
transmissions on different channels of one wideband capture, channelized by
the polyphase filterbank, decoded in one dense batched min-sum program —
the many-channel digital-mode monitor the reference cannot be (one MCU,
one decoder; SURVEY.md §2.1 #15 + §7 P6)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from conftest import jrun, jwrap

from radioframe.ops import ft8
from radioframe.ops.pfb import PfbChannelizer

pytestmark = pytest.mark.slow  # digital modes: long-running, gated by --runslow

M = 32                    # channels; fs_ch = 12 kHz = FT8 native rate
FS_CH = 12_000.0
FS_WIDE = M * FS_CH       # 384 kHz wideband
SPS = 1920                # FT8 symbol length at 12 kHz (0.16 s)
F0 = 1000.0


def _ft8_baseband(to, de, grid, rng):
    """Complex FT8 8-FSK baseband at 12 kHz (analytic form of modulate)."""
    tones = ft8.encode_symbols(to, de, grid)
    f = F0 + 6.25 * tones.astype(np.float64)
    inst = np.repeat(f, SPS) / FS_CH
    phase = 2.0 * np.pi * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64)


class TestFt8Skimmer:
    def test_three_signals_one_wideband(self):
        rng = np.random.default_rng(11)
        msgs = [("CQ", "K1ABC", "FN42"), ("CQ", "W9W", "EM69"),
                ("K1ABC", "GM4XYZ", "IO87")]
        act = [5, 13, 27]  # active channel numbers
        base = [_ft8_baseband(*m, rng) for m in msgs]
        T_ch = len(base[0])
        T = T_ch * M
        n = np.arange(T)
        wide = np.zeros(T, np.complex64)
        for c, b in zip(act, base):
            up = np.repeat(b, M)  # ZOH to wideband rate (images land outside
            # the channel passband and the PFB rejects them)
            wide += (up * np.exp(2j * np.pi * (c / M) * n)).astype(np.complex64)
        wide += (0.05 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
                 ).astype(np.complex64)

        pfb = PfbChannelizer(M, 8)
        chans, _ = jrun(lambda w: pfb(pfb.init_state(1), w), wide[None, :])
        chans = np.asarray(chans)[0]  # (M, T_ch)

        # batched decode of the active channels' complex baseband: the FSK
        # tone projection works on analytic signals directly (no real()
        # needed — energies are |frame . basis|^2)
        basis = ft8.tone_basis(FS_CH, F0, SPS)
        batch = chans[act].astype(np.complex64)
        # `start` slices statically inside symbol_energies -> close over it
        energies = lambda b, start: jrun(
            lambda b: ft8.symbol_energies(b, basis, start, SPS), b)
        decoded = {}
        # the PFB group delay shifts symbol boundaries by a few samples;
        # scan a handful of start offsets like a real skimmer's time sync
        for start in range(0, 4 * (pfb.K // 2) + 1, 2):
            e = energies(batch, start)
            info, ok = jrun(lambda e: ft8.decode_llrs(ft8.soft_bits(e)), e)
            info, ok = np.asarray(info), np.asarray(ok)
            for i in range(len(act)):
                if i in decoded or not ok[i]:
                    continue
                bits = info[i]
                if int("".join(map(str, bits[77:])), 2) != ft8.crc14(bits[:77]):
                    continue
                try:
                    decoded[i] = ft8.unpack_message(bits[:77])
                except (ValueError, IndexError):
                    pass
            if len(decoded) == len(act):
                break
        assert len(decoded) == len(act), f"decoded only {sorted(decoded)}"
        for i, m in enumerate(msgs):
            assert decoded[i] == m, (decoded[i], m)
        # quiet channels carry no decodable energy: their peak symbol energy
        # is far below the active channels'
        e_all = np.asarray(energies(chans.astype(np.complex64), 0))
        peak = e_all.max(axis=(1, 2))
        quiet = np.setdiff1d(np.arange(M), np.asarray(act))
        assert peak[act].min() > 20.0 * peak[quiet].max()
