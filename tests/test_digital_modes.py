"""FT8 / WSPR digital modes (SURVEY.md §2.1 #15) — round-trip + FEC tests.

All channel tests are round trips through our own encoder: they pin the
machinery (packing, CRC, LDPC staircase encode/min-sum decode, conv
encode/stack decode, FSK mod/demod, sync search) regardless of the
PROVISIONAL table placeholders documented in ft8.py / wspr.py headers.
"""

import numpy as np
import pytest

from radioframe.ops import fec, ft8, wspr

# FT8 test scaling: fs/sps must equal the 6.25 Hz tone spacing
FT8_FS, FT8_SPS, FT8_F0 = 3200.0, 512, 800.0
# WSPR test scaling: fs/sps = 1.4648 Hz tone spacing
WSPR_FS, WSPR_SPS, WSPR_F0 = 1500.0, 1024, 400.0


pytestmark = pytest.mark.slow  # digital modes: long-running, gated by --runslow

class TestFec:
    def test_ldpc_encode_satisfies_checks(self):
        rng = np.random.default_rng(0)
        H = fec.ldpc_staircase(91, 83, seed=7)
        msgs = rng.integers(0, 2, (16, 91)).astype(np.uint8)
        cw = fec.ldpc_encode(H, msgs)
        assert fec.ldpc_check(H, cw).all()

    def test_ldpc_minsum_corrects_errors(self):
        rng = np.random.default_rng(1)
        H = ft8.H
        info = rng.integers(0, 2, (8, 91)).astype(np.uint8)
        cw = fec.ldpc_encode(H, info)
        llr = 4.0 * (1.0 - 2.0 * cw.astype(np.float32))
        # flip 6 random coded bits per codeword (hard ±LLR flips are BP's
        # worst case; 6 is inside this code's reliable radius, 8 is ~85%)
        for b in range(8):
            idx = rng.choice(174, 6, replace=False)
            llr[b, idx] *= -1.0
        hard, ok = fec.ldpc_decode_minsum(H, llr, iters=40)
        assert np.asarray(ok).all()
        assert (np.asarray(hard) == cw).all()

    def test_conv_stack_decode_with_noise(self):
        rng = np.random.default_rng(2)
        msg = rng.integers(0, 2, 50).astype(np.uint8)
        padded = np.concatenate([msg, np.zeros(31, np.uint8)])
        coded = fec.conv_encode(padded, wspr.POLYS, 32)
        llr = 3.0 * (1.0 - 2.0 * coded.astype(np.float64))
        llr += rng.standard_normal(len(llr)) * 1.5
        dec = fec.conv_stack_decode(llr, wspr.POLYS, 50, 32)
        assert dec is not None and (dec == msg).all()

    def test_crc_msb_detects_change(self):
        bits = np.zeros(82, np.uint8)
        bits[3] = 1
        c1 = fec.crc_msb(bits, ft8.CRC_POLY, 14)
        bits[40] = 1
        c2 = fec.crc_msb(bits, ft8.CRC_POLY, 14)
        assert c1 != c2


class TestWspr:
    @pytest.mark.parametrize("call,grid,pwr", [
        ("K1ABC", "FN42", 37), ("GM4XYZ", "IO87", 30), ("W9W", "EM69", 23),
    ])
    def test_pack_unpack(self, call, grid, pwr):
        assert wspr.unpack_message(wspr.pack_message(call, grid, pwr)) == (call, grid, pwr)

    def test_symbols_structure(self):
        sym = wspr.encode_symbols("K1ABC", "FN42", 37)
        assert sym.shape == (162,)
        assert sym.max() <= 3
        assert ((sym & 1) == wspr.SYNC).all()  # sync rides the LSB

    def test_audio_round_trip_clean(self):
        sym = wspr.encode_symbols("K1ABC", "FN42", 37)
        audio = wspr.modulate(sym, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS)
        assert wspr.decode(audio, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS,
                           search_offsets=0) == ("K1ABC", "FN42", 37)

    def test_audio_round_trip_noisy(self):
        rng = np.random.default_rng(3)
        sym = wspr.encode_symbols("GM4XYZ", "IO87", 30)
        audio = wspr.modulate(sym, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS)
        noisy = audio + 2.0 * rng.standard_normal(len(audio))  # -9 dB in-band
        assert wspr.decode(noisy, fs=WSPR_FS, f0=WSPR_F0, sps=WSPR_SPS,
                           search_offsets=0) == ("GM4XYZ", "IO87", 30)


class TestFt8:
    @pytest.mark.parametrize("to,de,grid", [
        ("CQ", "K1ABC", "FN42"), ("K1ABC", "GM4XYZ", "IO87"),
    ])
    def test_pack_unpack(self, to, de, grid):
        assert ft8.unpack_message(ft8.pack_message(to, de, grid)) == (to, de, grid)

    def test_costas_positions(self):
        tones = ft8.encode_symbols("CQ", "K1ABC", "FN42")
        assert tones.shape == (79,)
        for base in (0, 36, 72):
            assert (tones[base:base + 7] == ft8.COSTAS).all()

    def test_audio_round_trip_clean(self):
        tones = ft8.encode_symbols("CQ", "K1ABC", "FN42")
        audio = ft8.modulate(tones, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
        assert ft8.decode(audio, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS) == \
            ("CQ", "K1ABC", "FN42")

    def test_audio_round_trip_negative_snr(self):
        rng = np.random.default_rng(4)
        tones = ft8.encode_symbols("K1ABC", "GM4XYZ", "IO87")
        audio = ft8.modulate(tones, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
        noisy = audio + 3.0 * rng.standard_normal(len(audio))  # -12.6 dB
        assert ft8.decode(noisy, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS) == \
            ("K1ABC", "GM4XYZ", "IO87")

    def test_batched_decode(self):
        """Many channels decode in one dense min-sum program (batched shape)."""
        import jax.numpy as jnp
        rng = np.random.default_rng(5)
        msgs = [("CQ", "K1ABC", "FN42"), ("CQ", "W9W", "EM69"),
                ("K1ABC", "GM4XYZ", "IO87"), ("QRZ", "K1ABC", "FN42")]
        auds = []
        for to, de, grid in msgs:
            a = ft8.modulate(ft8.encode_symbols(to, de, grid),
                             fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
            auds.append(a + 2.0 * rng.standard_normal(len(a)))
        batch = jnp.asarray(np.stack(auds), jnp.float32)
        basis = ft8.tone_basis(FT8_FS, FT8_F0, FT8_SPS)
        e = ft8.symbol_energies(batch, basis, 0, FT8_SPS)
        info, ok = ft8.decode_llrs(ft8.soft_bits(e))
        assert np.asarray(ok).all()
        for i, (to, de, grid) in enumerate(msgs):
            bits = np.asarray(info[i])
            assert ft8.unpack_message(bits[:77]) == (to, de, grid)
            crc = int("".join(map(str, bits[77:])), 2)
            assert crc == ft8.crc14(bits[:77])

    def test_sync_search_finds_offset(self):
        rng = np.random.default_rng(6)
        tones = ft8.encode_symbols("CQ", "K1ABC", "FN42")
        audio = ft8.modulate(tones, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS)
        pad = np.concatenate([0.1 * rng.standard_normal(FT8_SPS), audio])
        s, fhat, m = ft8.sync_search(pad, fs=FT8_FS, f0=FT8_F0, sps=FT8_SPS,
                                     time_steps=6, freq_steps=1)
        assert s == FT8_SPS and fhat == FT8_F0
        assert ft8.decode(pad, fs=FT8_FS, f0=FT8_F0, start=s, sps=FT8_SPS) == \
            ("CQ", "K1ABC", "FN42")
