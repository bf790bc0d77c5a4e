"""Golden RX chain: the fp64 numpy composition that mirrors ``RxChain.step``
for one channel, built from the chain's own taps (acceptance configs 1+2:
the device chain's audio SNR must sit within 1 dB of this one's)."""

from __future__ import annotations

import numpy as np

from radioframe.golden import model as G
from radioframe.ops import demod as demod_op
from radioframe.ops import filter_design as FD
from radioframe.ops import nco


def golden_rx(chain, iq, freq_hz, mode_name):
    """(chain: RxChain, iq (T,) complex, freq_hz, mode name) -> audio (fp64)."""
    cfg = chain.cfg
    word = nco.freq_word(freq_hz, cfg.fs_in)
    fq = nco.word_to_freq(word, cfg.fs_in)
    x, _ = G.nco_mix(np.asarray(iq).astype(np.complex128), fq, cfg.fs_in)
    fs = cfg.fs_in
    for dec in chain.decimators:
        taps = (dec._rhs[0, 0] + 1j * dec._rhs[1, 0]) if dec.complex_taps else dec._rhs[0, 0]
        taps = np.asarray(taps)[::-1]
        x, _ = G.fir_decimate(x, taps, dec.R)
        fs /= dec.R
    mf = cfg.mode_filters
    k = demod_op.MODE_NAMES[mode_name]
    taps_k = [
        FD.complex_bandpass_taps(mf.numtaps, mf.ssb_lo, mf.ssb_hi, fs),
        FD.complex_bandpass_taps(mf.numtaps, -mf.cw_halfwidth, mf.cw_halfwidth, fs),
        FD.complex_bandpass_taps(mf.numtaps, -mf.am_halfwidth, mf.am_halfwidth, fs),
        FD.complex_bandpass_taps(mf.numtaps, -mf.nfm_halfwidth, mf.nfm_halfwidth, fs),
    ][k]
    x, _ = G.ols_filter(x, taps_k)
    if mode_name == "ssb":
        audio = G.demod_ssb(x)
    elif mode_name == "cw":
        tone_q = nco.word_to_freq(chain.cw_tone_word, fs)
        audio, _ = G.demod_cw(x, tone_q, fs)  # both mix up by +tone
    elif mode_name == "am":
        audio, _ = G.demod_am(x)
    else:
        audio, _ = G.demod_nfm(x, fs, cfg.nfm_deviation_hz)
    if mode_name != "nfm":  # the chain bypasses AGC for FM
        bank = chain.agc_bank
        audio, _, _ = G.agc_full(
            audio, float(bank.release[k]), float(bank.alpha[k]),
            bank.distinct_W[int(bank.win_index[k])] - 1,
            float(bank.target[k]), float(bank.max_gain[k]))
    return audio
