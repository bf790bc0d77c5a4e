"""The parts of chip_smoke.py the CPU can reach: the comparison helpers, the
last line, phase selection, the refusal without a GPU, and the four-card
phases on four virtual CPU devices at a small size."""

import json

import jax
import numpy as np
import pytest

import chip_smoke as S


def test_compare_within_tolerance(capsys):
    err = S.compare("x", np.array([1.0, 2.0]), np.array([1.0, 2.0 + 1e-6]), atol=1e-5)
    assert err == pytest.approx(1e-6, rel=1e-3)
    line = capsys.readouterr().out
    assert "[x]" in line and "atol=1e-05" in line and "precision=" in line and "OK" in line


@pytest.mark.parametrize("got,want", [
    (np.array([1.0, 2.1]), np.array([1.0, 2.0])),          # outside atol
    (np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.0])),     # shape mismatch
    (np.array([np.nan, 2.0]), np.array([np.nan, 2.0])),    # not finite
])
def test_compare_fails(capsys, got, want):
    with pytest.raises(AssertionError):
        S.compare("y", got, want, atol=1e-3)
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("value,lo,hi,ok", [
    (25.0, 20.0, None, True),
    (0.4, None, 1.0, True),
    (1.5, None, 1.0, False),
])
def test_check_bounds(value, lo, hi, ok):
    if ok:
        assert S.check("snr", value, lo=lo, hi=hi) == value
    else:
        with pytest.raises(AssertionError):
            S.check("snr", value, lo=lo, hi=hi)


def test_last_line():
    devs = jax.devices()[:4]
    got = json.loads(S.last_line(devs))
    assert got == {"ok": True, "device": {"platform": devs[0].platform,
                                          "kind": devs[0].device_kind, "count": 4}}


def test_select_phases():
    assert S.select_phases(True) == ("config3_sharded_rx", "config5_sharded_channelizer")
    assert "flagship_rx" in S.select_phases(False)
    assert not set(S.select_phases(True)) & set(S.select_phases(False))
    assert all(callable(getattr(S, f"phase_{p}")) for p in S.PHASES_ONE + S.PHASES_MULTI)


def test_refuses_without_gpu(capsys):
    assert S.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "GPU" in out.err


def test_multi_config3_on_four_devices(capsys):
    S.phase_config3_sharded_rx("cpu", C=8, block_mult=2, n_blocks=2)
    out = capsys.readouterr().out
    assert out.count("distinct devices") == 2 and "FAIL" not in out


def test_multi_config5_on_four_devices(capsys):
    S.phase_config5_sharded_channelizer("cpu", M=64, frames=128, n_blocks=2)
    out = capsys.readouterr().out
    assert out.count("distinct devices") == 2 and "FAIL" not in out
