"""Every example must keep running end to end (drift guard).

The examples are the framework's executable documentation; nothing else
imported them, so an API change could silently break them. Each runs as a
subprocess with JAX_PLATFORMS=cpu in the environment (a fresh process
reads it at import, unlike this one — conftest module note). The golden
demo is fast and runs in the default suite; the jitted demos compile for
tens of seconds on CPU and sit behind --runslow.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(name, *args, timeout=900):
    # the examples import radioframe from the checkout, which need not be
    # installed: put the repo root on the subprocess's path
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
    p = subprocess.run(
        [sys.executable, str(REPO / "examples" / name), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    assert p.returncode == 0, f"{name} failed:\n{p.stdout}\n{p.stderr}"
    return p.stdout


def test_golden_rx_demo():
    out = _run("golden_rx_demo.py")
    assert "SSB" in out and "NFM" in out


@pytest.mark.slow
@pytest.mark.parametrize("name,args", [
    ("golden_rx_demo.py", ("--blocked",)),
    ("rx_demo.py", ("--blocks", "8")),
    ("duplex_demo.py", ("--mode", "ssb")),
    ("transceiver_demo.py", ()),
    ("cat_tcp_demo.py", ()),
    ("monitor_demo.py", ("--channels", "32")),
    ("monitor_demo.py", ("--channels", "32", "--mesh", "4")),
])
def test_example_runs(name, args):
    _run(name, *args)


@pytest.mark.slow
def test_channelizer_demo(tmp_path):
    out = tmp_path / "wf.png"
    _run("channelizer_demo.py", "--channels", "32", "--out", str(out))
    assert out.exists()
