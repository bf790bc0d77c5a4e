"""Hand-written kernels, and the one place that decides when they run.

``frontend_for`` is the only caller-facing choice: every chain asks it,
with the platform it runs on and its decimation stages, whether the Triton
front end (``kernels/frontend.py``) replaces the plain XLA NCO mix and
first decimators. Interpret mode is never chosen here; tests build the
kernel with ``interpret=True`` themselves.
"""

from __future__ import annotations

import numpy as np


def frontend_for(stage_taps, stage_R, platform: str, input_scale: float = 1.0):
    """The Triton front end for these decimation stages on ``platform``, or
    None where the plain XLA front end runs.

    The kernel is compiled for the GPU only. It takes the first stage when
    its taps are real and its R is a power of two, and the second stage too
    when that one has real taps; it was measured faster than XLA end to end
    on an H100 at the flagship and ADC-rate shapes (PERF.md)."""
    if platform != "gpu" or not stage_taps:
        return None
    R1 = int(stage_R[0])
    if np.iscomplexobj(stage_taps[0]) or R1 & (R1 - 1):
        return None
    from radioframe.kernels.frontend import TritonFrontend

    if len(stage_taps) > 1 and not np.iscomplexobj(stage_taps[1]):
        return TritonFrontend(stage_taps[0], R1, stage_taps[1], int(stage_R[1]),
                              input_scale=input_scale)
    return TritonFrontend(stage_taps[0], R1, input_scale=input_scale)
