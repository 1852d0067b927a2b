"""Trace-window index resolution.

Copy of ``detprocess_tpu/utils/windows.py::extract_window_indices``
(the reference's detprocess/utils/utils.py:189-301): the YAML window
specifications (µs from start, from end or from the pretrigger) become
``[min_index, max_index]`` sample indices, clamped to
``[0, nb_samples - 1]``; an inverted window is an error.
"""

from __future__ import annotations

from typing import Optional


def extract_window_indices(
    nb_samples: int,
    nb_samples_pretrigger: int,
    fs: float,
    window_min_from_start_usec: Optional[float] = None,
    window_min_to_end_usec: Optional[float] = None,
    window_min_from_trig_usec: Optional[float] = None,
    window_max_from_start_usec: Optional[float] = None,
    window_max_to_end_usec: Optional[float] = None,
    window_max_from_trig_usec: Optional[float] = None,
):
    """Return (min_index, max_index) for a feature window."""
    min_index = 0
    if window_min_from_start_usec is not None:
        min_index = int(window_min_from_start_usec * fs * 1e-6)
    elif window_min_to_end_usec is not None:
        min_index = nb_samples - abs(int(window_min_to_end_usec * fs * 1e-6)) - 1
    elif window_min_from_trig_usec is not None:
        min_index = nb_samples_pretrigger + int(window_min_from_trig_usec * fs * 1e-6)
    min_index = max(0, min(min_index, nb_samples - 1))

    max_index = nb_samples - 1
    if window_max_from_start_usec is not None:
        max_index = int(window_max_from_start_usec * fs * 1e-6)
    elif window_max_to_end_usec is not None:
        max_index = nb_samples - abs(int(window_max_to_end_usec * fs * 1e-6)) - 1
    elif window_max_from_trig_usec is not None:
        max_index = nb_samples_pretrigger + int(window_max_from_trig_usec * fs * 1e-6)
    max_index = max(0, min(max_index, nb_samples - 1))

    if max_index < min_index:
        raise ValueError(
            "window calculation: max index smaller than min — check configuration"
        )
    return min_index, max_index
