"""Channel-name algebra, and series names as numbers.

Copy of ``split_channel_name``, ``channel_combination_weights`` and
``series_name_to_number`` from ``detprocess_tpu/utils/channels.py`` (the
reference's detprocess/utils/utils.py:70-184). The processing config addresses
channels with separators:

- ``,``  apply independently to each listed channel
- ``+``  weighted sum of channel traces (one combined trace)
- ``-``  weighted difference of channel traces (one combined trace)
- ``|``  multi-channel (NxM optimal filter), order matters
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

ALLOWED_SEPARATORS = (",", "|", "+", "-")

SERIES_RE = re.compile(r"I(\d+)_D(\d{8})_T(\d{6})")


def series_name_to_number(series_name: str) -> int:
    """'I{facility}_D{yyyymmdd}_T{hhmmss}' (found anywhere in the string)
    as the sortable integer facility·10¹⁴ + date·10⁶ + time."""
    m = SERIES_RE.search(series_name)
    if not m:
        raise ValueError(f"unrecognized series name: {series_name}")
    fac, day, tme = m.groups()
    return int(fac) * 10**14 + int(day) * 10**6 + int(tme)


def split_channel_name(
    channel_name: str,
    available_channels: Optional[Sequence[str]] = None,
    separator: Optional[str] = None,
):
    """Split a compound channel name into (channel_list, separator or
    None). With ``available_channels`` the channels are found by greedy
    substring matching (longest names first), so that names holding
    separator-like characters still resolve; otherwise the name is split
    on ``separator``."""
    channel_name = channel_name.replace(" ", "")

    if separator is not None and separator not in ALLOWED_SEPARATORS:
        raise ValueError(
            f'separator "{separator}" not recognized; allowed: {ALLOWED_SEPARATORS}'
        )

    if not any(sep in channel_name for sep in ALLOWED_SEPARATORS):
        return [channel_name], None

    if available_channels is None:
        if separator is None:
            raise ValueError(
                'separator required when "available_channels" not provided'
            )
        if separator == "-":
            raise ValueError('"available_channels" required when using separator "-"')
        return channel_name.split(separator), separator

    if channel_name in available_channels or channel_name == "all":
        return [channel_name], None

    channel_check = channel_name
    channel_list = []
    for chan in sorted(available_channels, key=len, reverse=True):
        if chan in channel_check:
            channel_check = channel_check.replace(chan, "")
            channel_list.append(chan)

    # back to the order of the name
    channel_list.sort(key=lambda c: channel_name.find(c))

    separator_list = sorted(set(channel_check))
    unknown = [s for s in separator_list if s not in ALLOWED_SEPARATORS]
    if unknown:
        raise ValueError(
            f'unidentified channel "{channel_name}"; available: {list(available_channels)}'
        )

    if separator is None:
        if len(separator_list) == 1:
            sep = separator_list[0]
            if sep != "-":
                channel_list = channel_name.split(sep)
            return channel_list, sep
        return channel_list, separator_list

    if separator not in channel_name:
        return [channel_name], None

    if separator != "-":
        return channel_name.split(separator), separator

    if any(s in channel_name for s in ("|", "+", ",")):
        raise ValueError(
            'multiple separators present: split with other separators before "-"'
        )
    return channel_list, separator


def channel_combination_weights(
    channel_name: str,
    available_channels: Sequence[str],
):
    """Resolve a ``+``/``-`` combination into (channels, weights):
    ``"a+b"`` → (["a", "b"], [1, 1]), ``"a-b"`` → (["a", "b"], [1, -1]),
    a plain name → ([name], [1.0])."""
    chans, sep = split_channel_name(channel_name, available_channels)
    if sep is None:
        return chans, [1.0]
    if sep == "+":
        return chans, [1.0] * len(chans)
    if sep == "-":
        # sign follows the position of '-' in the name
        weights = []
        pos = 0
        for chan in chans:
            idx = channel_name.find(chan, pos)
            sign = -1.0 if idx > 0 and channel_name[idx - 1] == "-" else 1.0
            weights.append(sign)
            pos = idx + len(chan)
        return chans, weights
    raise ValueError(
        f'channel "{channel_name}" uses separator "{sep}", not a +/- combination'
    )
