"""Host batches to the device: pinned buffers, a side-stream copy behind an
event, and the ADC conversion there.

Shared by the ``FeatureProcessing`` and ``TriggerProcessing`` shells
(``pipelines/features.py``, ``pipelines/triggers.py``):

- :class:`BufferRing` hands out host buffers of one batch shape, pinned
  for the GPU, and hands a buffer out again only after the event of its
  last copy to the card has completed;
- :class:`Uploader` copies a host batch to the device ``non_blocking`` on
  a side stream, records an event there that the compute stream waits on,
  and converts stored ADC codes to amps on the device (``ops/adc.py``),
  so that int16 codes cross the bus at 2 bytes a sample. It counts the
  bytes and samples it moved.

On the CPU a batch stays where it is: the "upload" is the host tensor
itself, and only the conversion runs.

:func:`read_channel` and :func:`channel_to_device` serve the IV-sweep and
dIdV paths, which take one channel of every event of a few files at once:
the channel's rows are read as stored (int16 codes for pytesdaq data)
into one pinned buffer, copied up once, and converted to amps on the
device in the asked dtype with each event's float64 factor.
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np
import torch

from detprocess_tpu_torch.io.fastio import FastReader
from detprocess_tpu_torch.ops.adc import adc_convert


class BufferRing:
    """Up to ``count`` host buffers of one batch for one reader, made when
    first needed: (tensor, its numpy view), pinned for the GPU. A buffer
    given back with the event of its copy to the card is handed out again
    only after that event has completed."""

    def __init__(self, count: int, shape, dtype, pin: bool):
        self._free: queue.Queue = queue.Queue()
        self._left = count
        self._shape = shape
        self._dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self._pin = pin

    def acquire(self):
        try:
            event, buf = self._free.get_nowait()
        except queue.Empty:
            if self._left > 0:
                self._left -= 1
                t = torch.empty(self._shape, dtype=self._dtype,
                                pin_memory=self._pin)
                return t, t.numpy()
            event, buf = self._free.get()
        if buf is None:
            raise RuntimeError("the batch buffers were closed")
        if event is not None:
            event.synchronize()
        return buf

    def release(self, buf, event=None):
        self._free.put((event, buf))

    def close(self):
        """Wake a reader thread waiting for a buffer: it gets none."""
        self._free.put((None, None))


class Uploader:
    """Host batches [B, C, N] to ``device``, counted in ``bytes`` and
    ``samples`` (as stored, before any conversion)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self.on_cuda
                        else None)
        self.bytes = 0
        self.samples = 0

    def upload(self, host: torch.Tensor, conv: Optional[np.ndarray] = None,
               dtype: torch.dtype = torch.float32):
        """(traces on the device, the copy's event or None) of the host
        batch ``host``. With ``conv`` [B, C] the stored values are
        converted there, ``host · conv`` in ``dtype``. On the GPU ``host``
        must be pinned and stay untouched until the event has completed
        (give its buffer back to its :class:`BufferRing` with the event)."""
        copied = conv_d = None
        if self.on_cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                x = torch.empty(host.shape, dtype=host.dtype,
                                device=self.device)
                x.copy_(host, non_blocking=True)
                if conv is not None:
                    conv_d = torch.from_numpy(conv).pin_memory().to(
                        self.device, non_blocking=True)
                copied = torch.cuda.Event(blocking=True)
                copied.record(self._stream)
            compute.wait_event(copied)
            x.record_stream(compute)
            if conv_d is not None:
                conv_d.record_stream(compute)
        else:
            x = host
            conv_d = None if conv is None else torch.from_numpy(conv)
        self.bytes += x.numel() * x.element_size()
        self.samples += x.numel()
        if conv_d is not None:
            x = adc_convert(x, conv_d, dtype)
        return x, copied



def read_channel(index, channel: str, nevents: Optional[int] = None,
                 pin: bool = False):
    """(stored values [B, N] as a host tensor, pinned with ``pin``; each
    event's float64 conversion factor [B]) of ``channel`` for the first
    ``nevents`` events of the ``io/rawdata.RawIndex`` ``index`` in
    reading order."""
    rows = index.order if nevents is None else index.order[:nevents]
    if len(rows) == 0:
        raise ValueError(f"no events to read for channel {channel}")
    first = index.datasets[int(rows[0])]
    stored = torch.from_numpy(np.empty(0, first.dtype)).dtype
    host = torch.empty((len(rows), first.shape[-1]), dtype=stored,
                       pin_memory=pin)
    buf = host.numpy()
    conv = np.empty(len(rows), np.float64)
    fast = FastReader()
    try:
        for i, row in enumerate(rows):
            f = index.files[int(index.file[row])]
            ci = f.channels.index(channel)
            fast.read(index.datasets[int(row)], rows=[ci],
                      out=buf[i:i + 1])
            conv[i] = f.conv[ci]
    finally:
        fast.close()
    return host, conv


def channel_to_device(host: torch.Tensor, conv: np.ndarray, device,
                      dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The amps [B, N] in ``dtype`` on ``device`` of :func:`read_channel`'s
    stored values: one copy up, then stored · conv on the device (float64
    factors, as the reader's amps are)."""
    x = host.to(device, non_blocking=True)
    conv_d = torch.from_numpy(conv).to(device)
    return x.to(dtype) * conv_d.to(dtype)[:, None]
