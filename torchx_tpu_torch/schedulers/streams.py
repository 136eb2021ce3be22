"""Tee — fan-in stdout+stderr files into one combined log.

Reference analog: torchx/schedulers/streams.py:16-71. A background thread
tails the two source files and appends interleaved lines to the combined
file until closed.

Each combined line is prefixed with an epoch stamp (``<epoch.millis> ``,
the same wire format as the remote-host stamper of
:data:`~torchx_tpu_torch.schedulers.api.EPOCH_STAMPER`) at the moment the Tee
observes it, which is what lets the local scheduler honor ``--since`` /
``--until`` log windows. Readers strip the stamp before display.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import IO


class Tee:
    def __init__(self, combined: Path, stdout: Path, stderr: Path) -> None:
        self._combined: IO[bytes] = open(combined, "ab")
        self._sources = [open(stdout, "rb"), open(stderr, "rb")]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        # Per-source partial-line buffers: only COMPLETE lines are stamped
        # and written, so a writer caught mid-line (progress bars, unbuffered
        # prints) never gets a stamp injected into the middle of its payload.
        partial = [b"" for _ in self._sources]
        while True:
            wrote = False
            for i, src in enumerate(self._sources):
                data = src.read()
                if not data:
                    continue
                lines = (partial[i] + data).split(b"\n")
                partial[i] = lines.pop()  # trailing partial (or b"")
                for line in lines:
                    self._combined.write(f"{time.time():.3f} ".encode())
                    self._combined.write(line + b"\n")
                    wrote = True
            if wrote:
                self._combined.flush()
            if self._stop.is_set() and not wrote:
                break
            if not wrote:
                time.sleep(0.05)
        # final drain: a process whose last write had no newline still gets
        # its tail into the combined log
        for i, tail in enumerate(partial):
            if tail:
                self._combined.write(f"{time.time():.3f} ".encode() + tail + b"\n")
        self._combined.flush()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # pump still draining: leave the files to it (daemon thread dies
            # with the process) rather than closing them out from under it
            return
        for src in self._sources:
            src.close()
        self._combined.close()
