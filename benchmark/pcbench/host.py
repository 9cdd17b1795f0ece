"""Host clocks and host memory of the benchmark's own process."""

from __future__ import annotations

import os
import threading
import time


def seconds_since_process_start():
    """Seconds since this process started, from /proc/self/stat's start
    time against /proc/uptime (10 ms ticks); None where the kernel gives
    neither."""
    try:
        with open('/proc/self/stat') as f:
            stat = f.read()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        # Field 22 (starttime), counted after the parenthesised command.
        start_ticks = int(stat.rsplit(')', 1)[1].split()[19])
        elapsed = uptime - start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return None
    if not 0 <= elapsed < 3600:
        return None
    return elapsed


class RssSampler:
    """The largest resident size of this process while it runs, read from
    /proc/self/statm every `every` seconds on a thread of its own.  (A
    sandboxed kernel may give no VmHWM to reset and read, so the peak is
    sampled the same way everywhere.)"""

    def __init__(self, every=0.005):
        self.every = every
        self.page = os.sysconf('SC_PAGE_SIZE')
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _read(self):
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self._read())
            time.sleep(self.every)

    def __enter__(self):
        self.peak = self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())
        return False
