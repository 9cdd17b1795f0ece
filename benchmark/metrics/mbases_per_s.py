"""Input bases trimmed per second: every base of every job of the window
over the time of the window's CLI calls (from each call's start to its
return, without the benchmark's hashing of what it writes to stdout)."""

UNIT = 'Mb/s'
SOURCE = 'host_clock'


def read(rec):
    if not rec.get('window_s'):
        return None
    return rec['bases'] / rec['window_s'] / 1e6
