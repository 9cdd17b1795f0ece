"""One job: a complete Porechop run of the port on one batch file, called
in the benchmark's own process as a per-file trimming script would call
it, with what it writes taken as digests.

Output modes (a workload's "output"):
  stdout  no -o: the records go to sys.stdout, which the job replaces with
          a sink that digests what it is given; nothing is written to disk
  file    -o <work>/<name>: the file is read back, decompressed when
          gzipped, digested and deleted
  bins    -b <work>/bins: each bin file is read back, digested and
          deleted

A job's time is the CLI call's alone: it ends when `cli.main` returns,
before its files are read back, and the stdout sink's hashing is timed
and taken out of it.
The transcript (-v 1) is kept as text: the adapter lines and the barcode
orientation that it prints are compared with the reference's, and the
`[timing]` phase lines of a traced run are summed.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import os
import re
import shutil
import sys
import time

_ANSI = re.compile(r'\x1b\[[0-9;]*m')
_TIMING = re.compile(r'^\[timing\] phase (\S+)\s+([0-9.]+)s$', re.M)


class DigestSink(io.TextIOBase):
    """A text stream that keeps only the SHA-1 and the length of what is
    written to it."""

    def __init__(self):
        self.sha = hashlib.sha1()
        self.nbytes = 0
        self.seconds = 0.0

    def writable(self):
        return True

    def write(self, s):
        t = time.perf_counter()
        b = s.encode()
        self.sha.update(b)
        self.nbytes += len(b)
        self.seconds += time.perf_counter() - t
        return len(s)

    def digest(self):
        return self.sha.hexdigest(), self.nbytes


def digest_bytes(b):
    return hashlib.sha1(b).hexdigest(), len(b)


def argv_for(config, workload, path, work):
    """The CLI's arguments for one job on `path`, and what to read back."""
    argv = ['-i', path] + list(config['argv'])
    mode = workload['output']
    if mode == 'file':
        argv += ['-o', os.path.join(work, workload['output_name'])]
    elif mode == 'bins':
        argv += ['-b', os.path.join(work, 'bins')]
    elif mode != 'stdout':
        raise ValueError('unknown output mode %r' % mode)
    return argv


def collect(workload, work):
    """{stream: (sha1, bytes)} of a finished job's files, deleted after
    reading."""
    mode = workload['output']
    if mode == 'file':
        path = os.path.join(work, workload['output_name'])
        with open(path, 'rb') as f:
            data = f.read()
        os.remove(path)
        if data[:2] == b'\x1f\x8b':
            data = gzip.decompress(data)
        return {'stdout': digest_bytes(data)}
    if mode == 'bins':
        out = {}
        d = os.path.join(work, 'bins')
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), 'rb') as f:
                out[name] = digest_bytes(f.read())
        shutil.rmtree(d)
        return out
    return {}


def adapter_lines(transcript):
    """(name, sequence) lines of the end-trimming banner, and the barcode
    orientation, from a -v 1 transcript."""
    text = _ANSI.sub('', transcript)
    lines = []
    head = text.find('Trimming adapters from read ends')
    if head >= 0:
        for line in text[head:].split('\n')[1:]:
            if not line.strip():
                break
            name, _, seq = line.strip().partition(': ')
            lines.append((name.strip(), seq.strip()))
    m = re.search(r'Barcodes determined to be in (\w+) orientation', text)
    return lines, (m.group(1) if m else None)


def timing_phases(transcript):
    """{phase: seconds} of the `[timing] phase` lines."""
    out = {}
    for name, s in _TIMING.findall(transcript):
        out[name] = out.get(name, 0.0) + float(s)
    return out


class Job:
    """What one run of the CLI gave."""

    __slots__ = ('index', 'file', 'bases', 'start', 'end', 'seconds', 'ok',
                 'error', 'streams', 'adapters', 'orientation', 'phases')


def run(cli_main, config, workload, pool_entry, index, work, device=None):
    """Runs the port's CLI on one pool file in this process; returns a
    Job.  pool_entry: (path, reads, bases)."""
    path, _, bases = pool_entry
    job = Job()
    job.index, job.file, job.bases = index, path, bases
    job.streams, job.adapters, job.orientation, job.phases = {}, [], None, {}
    argv = argv_for(config, workload, path, work)
    out_sink = DigestSink() if workload['output'] == 'stdout' \
        else io.StringIO()
    err = io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out_sink, err
    job.start = time.perf_counter()
    try:
        cli_main(argv, device=device)
        job.ok, job.error = True, None
    except SystemExit as e:
        job.ok = e.code in (None, 0)
        job.error = None if job.ok else 'exit %r' % (e.code,)
    except Exception as e:          # a failed job is counted, not fatal
        job.ok, job.error = False, '%s: %s' % (type(e).__name__, e)
    finally:
        job.end = time.perf_counter()
        sys.stdout, sys.stderr = saved
    job.seconds = job.end - job.start - getattr(out_sink, 'seconds', 0.0)
    try:
        if job.ok:
            job.streams = (collect(workload, work)
                           if workload['output'] != 'stdout'
                           else {'stdout': out_sink.digest()})
    except OSError as e:
        job.ok, job.error = False, 'reading the output: %s' % e
    transcript = err.getvalue()
    if workload['output'] != 'stdout':
        transcript = out_sink.getvalue() + transcript
    job.adapters, job.orientation = adapter_lines(transcript)
    job.phases = timing_phases(transcript)
    shutil.rmtree(os.path.join(work, 'bins'), ignore_errors=True)
    return job
