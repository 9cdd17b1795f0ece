"""The port's own records of a traced run's window, for the metrics that
read them: the job records of porechop_tpu_torch/utils/spans.py, which
the port keeps while PORECHOP_TPU_TIMING is set, as a traced run sets it.
The window's jobs are the last rec['jobs'] records in the process: the
warm-up job runs before them and the check never calls cli.main.  None
where the port keeps no such records (a checkout from before them) or
holds fewer than the window's jobs."""

# The three alignment phases, as the port's `[timing] phase` lines name
# them, and its span names by layer.
ALIGNMENT = ('detect', 'endtrim', 'middle')
PLANNER = ('plan', 'upload', 'enqueue', 'host_route')
WAIT = ('wait',)


def window_jobs(rec):
    n = rec.get('jobs')
    if not n:
        return None
    try:
        from porechop_tpu_torch.utils import spans
    except ImportError:
        return None
    jobs = spans.last_jobs(n)
    return jobs if len(jobs) == n else None


def span_seconds(jobs, names=None):
    """Self seconds of the spans called `names` (None: every span) inside
    the alignment phases, summed over jobs."""
    return sum(s for j in jobs for ph in ALIGNMENT
               for name, (s, _) in j['spans'].get(ph, {}).items()
               if names is None or name in names)


def phase_seconds(jobs):
    """Seconds of the alignment phases, summed over jobs."""
    return sum(j['phases'][ph][0] for j in jobs for ph in ALIGNMENT
               if ph in j['phases'])


def per_mb(rec, seconds):
    return seconds * 1e3 / (rec['bases'] / 1e6)
