"""Dry-run entry points of the port (counterpart of the JAX package's
__graft_entry__.py): entry() is the flagship step that every phase
launches, the trace-bit forward and its walk (kernels.forward_walk, one
call), with example inputs on the
device; dryrun_multichip() runs one step of each device path of a run with
its lanes split over several device entries (parallel/mesh.py) and checks
what comes out.  Both run on the card unless given CPU entries, and never
fall back to the CPU."""

from __future__ import annotations

import numpy as np
import torch

from .ops import dispatch, kernels, spec
from .parallel import mesh

SCHEME = (3, -6, -5, -2)
FIELDS = ('read_start', 'read_end', 'adapter_start', 'adapter_end',
          'raw_score', 'matches', 'aligned_len', 'full_len')


def entry(device=None):
    """(fn, example_args): fn(reads, read_lens, adapters, adapter_lens)
    runs kernels.forward_walk under 3,-6,-5,-2 and returns (walk, best,
    cell_i, cell_j); example_args are 64 reads of 150 bp against 32 bp
    adapters on `device` (default the card)."""
    dev = dispatch.resolve_device(device)

    def fn(reads, read_lens, adapters, adapter_lens):
        return kernels.forward_walk(reads, read_lens, adapters, adapter_lens,
                                    *SCHEME)

    rng = np.random.default_rng(0)
    B, L, A = 64, 150, 32
    example_args = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 4, (B, L)).astype(np.int8),
        np.full(B, L, np.int32),
        rng.integers(0, 4, (B, A)).astype(np.int8),
        np.full(B, A, np.int32)))
    return fn, example_args


def dry_batch(n_devices: int):
    """The dry run's dense batch, host arrays: 4 lanes per entry of 64 bp
    reads against 16 bp adapters (the JAX package's dryrun_multichip's)."""
    rng = np.random.default_rng(1)
    B, L, A = 4 * n_devices, 64, 16
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    adapters = rng.integers(0, 4, (B, A)).astype(np.int8)
    return reads, np.full(B, L, np.int32), adapters, np.full(B, A, np.int32)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each device path with the lanes split over n_devices
    device entries: device names them (a list or 'cuda:0,cuda:0'), or is
    one device that every entry takes, or None for the first n_devices
    cards.  The trace-bit alignment of a dense batch (mesh.sharded_align)
    against the planner's run of the same pairs, the detection step with
    its merge of per-set maxima across entries, and the planner's group
    max and score-prefiltered stats; lane 0 against the executable spec.
    Raises on any disagreement; returns the results by step."""
    if device is None:
        device = ['cuda:%d' % k for k in range(n_devices)]
    devices = dispatch.resolve_devices(device)
    if len(devices) == 1:
        devices *= n_devices
    if len(devices) != n_devices:
        raise ValueError('%d device entries named for %d'
                         % (len(devices), n_devices))
    reads, read_lens, adapters, adapter_lens = dry_batch(n_devices)
    B = len(reads)

    out = mesh.sharded_align(devices, reads, read_lens, adapters,
                             adapter_lens, SCHEME)
    assert out['read_start'].shape == (B,)
    lanes = np.arange(B, dtype=np.int64)
    windows = [reads[k, :read_lens[k]] for k in range(B)]
    run = dispatch.AlignJobs(windows, [adapters[k, :adapter_lens[k]]
                                       for k in range(B)],
                             np.column_stack([lanes, lanes]), SCHEME,
                             device=devices).run()
    for f in FIELDS:
        assert np.array_equal(run[f], out[f]), (f, run[f], out[f])

    set_ids = (np.arange(B) % 3).astype(np.int32)
    detection = mesh.detection_step(devices, reads, read_lens, adapters,
                                    adapter_lens, set_ids, 3, SCHEME)
    assert detection[0].shape == (3,)

    adps = [adapters[k, :adapter_lens[k]] for k in range(min(4, B))]
    pairs = np.array([(w, a) for w in range(B) for a in range(len(adps))],
                     dtype=np.int64)
    res = dispatch.AlignJobs(windows, adps, pairs, SCHEME,
                             device=devices).run()
    assert res['read_start'].shape == (len(pairs),)
    gm = dispatch.AlignJobs(windows, adps, pairs, SCHEME,
                            device=devices).run_group_max(pairs[:, 1],
                                                          len(adps))
    assert gm['full_pct'].shape == (len(adps),)
    st = dispatch.AlignJobs(windows, adps, pairs, SCHEME,
                            device=devices).run_stats(prefilter=90.0)
    assert st['full_pct'].shape == (len(pairs),)

    want = spec.align_affine(reads[0], adapters[0], SCHEME)
    for f in FIELDS:
        assert int(out[f][0]) == getattr(want, f), (f, out[f][0], want)
    return dict(align=out, detection=detection, run=res, group_max=gm,
                stats=st)
