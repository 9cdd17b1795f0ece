"""Lanes split over several devices in one process (counterpart of
porechop_tpu/parallel/mesh.py).

The JAX package shards every launch's batch axis over a 1-D mesh of the
local devices (shard_map), replicates the tables, and merges the detection
phase's per-set maxima across devices with a pmax.  The port does the same
with device entries: a list of torch devices that may name one device more
than once ('cuda:0,cuda:1', 'cuda:0,cuda:0', 'cpu,cpu').  launch_shards
splits a launch's lanes contiguously and as evenly as possible over the
entries (split_lanes), each entry launches its share on its device, and
the results join in lane order; the group maxima merge exactly
(engine_v2.merge_groupmax), so every result equals one entry's.  The
planner (ops/dispatch.AlignJobs) sends every launch of a run through
launch_shards, which uploads each share's lane indices, or, for a
product of jobs, through launch_lanes, whose lanes compute their own
indices on each device; so do sharded_align and detection_step, the JAX
package's contracts over a dense batch, through launch_shards.  A single process takes
local_devices() unless the caller names a device, and a rank of a
multi-process run keeps its one card (parallel/multihost.py), as the JAX
package's mesh spans only the local devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import engine_v2
from ..utils import spans


def local_devices() -> list:
    """The device entries of a single process: every local card when there
    is more than one (unless PORECHOP_TPU_DISABLE_MESH is set), else the
    one card."""
    n = torch.cuda.device_count()
    if n > 1 and not os.environ.get('PORECHOP_TPU_DISABLE_MESH'):
        return [torch.device('cuda', k) for k in range(n)]
    return [torch.device('cuda')]


def split_lanes(n: int, parts: int) -> list:
    """[lo, hi) of each of `parts` contiguous shares of n lanes, the first
    n % parts of them one lane longer."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (k < r) for k in range(parts)])
    return [(int(bounds[k]), int(bounds[k + 1])) for k in range(parts)]


def launch_shards(kind, devices, tables, w_idx, a_idx, scoring,
                  groups=None, lens=None) -> list:
    """Enqueues one launch with its lanes split over the device entries.
    Lane k aligns row w_idx[k] of the window table against row a_idx[k]
    of the adapter table; tables(dev) returns (wtab, wlens, atab, alens)
    on dev.  kind: 'gm' (per-group best fraction) or 'gsc' (per-group max
    score), both with groups = (g_idx, n_groups); 'st' (per-lane stats);
    'sc' (per-lane score); 'res' (trace-bit forward and its walk,
    engine_v2.gather_forward).  Every entry's call is enqueued on its
    device before the caller harvests any.  lens: the host lengths of the
    tables' rows (window, adapter), for the launch records of
    utils/spans.py.  Returns, per entry with lanes, in lane order, the
    engine_v2.fused_gather_* result; for 'res', (walk, best, cell_i,
    cell_j)."""
    wlens, alens = (None, None) if lens is None else lens

    def lanes(dev, lo, hi):
        wi, ai = w_idx[lo:hi], a_idx[lo:hi]
        with spans.upload(dev):
            tabs = (*tables(dev), torch.from_numpy(wi).to(dev),
                    torch.from_numpy(ai).to(dev))
            if kind in ('gm', 'gsc'):
                tabs += (torch.from_numpy(groups[0][lo:hi]).to(dev),)
        return tabs, spans.enqueue(wlens, wi, alens, ai)
    return launch_lanes(kind, devices, len(w_idx), lanes, scoring,
                        None if groups is None else groups[1])


def launch_lanes(kind, devices, n, lanes, scoring, n_groups=None) -> list:
    """Enqueues one launch of n lanes split over the device entries
    (split_lanes).  lanes(dev, lo, hi) gives the inputs of lanes [lo, hi)
    on dev, (wtab, wlens, atab, alens, w_idx, a_idx), with g_idx after
    them for 'gm' and 'gsc', and the enqueue span (utils/spans.py) to
    launch them in.  kind, n_groups and the result as launch_shards'."""
    shards = []
    for (lo, hi), dev in zip(split_lanes(n, len(devices)), devices):
        if hi == lo:
            continue
        tabs, enqueue = lanes(dev, lo, hi)
        with enqueue:
            if kind == 'gm':
                shards.append(engine_v2.fused_gather_groupmax(
                    *tabs, n_groups, scoring))
            elif kind == 'gsc':
                shards.append(engine_v2.fused_gather_group_scoremax(
                    *tabs, n_groups, scoring))
            elif kind == 'sc':
                shards.append(engine_v2.fused_gather_scores(*tabs, scoring))
            elif kind == 'st':
                shards.append(engine_v2.fused_gather_stats(*tabs, scoring))
            else:
                shards.append(engine_v2.gather_forward(*tabs, scoring))
    return shards


def _dense(devices, reads, read_lens, adapters, adapter_lens):
    """A dense batch as launch_shards' tables, copied whole to each device
    at first use, with lane k on row k: (entries, tables, lane rows)."""
    from ..ops.dispatch import resolve_devices
    host = tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=t))
                 for x, t in ((reads, np.int8), (read_lens, np.int32),
                              (adapters, np.int8), (adapter_lens, np.int32)))
    copies = {}

    def tables(dev):
        if dev not in copies:
            copies[dev] = tuple(t.to(dev) for t in host)
        return copies[dev]
    return (resolve_devices(devices), tables,
            np.arange(len(host[0]), dtype=np.int64))


def _host(t) -> np.ndarray:
    with spans.span('wait'):
        return t.cpu().numpy()


def sharded_align(devices, reads, read_lens, adapters, adapter_lens,
                  scoring=(3, -6, -5, -2)):
    """The trace-bit alignment of a dense batch with its lanes split over
    the device entries, through launch_shards, and the host finish (the
    contract of porechop_tpu/parallel/mesh.py sharded_align).  Inputs are
    host arrays; returns finish_v2's dict of host arrays."""
    devices, tables, lanes = _dense(devices, reads, read_lens, adapters,
                                    adapter_lens)
    shards = launch_shards('res', devices, tables, lanes, lanes,
                           tuple(scoring), lens=(read_lens, adapter_lens))
    walk, best, ci, cj = (np.concatenate([_host(s[k]) for s in shards])
                          for k in range(4))
    return engine_v2.finish_v2(walk, best, ci, cj,
                               np.asarray(read_lens, np.int32),
                               np.asarray(adapter_lens, np.int32))


def detection_step(devices, reads, read_lens, adapters, adapter_lens,
                   set_ids, n_sets, scoring=(3, -6, -5, -2)):
    """The detection phase's device step with its lanes split over the
    device entries: per entry, through launch_shards, the stats forward
    and the per-set best (matches, full_len), then the exact merge across
    entries in place of the JAX package's pmax (the contract of
    porechop_tpu/parallel/mesh.py detection_step).  set_ids: (B,) set slot
    per lane.  Returns per-set (best fraction float32, -1 for a set no
    lane reached; best matches int32; best full_len int32)."""
    devices, tables, lanes = _dense(devices, reads, read_lens, adapters,
                                    adapter_lens)
    shards = launch_shards('gm', devices, tables, lanes, lanes,
                           tuple(scoring),
                           (np.asarray(set_ids, np.int64), int(n_sets)),
                           lens=(read_lens, adapter_lens))
    gm, gl = engine_v2.merge_groupmax([(_host(m), _host(ln))
                                       for m, ln in shards])
    seg = np.where(gl > 0, gm / np.maximum(gl, 1), -1.0).astype(np.float32)
    return seg, gm.astype(np.int32), gl.astype(np.int32)
