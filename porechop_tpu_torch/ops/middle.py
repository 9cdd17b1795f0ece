"""Device-resident middle-pass replay (counterpart of
porechop_tpu/ops/middle.py).

The middle phase's reference semantics are an iterative mask-and-retry
loop per read (reference porechop/nanopore_read.py:221-243): align each
adapter against the read, and while the full-adapter %id clears the
threshold, mask the hit with '-' (Dna5 'N') and re-align the SAME adapter.
Round 0 runs as one dense launch for all reads (pipeline/phases.py); reads
with any hit then replay the reference's exact per-read order in global
rounds through this runner.

The masked code tensor stays resident on the device across rounds: the
reads of the replay set upload once, and each round ships only (adapter
row, mask_start, mask_end) per lane; the mask is an in-place masked_fill_
on the device tensor before the trace-bit forward and walk.
`h2d_read_bytes` and `h2d_round_bytes` count every upload.  Inside a
traced CLI job (utils/spans.py) the runner's host work is `plan`, its
copies `upload` and `wait`, and each launch `enqueue`.

A round's trace bits take A x lanes x L1p bytes, so the replay set is cut
into launches under the planner's bits budget (dispatch.bits_lanes): lanes
sorted longest first, each launch at its own longest read's window rung.
Lanes do not see each other, so the results are those of one launch; a
set that fits one launch at its longest read's rung runs in one, as in the
JAX package.

Routing (replays_on_device): phases.find_adapters_in_read_middles uses
this runner under a scheme the kernels take, unless
PORECHOP_TPU_FORCE_HOST; otherwise it replays in host rounds through
AlignJobs's host route.  Both take each round's decisions from
replay_step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import spans
from . import dispatch, engine_v2, kernels


def replays_on_device(scoring) -> bool:
    """Whether the middle phase's replay runs on the device entries
    (ReplayRunner): under a scheme the kernels take (kernels.supports),
    unless PORECHOP_TPU_FORCE_HOST.  Otherwise it runs in host rounds, as
    the planner's host route would run them."""
    return not dispatch.force_host() and kernels.supports(scoring)


def replay_step(full_pct, adapter, threshold, n_adapters):
    """One replay round's decisions for its lanes (reference
    nanopore_read.py:221-243), from each lane's full-adapter identity
    full_pct against its adapter index `adapter`: a hit (full_pct >=
    threshold) masks the read and retries the same adapter; a miss moves
    on to the next adapter; a miss on the last adapter finishes the read.
    Returns (hit, next adapter, live): bool, int and bool arrays, a lane
    with live False being finished."""
    hit = np.asarray(full_pct) >= threshold
    nxt = np.where(hit, adapter, np.asarray(adapter) + 1)
    return hit, nxt, nxt < n_adapters


class _Launch:
    """The lanes of one launch: their masked reads resident on the device
    at window rung L."""

    def __init__(self, reads, lanes, L, dev):
        self.lanes = lanes                  # indices into the replay set
        self.Bp = dispatch.bucket_lanes(len(lanes))
        mat = np.full((self.Bp, L), 4, np.int8)
        rl = np.ones(self.Bp, np.int32)
        for k, n in enumerate(lanes):
            mat[k, :len(reads[n])] = reads[n]
            rl[k] = max(len(reads[n]), 1)
        self.nbytes = mat.nbytes + rl.nbytes
        self.rl_host = rl
        with spans.upload(dev):
            self.masked = torch.from_numpy(mat).to(dev)
            self.rl = torch.from_numpy(rl).to(dev)
            self.jcol = torch.arange(L, dtype=torch.int32, device=dev)


class ReplayRunner:
    """Holds the device-resident masked reads of one replay set.

    reads: list of np.int8 code arrays (round-0 first hit already masked).
    adapters: list of np.int8 code arrays (the phase's adapter order).
    device: the device (or device entries: it runs on the first, as the
    JAX package's replay does not shard).  A device-only runner: the
    middle phase replays schemes the kernels refuse in host rounds.
    """

    @spans.timed('plan')
    def __init__(self, reads, adapters, scoring=(3, -6, -5, -2),
                 device=None):
        if not kernels.supports(scoring):
            raise NotImplementedError('scoring scheme %s: the kernels need '
                                      'gap_open < gap_ext' % (scoring,))
        self.scoring = tuple(int(x) for x in scoring)
        self.device = dispatch.resolve_devices(device)[0]
        B = len(reads)
        self.B = B
        max_alen = max((len(a) for a in adapters), default=1)
        self.A = dispatch.bucket_adapter_len(max(max_alen, 1))

        amat = np.full((len(adapters) + 1, self.A), 4, np.int8)
        alen = np.ones(len(adapters) + 1, np.int32)
        for k, a in enumerate(adapters):
            amat[k, :len(a)] = a
            alen[k] = max(len(a), 1)
        self._dummy_row = len(adapters)
        self.al_host = alen
        # The one and only read-data upload; rounds mask it in place.
        dev = self.device
        with spans.upload(dev):
            self.amat = torch.from_numpy(amat).to(dev)
            self.alen = torch.from_numpy(alen).to(dev)
        self.h2d_read_bytes = amat.nbytes + alen.nbytes
        self.h2d_round_bytes = 0

        lens = np.array([max(len(r), 1) for r in reads], np.int64)
        order = np.argsort(-lens, kind='stable')
        self._launches = []
        lo = 0
        while True:
            L = dispatch.bucket_len(int(lens[order[lo]]) if lo < B else 1)
            n = dispatch.bits_lanes(L, self.A)
            self._launches.append(_Launch(reads, np.sort(order[lo:lo + n]),
                                          L, dev))
            self.h2d_read_bytes += self._launches[-1].nbytes
            lo += n
            if lo >= B:
                break
        self.L = self._launches[0].jcol.shape[0]    # the longest read's rung

    @spans.timed('plan')
    def round(self, a_idx, m_start, m_end):
        """a_idx: (B,) adapter row per lane (use dummy_row() for finished
        lanes); m_start/m_end: the hit region each lane's PREVIOUS round
        found (0/0 when none).  Returns the finish_v2 dict plus 'full_pct'
        and 'read_end_excl'."""
        a_idx, m_start, m_end = (np.asarray(x) for x in (a_idx, m_start,
                                                         m_end))
        dev = self.device
        out = {}
        for g in self._launches:
            n = len(g.lanes)
            ai = np.full(g.Bp, self._dummy_row, np.int32)
            ms = np.zeros(g.Bp, np.int32)
            me = np.zeros(g.Bp, np.int32)
            ai[:n] = a_idx[g.lanes]
            ms[:n] = m_start[g.lanes]
            me[:n] = m_end[g.lanes]
            self.h2d_round_bytes += ai.nbytes + ms.nbytes + me.nbytes
            with spans.upload(dev):
                ai_d = torch.from_numpy(ai).to(dev).long()
                ms_d = torch.from_numpy(ms).to(dev)[:, None]
                me_d = torch.from_numpy(me).to(dev)[:, None]
            with spans.enqueue(g.rl_host, None, self.al_host, ai):
                g.masked.masked_fill_((g.jcol >= ms_d) & (g.jcol < me_d), 4)
                walk, best, ci, cj = kernels.forward_walk(
                    g.masked, g.rl, self.amat.index_select(0, ai_d),
                    self.alen.index_select(0, ai_d), *self.scoring)
            with spans.span('wait'):
                walk, best, ci, cj = (t.cpu().numpy()
                                      for t in (walk, best, ci, cj))
            res = engine_v2.finish_v2(walk, best, ci, cj, g.rl_host,
                                      self.al_host[ai])
            for f, v in res.items():
                out.setdefault(f, np.zeros(self.B, v.dtype))[g.lanes] = v[:n]
        failed = out['read_start'] == -1
        full_pct = dispatch.seqan_pct_vec(out['matches'], out['full_len'])
        out['full_pct'] = np.where(failed, 0.0, full_pct)
        out['read_end_excl'] = np.where(failed, 0, out['read_end'] + 1)
        return out

    def dummy_row(self) -> int:
        return self._dummy_row
