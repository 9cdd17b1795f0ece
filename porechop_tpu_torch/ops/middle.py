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
`h2d_read_bytes` and `h2d_round_bytes` count every upload.

A round's trace bits take A x lanes x L1p bytes, so the replay set is cut
into launches under the planner's bits budget (dispatch.bits_lanes): lanes
sorted longest first, each launch at its own longest read's window rung.
Lanes do not see each other, so the results are those of one launch; a
set that fits one launch at its longest read's rung runs in one, as in the
JAX package.

Routing (porechop_tpu/ops/middle.py:44-66): phases.
find_adapters_in_read_middles uses this runner when the first replay
round's padded cells clear the planner's hybrid threshold (the rule that
sends any launch to the device), or when PORECHOP_TPU_MIDDLE_DEVICE=1
forces it; =0 forces the host rounds (AlignJobs, whose size route then
decides per launch).  Under PORECHOP_TPU_FORCE_HOST the replay is always
on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import dispatch, engine_v2, kernels


def replay_mode() -> str:
    """'device', 'host', or 'auto' (the threshold rule)."""
    v = os.environ.get('PORECHOP_TPU_MIDDLE_DEVICE', '').strip()
    if v == '1':
        return 'device'
    if v == '0':
        return 'host'
    return 'auto'


def should_use_device(n_lanes: int, max_len: int, max_alen: int) -> bool:
    """Whether a replay set of n_lanes reads (the longest max_len, the
    adapters up to max_alen) replays on the device entries: by
    PORECHOP_TPU_MIDDLE_DEVICE, else when one round's padded cells clear
    dispatch._HYBRID_CELLS, exactly when round 0 itself would have sent
    such a launch to the device.  Never under PORECHOP_TPU_FORCE_HOST."""
    if dispatch.force_host():
        return False
    mode = replay_mode()
    if mode != 'auto':
        return mode == 'device'
    lb = dispatch._bucket_len(max_len)
    amax = dispatch._bucket_adapter_len(max_alen)
    cells = dispatch._bucket_lanes(n_lanes) * (lb + 1) * amax
    return cells >= dispatch._HYBRID_CELLS


class _Launch:
    """The lanes of one launch: their masked reads resident on the device
    at window rung L."""

    def __init__(self, reads, lanes, L, dev):
        self.lanes = lanes                  # indices into the replay set
        self.Bp = dispatch._bucket_lanes(len(lanes))
        mat = np.full((self.Bp, L), 4, np.int8)
        rl = np.ones(self.Bp, np.int32)
        for k, n in enumerate(lanes):
            mat[k, :len(reads[n])] = reads[n]
            rl[k] = max(len(reads[n]), 1)
        self.nbytes = mat.nbytes + rl.nbytes
        self.rl_host = rl
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
        self.A = dispatch._bucket_adapter_len(max(max_alen, 1))

        amat = np.full((len(adapters) + 1, self.A), 4, np.int8)
        alen = np.ones(len(adapters) + 1, np.int32)
        for k, a in enumerate(adapters):
            amat[k, :len(a)] = a
            alen[k] = max(len(a), 1)
        self._dummy_row = len(adapters)
        self.al_host = alen
        # The one and only read-data upload; rounds mask it in place.
        dev = self.device
        self.amat = torch.from_numpy(amat).to(dev)
        self.alen = torch.from_numpy(alen).to(dev)
        self.h2d_read_bytes = amat.nbytes + alen.nbytes
        self.h2d_round_bytes = 0

        lens = np.array([max(len(r), 1) for r in reads], np.int64)
        order = np.argsort(-lens, kind='stable')
        self._launches = []
        lo = 0
        while True:
            L = dispatch._bucket_len(int(lens[order[lo]]) if lo < B else 1)
            n = dispatch.bits_lanes(L, self.A)
            self._launches.append(_Launch(reads, np.sort(order[lo:lo + n]),
                                          L, dev))
            self.h2d_read_bytes += self._launches[-1].nbytes
            lo += n
            if lo >= B:
                break
        self.L = self._launches[0].jcol.shape[0]    # the longest read's rung

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
            ai_d = torch.from_numpy(ai).to(dev).long()
            ms_d = torch.from_numpy(ms).to(dev)[:, None]
            me_d = torch.from_numpy(me).to(dev)[:, None]
            g.masked.masked_fill_((g.jcol >= ms_d) & (g.jcol < me_d), 4)
            walk, best, ci, cj = kernels.forward_walk(
                g.masked, g.rl, self.amat.index_select(0, ai_d),
                self.alen.index_select(0, ai_d), *self.scoring)
            res = engine_v2.finish_v2(walk.cpu().numpy(), best.cpu().numpy(),
                                      ci.cpu().numpy(), cj.cpu().numpy(),
                                      g.rl_host, self.al_host[ai])
            for f, v in res.items():
                out.setdefault(f, np.zeros(self.B, v.dtype))[g.lanes] = v[:n]
        failed = out['read_start'] == -1
        full_pct = dispatch.seqan_pct_vec(out['matches'], out['full_len'])
        out['full_pct'] = np.where(failed, 0.0, full_pct)
        out['read_end_excl'] = np.where(failed, 0, out['read_end'] + 1)
        return out

    def dummy_row(self) -> int:
        return self._dummy_row
