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
on the device tensor before the bitmap forward and walk.  `h2d_read_bytes`
and `h2d_round_bytes` count every upload.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dispatch, engine_v2, kernels


class ReplayRunner:
    """Holds the device-resident masked read tensor for one replay set.

    reads: list of np.int8 code arrays (round-0 first hit already masked).
    adapters: list of np.int8 code arrays (the phase's adapter order).
    """

    def __init__(self, reads, adapters, scoring=(3, -6, -5, -2),
                 device=None):
        if not kernels.supports(scoring):
            raise NotImplementedError('scoring scheme %s: the kernels need '
                                      'gap_open < gap_ext' % (scoring,))
        self.scoring = tuple(int(x) for x in scoring)
        self.device = dispatch.resolve_device(device)
        B = len(reads)
        self.B = B
        self.Bp = dispatch._bucket_lanes(B)
        max_len = max((len(r) for r in reads), default=1)
        self.L = dispatch._bucket_len(max(max_len, 1))
        dispatch.check_window_rung(self.L)
        max_alen = max((len(a) for a in adapters), default=1)
        self.A = dispatch._bucket_adapter_len(max(max_alen, 1))
        self.h2d_read_bytes = 0
        self.h2d_round_bytes = 0

        mat = np.full((self.Bp, self.L), 4, np.int8)
        rl = np.ones(self.Bp, np.int32)
        for k, r in enumerate(reads):
            mat[k, :len(r)] = r
            rl[k] = max(len(r), 1)
        amat = np.full((len(adapters) + 1, self.A), 4, np.int8)
        alen = np.ones(len(adapters) + 1, np.int32)
        for k, a in enumerate(adapters):
            amat[k, :len(a)] = a
            alen[k] = max(len(a), 1)
        self._dummy_row = len(adapters)
        self.rl_host = rl
        self.al_host = alen
        # The one and only read-data upload; rounds mask it in place.
        dev = self.device
        self.masked = torch.from_numpy(mat).to(dev)
        self.rl = torch.from_numpy(rl).to(dev)
        self.amat = torch.from_numpy(amat).to(dev)
        self.alen = torch.from_numpy(alen).to(dev)
        self.h2d_read_bytes += mat.nbytes + rl.nbytes + amat.nbytes \
            + alen.nbytes
        self._jcol = torch.arange(self.L, dtype=torch.int32, device=dev)

    def round(self, a_idx, m_start, m_end):
        """a_idx: (B,) adapter row per lane (use dummy_row() for finished
        lanes); m_start/m_end: the hit region each lane's PREVIOUS round
        found (0/0 when none).  Returns the finish_v2 dict plus 'full_pct'
        and 'read_end_excl'."""
        Bp = self.Bp
        ai = np.full(Bp, self._dummy_row, np.int32)
        ai[:self.B] = a_idx
        ms = np.zeros(Bp, np.int32)
        me = np.zeros(Bp, np.int32)
        ms[:self.B] = m_start
        me[:self.B] = m_end
        self.h2d_round_bytes += ai.nbytes + ms.nbytes + me.nbytes
        dev = self.device
        ai_d = torch.from_numpy(ai).to(dev).long()
        ms_d = torch.from_numpy(ms).to(dev)[:, None]
        me_d = torch.from_numpy(me).to(dev)[:, None]
        self.masked.masked_fill_((self._jcol >= ms_d) & (self._jcol < me_d),
                                 4)
        bits, best, ci, cj, vf, hf = kernels.forward_bitmap(
            self.masked, self.rl, self.amat.index_select(0, ai_d),
            self.alen.index_select(0, ai_d), *self.scoring)
        walk = engine_v2.traceback(bits, ci, cj, vf, hf)
        res = engine_v2.finish_v2(walk.cpu().numpy(), best.cpu().numpy(),
                                  ci.cpu().numpy(), cj.cpu().numpy(),
                                  self.rl_host, self.al_host[ai])
        failed = res['read_start'] == -1
        full_pct = dispatch.seqan_pct_vec(res['matches'], res['full_len'])
        res['full_pct'] = np.where(failed, 0.0, full_pct)
        res['read_end_excl'] = np.where(failed, 0, res['read_end'] + 1)
        return {k: v[:self.B] for k, v in res.items()}

    def dummy_row(self) -> int:
        return self._dummy_row
