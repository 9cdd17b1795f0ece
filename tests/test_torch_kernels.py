"""The PyTorch port's DP forwards (porechop_tpu_torch/ops/kernels.py, their
plain versions on the CPU) against the JAX package's Pallas kernels, run in
interpret mode as tests/test_kernel_pallas.py runs them, and against the
executable spec.

Tolerance: exact.  Every output is an integer.  Trace bits are compared
through what the walker makes of them: the port computes the H prefix max
exactly where the JAX kernels window it, so bits off the elected path may
differ while every walked result agrees.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from porechop_tpu.ops import engine_v2 as jax_engine
from porechop_tpu.ops import kernel_pallas, spec
from porechop_tpu_torch.ops import engine_v2, kernels

from .test_torch_cases import (FIELDS, SCHEME, decode, dp_batch,
                               gap_run_batch, one_torch_thread, to_torch)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SHAPES = [(5, 32, 60, 12), (6, 128, 150, 24), (7, 32, 700, 32)]


def _jax_kernels(batch, scheme):
    with pltpu.force_tpu_interpret_mode():
        score = np.asarray(kernel_pallas.forward_score_pallas(*batch,
                                                              *scheme))
        stats = [np.asarray(x) for x in
                 kernel_pallas.forward_stats_pallas(*batch, *scheme)]
        score_t = stats_t = None
        if batch[0].shape[0] % 128 == 0:
            score_t = np.asarray(kernel_pallas.forward_score_pallas_t(
                *batch, *scheme))
            stats_t = [np.asarray(x) for x in
                       kernel_pallas.forward_stats_pallas_t(*batch, *scheme)]
        bitmap = kernel_pallas.forward_pallas(*batch, *scheme)
    return score, score_t, stats, stats_t, bitmap


def _walk_port(batch, scheme):
    """The port's trace-bit forward + walker + finish on host arrays."""
    reads, rl, adps, al = to_torch(*batch)
    bits, best, ci, cj, vf, hf = kernels.forward_tiled(reads, rl, adps, al,
                                                       *scheme)
    walk = kernels.walk(bits, ci, cj, vf, hf)
    res = engine_v2.finish_v2(walk.numpy(), best.numpy(), ci.numpy(),
                              cj.numpy(), batch[1], batch[3])
    return (best, ci, cj, vf, hf), walk.numpy(), res


@pytest.mark.parametrize('seed,B,L,A', SHAPES + [(0, 128, 120, 24)])
def test_forwards_match_pallas(seed, B, L, A):
    """Score (K5/K6), stats (K3/K4) and the trace-bit forward's elected
    cell (K1) against the interpret-mode Pallas kernels; the last case is the
    adversarial gap-run batch."""
    batch = (gap_run_batch() if seed == 0 else dp_batch(seed, B, L, A))
    score, score_t, stats, stats_t, bitmap = _jax_kernels(batch, SCHEME)
    t = to_torch(*batch)

    got = kernels.forward_score(*t, *SCHEME).numpy()
    assert np.array_equal(got, score)
    if score_t is not None:
        assert np.array_equal(got, score_t)

    got = [x.numpy() for x in kernels.forward_stats(*t, *SCHEME)]
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'matches',
                           'full_len'), got, stats):
        assert np.array_equal(g, w), name
    if stats_t is not None:
        for name, g, w in zip(('best', 'cell_i', 'cell_j', 'matches',
                               'full_len'), got, stats_t):
            assert np.array_equal(g, w), name

    cells, walk, res = _walk_port(batch, SCHEME)
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'vflag', 'hflag'),
                          cells, bitmap[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    jbits, jbest, jci, jcj, jvf, jhf = bitmap
    jwalk = np.asarray(jax_engine._traceback(jbits, jci, jcj, jvf, jhf))
    assert np.array_equal(walk, jwalk)
    jres = jax_engine.finish_v2(jwalk, jbest, jci, jcj, batch[1], batch[3])
    for f in FIELDS:
        assert np.array_equal(res[f], jres[f]), f


@pytest.mark.parametrize('scheme', [SCHEME, (20, -30, -5, -2)])
def test_forwards_match_spec(scheme):
    """All three forwards against spec.align_stats, the arbiter for
    non-default schemes (the JAX kernels' H window is unsafe under
    20,-30,-5,-2; the port's exact H is not)."""
    batch = dp_batch(11, 32, 90, 16)
    t = to_torch(*batch)
    _, _, res = _walk_port(batch, scheme)
    score = kernels.forward_score(*t, *scheme).numpy()
    _, _, _, mat, fl = (x.numpy() for x in kernels.forward_stats(*t,
                                                                 *scheme))
    reads, rl, adps, al = batch
    for k in range(len(rl)):
        want = spec.align_stats(decode(reads[k, :rl[k]]),
                                decode(adps[k, :al[k]]), scheme)
        got = {f: int(res[f][k]) for f in FIELDS}
        assert got == {f: getattr(want, f) for f in FIELDS}, k
        assert (int(score[k]), int(mat[k]), int(fl[k])) == (
            want.raw_score, want.matches, want.full_len), k


def test_plain_bitmap_stays_in_the_walked_region():
    """Lanes of one batch do not see each other: a lane's results and its
    bits in the region the walker reads (rows < adapter_len, columns <=
    read_len) equal those of the lane run alone."""
    batch = dp_batch(3, 32, 80, 20)
    full = kernels.forward_tiled(*to_torch(*batch), *SCHEME)
    for k in (0, 5, 17):
        one = kernels.forward_tiled(*to_torch(*(x[k:k + 1] for x in batch)),
                                    *SCHEME)
        for a, b in zip(full[1:], one[1:]):
            assert a[k] == b[0]
        rows, cols = int(batch[3][k]), int(batch[1][k]) + 1
        assert torch.equal(full[0][:rows, k, :cols], one[0][:rows, 0, :cols])


def test_wrappers_reject_bad_inputs():
    reads, rl, adps, al = to_torch(*dp_batch(1, 4, 20, 8))
    with pytest.raises(TypeError):
        kernels.forward_score(reads.long(), rl, adps, al, *SCHEME)
    with pytest.raises(ValueError):
        kernels.forward_stats(reads, rl[:2], adps, al, *SCHEME)
    with pytest.raises(ValueError):
        kernels.forward_tiled(reads, rl, adps[:3], al, *SCHEME)
    with pytest.raises(ValueError):
        kernels.forward_tiled(reads[None], rl, adps, al, *SCHEME)


def test_walk_rejects_bad_inputs():
    """kernels.walk checks what it is given before it chooses a version:
    types, shapes, contiguity, one device, and a device it serves."""
    bits, _, ci, cj, vf, hf = kernels.forward_tiled(
        *to_torch(*dp_batch(2, 6, 40, 8)), *SCHEME)
    with pytest.raises(TypeError):
        kernels.walk(bits.int(), ci, cj, vf, hf)
    with pytest.raises(TypeError):
        kernels.walk(bits, ci.long(), cj, vf, hf)
    with pytest.raises(ValueError):
        kernels.walk(bits, ci, cj[:3], vf, hf)
    with pytest.raises(ValueError):
        kernels.walk(bits[0], ci, cj, vf, hf)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.walk(bits.transpose(0, 1).contiguous().transpose(0, 1), ci,
                     cj, vf, hf)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.walk(*(t.to('meta') for t in (bits, ci, cj, vf, hf)))
    assert torch.equal(kernels.walk(bits, ci, cj, vf.to(torch.uint8),
                                    hf.to(torch.uint8)),
                       kernels.walk(bits, ci, cj, vf, hf))


def test_score_prefilter_coef_matches_jax():
    for thr in (50.0, 75.0, 85.0, 90.0, 96.0):
        for scheme in (SCHEME, (1, -1, -2, -1), (0, -1, -2, -1)):
            assert kernels.score_prefilter_coef(thr, *scheme) == \
                kernel_pallas.score_prefilter_coef(thr, *scheme)
