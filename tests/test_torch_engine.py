"""The PyTorch port's walker (porechop_tpu_torch/ops/kernels.py walk, on
the CPU its plain version), finishers and group reductions
(porechop_tpu_torch/ops/engine_v2.py) against the JAX package's
(porechop_tpu/ops/engine_v2.py) on the same inputs.  Tolerance: exact (all
integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porechop_tpu.ops import engine_v2 as jax_engine
from porechop_tpu_torch.ops import engine_v2, kernels

from .test_torch_cases import (FIELDS, SCHEME, dp_batch, gap_run_batch,
                               one_torch_thread)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize('seed,B,L,A', [(21, 32, 90, 16), (22, 64, 150, 24),
                                        (0, 128, 120, 24)])
def test_walker_and_finish_on_jax_bits(seed, B, L, A):
    """Walk the SAME trace bits (the JAX jnp forward's) with both walkers:
    all 10 aggregates, the 8 finish_v2 fields and the device stats
    finisher must agree."""
    batch = gap_run_batch() if seed == 0 else dp_batch(seed, B, L, A)
    reads, rl, adps, al = batch
    bits, best, ci, cj, vf, hf = (np.array(x) for x in jax_engine._forward(
        reads, rl, adps, al, *SCHEME))
    jwalk = np.asarray(jax_engine._traceback(bits, ci, cj, vf, hf))
    walk = kernels.walk(torch.from_numpy(bits), torch.from_numpy(ci),
                        torch.from_numpy(cj), torch.from_numpy(vf),
                        torch.from_numpy(hf)).numpy()
    assert np.array_equal(walk, jwalk)

    res = engine_v2.finish_v2(walk, best, ci, cj, rl, al)
    jres = jax_engine.finish_v2(jwalk, best, ci, cj, rl, al)
    for f in FIELDS:
        assert np.array_equal(res[f], jres[f]), f

    got = engine_v2.finish_stats_device(
        torch.from_numpy(walk), torch.from_numpy(best), torch.from_numpy(ci),
        torch.from_numpy(cj), torch.from_numpy(rl), torch.from_numpy(al))
    want = jax_engine._finish_stats_device(jnp.asarray(jwalk), best, ci, cj,
                                           rl, al)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_groupmax_reduce_matches_jax():
    """Exact-fraction group max: the pinned ties of
    tests/test_engine_v2.py (2/4 == 3/6 elects (3, 6) whole; no ok lane
    gives (0, 0)), then a fuzz against the JAX reduction."""
    gm, gl = engine_v2.groupmax_reduce(
        torch.tensor([2, 3, 5, 2, 9], dtype=torch.int32),
        torch.tensor([4, 6, 7, 3, 9], dtype=torch.int32),
        torch.tensor([True, True, True, True, False]),
        torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32), 3)
    assert gm.tolist() == [3, 5, 0] and gl.tolist() == [6, 7, 0]

    rng = np.random.default_rng(7)
    n_groups, B = 16, 512
    m = rng.integers(0, 300, B).astype(np.int32)
    ln = np.maximum(m, rng.integers(1, 2000, B)).astype(np.int32)
    ln[::7] = 2 * m[::7] + 2         # many exact-fraction ties
    m[::7] = m[::7] + 1
    okv = rng.random(B) < 0.9
    g = rng.integers(0, n_groups, B).astype(np.int32)
    got = engine_v2.groupmax_reduce(torch.from_numpy(m), torch.from_numpy(ln),
                                    torch.from_numpy(okv),
                                    torch.from_numpy(g), n_groups)
    want = jax_engine._groupmax_reduce(jnp.asarray(m), jnp.asarray(ln),
                                       jnp.asarray(okv), jnp.asarray(g),
                                       n_groups)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_group_scoremax_reduce_matches_jax():
    rng = np.random.default_rng(8)
    n_groups, B = 12, 300
    best = rng.integers(-50, 200, B).astype(np.int32)
    ok = rng.random(B) < 0.8
    g = rng.integers(0, n_groups, B).astype(np.int32)
    g[:5] = n_groups                  # pad lanes fold into the dummy slot
    got = engine_v2.group_scoremax_reduce(torch.from_numpy(best),
                                          torch.from_numpy(ok),
                                          torch.from_numpy(g), n_groups)
    want = jax_engine._group_scoremax_reduce(jnp.asarray(best),
                                             jnp.asarray(ok), jnp.asarray(g),
                                             n_groups)
    assert np.array_equal(got.numpy(), np.asarray(want))
