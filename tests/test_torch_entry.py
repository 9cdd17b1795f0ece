"""The port's dry-run entry points (porechop_tpu_torch/entry.py) against
the JAX package's (__graft_entry__.py) on the CPU: the flagship step on
the same example inputs, and the multi-device dry run on CPU device
entries against the JAX package's dry run and mesh functions on the
8-device CPU mesh of tests/conftest.py; and the port's executable
specification of Gotoh schemes (spec.align_affine), which the dry run
checks a lane against, against the JAX package's.  Tolerance: exact
(integers; percent identities are the same round trip of equal
integers)."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from porechop_tpu.ops import spec as jax_spec
from porechop_tpu.ops.dispatch import AlignJobs as JaxAlignJobs
from porechop_tpu.parallel import mesh as jax_mesh
from porechop_tpu_torch import entry
from porechop_tpu_torch.ops import kernels, spec

from .test_torch_cases import FIELDS, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def test_entry_matches_graft_entry():
    """The same example inputs, and the same (walk, best, cell_i, cell_j)
    from the port's forward and walk as from the JAX forward and walker."""
    fn, args = entry.entry('cpu')
    jfn, jargs = jax_entry.entry()
    for a, j in zip(args, jargs):
        assert a.device.type == 'cpu'
        assert np.array_equal(a.numpy(), np.asarray(j))
    for g, w in zip(fn(*args), jfn(*jargs)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_entry_raises_without_a_card(monkeypatch):
    """No quiet fallback: the card is the default device."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        entry.entry()
    with pytest.raises(RuntimeError, match='CUDA'):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize('n_devices', [2, 4])
def test_dryrun_multichip_matches_jax(n_devices):
    """The dry run passes its own checks on CPU entries (one name taken by
    every entry, and a list), and each step's results equal the JAX
    package's on the same batch, whose own dry run passes too."""
    got = entry.dryrun_multichip(n_devices, 'cpu')
    again = entry.dryrun_multichip(n_devices, ['cpu'] * n_devices)
    jax_entry.dryrun_multichip(n_devices)
    reads, rl, adps, al = entry.dry_batch(n_devices)
    mesh = jax_mesh.make_mesh()
    want = jax_mesh.sharded_align(mesh, reads, rl, adps, al)
    for f in FIELDS:
        assert np.array_equal(got['align'][f], want[f]), f
        assert np.array_equal(again['align'][f], want[f]), f
    B = len(reads)
    for g, w in zip(got['detection'], jax_mesh.detection_step(
            mesh, reads, rl, adps, al, (np.arange(B) % 3).astype(np.int32),
            3)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    windows = [reads[k] for k in range(B)]
    adapters = [adps[k] for k in range(4)]
    pairs = np.array([(w, a) for w in range(B) for a in range(4)], np.int64)
    for step, want in (
            ('run', JaxAlignJobs(windows, adapters, pairs).run()),
            ('group_max', JaxAlignJobs(windows, adapters,
                                       pairs).run_group_max(pairs[:, 1], 4)),
            ('stats', JaxAlignJobs(windows, adapters,
                                   pairs).run_stats(prefilter=90.0))):
        for f in want:
            assert np.array_equal(got[step][f], want[f], equal_nan=True), (
                step, f)


def test_dryrun_refuses_a_wrong_entry_count():
    with pytest.raises(ValueError, match='3 device entries named for 2'):
        entry.dryrun_multichip(2, 'cpu,cpu,cpu')


@pytest.mark.parametrize('scheme', [(3, -6, -5, -2), (3, -6, -2, -5),
                                    (20, -30, -5, -2)])
def test_align_affine_matches_jax_spec(scheme):
    """spec.align_affine against the JAX package's align_stats (which its
    own tests hold against SeqAn): random pairs, two-symbol pairs (ties),
    pairs carrying the adapter with an error, and empty inputs."""
    rng = np.random.default_rng(sum(scheme) + 40)
    codes = 'ACGTN'
    for k in range(40):
        r = rng.integers(0, 2 if k % 4 == 0 else 5, int(rng.integers(1, 40)))
        a = rng.integers(0, 2 if k % 4 == 0 else 5, int(rng.integers(1, 18)))
        if k % 3 == 0 and len(r) > len(a) + 2:
            r[2:2 + len(a)] = a
            r[2 + len(a) // 2] = (a[len(a) // 2] + 1) % 4
        got = spec.align_affine(r, a, scheme)
        want = jax_spec.align_stats(''.join(codes[c] for c in r),
                                    ''.join(codes[c] for c in a), scheme)
        assert ([getattr(got, f) for f in FIELDS]
                == [getattr(want, f) for f in FIELDS]), (k, r, a)
    empty = spec.align_affine(np.zeros(0, np.int8), a, scheme)
    assert empty.read_start == -1
    with pytest.raises(ValueError, match='linear'):
        spec.align_affine(r, a, (2, -3, -3, -3))


def test_entry_walk_is_the_kernels_walk():
    """entry's fn walks inside kernels.forward_walk (on the CPU, its plain
    version): the same aggregates as walk_plain on forward_tiled's
    outputs."""
    fn, args = entry.entry('cpu')
    bits, best, ci, cj, vf, hf = kernels.forward_tiled(*args, *entry.SCHEME)
    walk, best2, ci2, cj2 = fn(*args)
    assert torch.equal(walk, kernels.walk_plain(bits, ci, cj, vf, hf))
    assert torch.equal(best, best2) and torch.equal(ci, ci2)
