"""The PyTorch port's trace-bit call with its walk (porechop_tpu_torch/ops/
kernels.py forward_walk; on the CPU its plain version, forward_tiled_plain
then walk_plain) against the JAX package: the Pallas trace-bit kernels in
interpret mode (forward_pallas for windows of one tile, as
tests/test_kernel_pallas.py runs it, and forward_pallas_tiled for long
ones, as tests/test_kernel_tiled.py does) followed by the JAX walker
(engine_v2._traceback) on their own bits; and the whole slice, the CLI,
byte for byte against python -m porechop_tpu, every trace-bit call of the
run a forward_walk call and no standalone walk or forward_tiled call.

Tolerance: exact; every output is an integer.  The JAX kernels window the
H prefix max where the port computes it exactly, so trace bits off the
elected path may differ; the walks of each side's own bits agree.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu.ops import engine_v2 as jax_engine
from porechop_tpu.ops import kernel_pallas
from porechop_tpu_torch.ops import kernels
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import (SCHEME, dp_batch, gap_run_batch,
                               one_torch_thread, plant, to_torch)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _assert_matches_jax(batch, jax_forward):
    """forward_walk on the batch against jax_forward (interpret mode) and
    the JAX walker on its bits: (walk, best, cell_i, cell_j).  Returns the
    port's walk."""
    with pltpu.force_tpu_interpret_mode():
        jbits, jbest, jci, jcj, jvf, jhf = jax_forward(
            *(jnp.asarray(x) for x in batch), *SCHEME)
    jwalk = jax_engine._traceback(jbits, jci, jcj, jvf, jhf)
    got = kernels.forward_walk(*to_torch(*batch), *SCHEME)
    for name, g, w in zip(('walk', 'best', 'cell_i', 'cell_j'), got,
                          (jwalk, jbest, jci, jcj)):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    return got[0]


@pytest.mark.parametrize('seed,B,L,A', [(41, 32, 150, 24), (42, 32, 700, 32),
                                        (0, 128, 120, 24)])
def test_forward_walk_matches_pallas_and_jax_walker(seed, B, L, A):
    """Windows of one of the port's tiles (150 bp: on a card, the walk from
    shared memory), of three tiles (700 bp), and the adversarial gap-run
    lanes, against K1 (_forward_kernel) and the JAX walker."""
    batch = gap_run_batch() if seed == 0 else dp_batch(seed, B, L, A)
    walk = _assert_matches_jax(batch, kernel_pallas.forward_pallas)
    assert (walk[:, 3] > 0).any()                 # matches were walked


def test_forward_walk_matches_pallas_tiled_and_jax_walker():
    """A 2,100 bp window (K2, _tiled_kernel, in 2,048-column tiles) with a
    full adapter copy at its far end and lanes ending at tile edges."""
    L, A = 2100, 17
    reads, rl, adps, al = dp_batch(43, 32, L, A)
    rl[:4] = L, 2047, 2048, 2049
    al[0] = A
    plant(reads, adps, al, 0, L - 3)
    walk = _assert_matches_jax((reads, rl, adps, al),
                               kernel_pallas.forward_pallas_tiled)
    assert walk[0, 3] == A


def _run(main, workdir, args, **kw):
    """Runs a CLI in `workdir` with relative paths (the -v 1 transcript
    prints the output's absolute path); returns (stdout, output bytes)."""
    old = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args, **kw)
        with open(args[args.index('-o') + 1], 'rb') as f:
            return buf.getvalue(), f.read()
    finally:
        os.chdir(old)


def test_cli_walks_inside_each_trace_bit_call(tmp_path, monkeypatch):
    """The slice end to end on the CPU: 16 synthetic 3 kb reads, a third
    chimeric, at -v 1, byte-identical to the JAX package's CLI; the run's
    trace-bit calls (end windows, middle coordinates, replay rounds) all
    go through forward_walk, and neither forward_tiled nor the standalone
    walk is called."""
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(16, 3000, seed=7, chimera_rate=0.3))
    for d in ('jax', 'torch'):
        os.makedirs(tmp_path / d)
    args = ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '1', '-t', '4']
    want = _run(jax_cli.main, tmp_path / 'jax', args)

    calls = []
    forward_walk = kernels.forward_walk

    def spy(reads, *rest):
        calls.append(tuple(reads.shape))
        return forward_walk(reads, *rest)

    def refused(*args):
        raise AssertionError('a trace-bit call outside forward_walk')
    monkeypatch.setattr(kernels, 'forward_walk', spy)
    monkeypatch.setattr(kernels, 'forward_tiled', refused)
    monkeypatch.setattr(kernels, 'walk', refused)
    got = _run(torch_cli.main, tmp_path / 'torch', args, device='cpu')
    assert 'Splitting' in want[0] or 'Discarding' in want[0]
    assert got[1] == want[1]
    assert got[0].replace(str(tmp_path / 'torch'), '<dir>') == \
        want[0].replace(str(tmp_path / 'jax'), '<dir>')
    assert {L for _, L in calls} >= {150}         # phase 2's end windows
