"""The port's route for the scoring schemes the CUDA kernels refuse, on the
CPU, against the JAX package: the native Gotoh engine's three C entry
points (porechop_tpu_torch/native) and the linear executable spec
(porechop_tpu_torch/ops/spec.align_linear) against
porechop_tpu.ops.spec.align_stats on seeded random pairs, and the CLI
byte for byte against porechop_tpu.cli.main under both schemes.
Tolerance: exact integers (the score-only entry point on its best score
and degenerate marker), exact bytes."""

import contextlib
import io
import os

import numpy as np
import pytest

import porechop_tpu.cli as jax_cli
from porechop_tpu.ops import spec as jax_spec
from porechop_tpu_torch import native
from porechop_tpu_torch import cli as torch_cli
from porechop_tpu_torch.ops import spec
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import FIELDS, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CODES = 'ACGTN'
GOTOH = [(3, -6, -5, -2), (2, -4, -3, -1), (3, -6, -1, -3)]
LINEAR = (2, -3, -3, -3)


def _cases(seed, n):
    """Random pairs (read 1-99 bp, adapter 1-39 bp), N in two of three,
    every fourth read carrying its adapter with a few substitutions."""
    rng = np.random.default_rng(seed)
    cases = []
    for trial in range(n):
        lr = int(rng.integers(1, 100))
        la = int(rng.integers(1, 40))
        r = rng.integers(0, 5 if trial % 3 else 4, lr).astype(np.int8)
        a = rng.integers(0, 5 if trial % 3 else 4, la).astype(np.int8)
        if trial % 4 == 0 and lr > la:
            pos = int(rng.integers(0, lr - la))
            r[pos:pos + la] = a
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(0, lr))] = rng.integers(0, 4)
        cases.append((r, a))
    return cases


def _want(cases, scoring):
    return [jax_spec.align_stats(''.join(CODES[c] for c in r),
                                 ''.join(CODES[c] for c in a), scoring)
            for r, a in cases]


@pytest.mark.parametrize('entry', native.ENTRY_POINTS)
@pytest.mark.parametrize('scoring', GOTOH)
def test_native_entry_points_match_spec(scoring, entry):
    cases = _cases(sum(abs(s) for s in scoring), 200)
    pairs = np.column_stack([np.arange(len(cases))] * 2)
    res = native.align_batch([r for r, _ in cases], [a for _, a in cases],
                             pairs, scoring, entry=entry)
    for k, want in enumerate(_want(cases, scoring)):
        if entry == 'align_simd_scores':
            assert res[k, 4] == want.raw_score, (k, entry)
            assert (res[k, 0] == -1) == (want.read_start == -1), k
        else:
            got = [int(x) for x in res[k, :8]]
            assert got == [getattr(want, f) for f in FIELDS], (k, entry)


def test_linear_route_matches_spec():
    cases = _cases(11, 120)
    for k, ((r, a), want) in enumerate(zip(cases, _want(cases, LINEAR))):
        got = spec.align_linear(r, a, LINEAR)
        assert ([getattr(got, f) for f in FIELDS]
                == [getattr(want, f) for f in FIELDS]), k


def test_native_refuses_linear_and_spec_refuses_gotoh():
    with pytest.raises(ValueError, match='linear'):
        native.align_batch([np.zeros(4, np.int8)], [np.zeros(2, np.int8)],
                           [(0, 0)], LINEAR)
    with pytest.raises(IndexError):
        native.align_batch([np.zeros(4, np.int8)], [np.zeros(2, np.int8)],
                           [(0, 1)], (3, -6, -2, -5))
    with pytest.raises(ValueError, match='not linear'):
        spec.align_linear(np.zeros(4, np.int8), np.zeros(2, np.int8),
                          (3, -6, -2, -5))


def test_without_gxx_a_refused_gotoh_scheme_raises(tmp_path, monkeypatch):
    """No compiler, no library: the run raises and names the scheme, and
    nothing falls back to another engine."""
    from porechop_tpu_torch.ops import dispatch
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'native')
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match=r'\(3, -6, -2, -5\).*g\+\+'):
        dispatch.AlignJobs([np.zeros(30, np.int8)], [np.zeros(24, np.int8)],
                           [(0, 0)], scoring=(3, -6, -2, -5),
                           device='cpu').run()


def test_library_builds_into_the_checkout():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert native.BUILD_DIR.parts[-2:] == ('build', 'native')


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """A 48-read input for the Gotoh scheme and a 4-read one for the
    linear scheme, whose route (the spec, in Python) takes seconds for a
    few short reads in either package."""
    d = tmp_path_factory.mktemp('torch_native_cli')
    write_fastq(str(d / 'gotoh.fastq'),
                synth_reads(48, 2000, seed=3, chimera_rate=0.3))
    write_fastq(str(d / 'linear.fastq'),
                synth_reads(4, 600, seed=1, chimera_rate=0.5))
    return d


def _run(main, workdir, args, **kw):
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


@pytest.mark.parametrize('verbosity', ['0', '1'])
@pytest.mark.parametrize('name,scheme', [('gotoh', '3,-6,-2,-5'),
                                         ('linear', '2,-3,-3,-3')])
def test_cli_refused_schemes_are_byte_identical(inputs, tmp_path, name,
                                                scheme, verbosity):
    """Both schemes the kernels refuse, through the whole CLI: output and
    transcript equal the JAX package's.  The linear input's split pieces
    are kept (--min_split_read_size 100) so that the output is not
    empty."""
    os.symlink(inputs / (name + '.fastq'), tmp_path / 'reads.fastq')
    for d in ('jax', 'torch'):
        os.makedirs(tmp_path / d)
    args = ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', verbosity,
            '--scoring_scheme', scheme, '--min_split_read_size', '100']
    want = _run(jax_cli.main, tmp_path / 'jax', args)
    got = _run(torch_cli.main, tmp_path / 'torch', args, device='cpu')
    assert want[1]
    if verbosity == '1':
        assert 'Splitting' in want[0]
    assert got[1] == want[1]
    assert got[0].replace(str(tmp_path / 'torch'), '<dir>') == \
        want[0].replace(str(tmp_path / 'jax'), '<dir>')
