"""The reference against the JAX package on the CPU: its aligner against
the JAX spec's, and its output bytes against the JAX package's CLI on
small files from the frozen generator.  (This file may import the JAX
package; the benchmark's run path may not.)"""

import glob
import os
import random
import subprocess
import sys

import pytest

from generators import porechop_synth
from reference import align as ra
from reference import porechop as rp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _mutate(rng, s, e):
    out = []
    for c in s:
        r = rng.random()
        if r < e * 0.6:
            out.append(rng.choice('ACGT'))
        elif r < e * 0.8:
            continue
        elif r < e:
            out += [c, rng.choice('ACGT')]
        else:
            out.append(c)
    return ''.join(out)


@pytest.mark.parametrize('seed', [1, 2])
def test_aligner_matches_the_jax_spec(seed):
    from porechop_tpu.ops import spec
    rng = random.Random(seed)
    adapters = ['AATGTACTTCGTTCAGTTACGTATTGCT', 'GCAATACGTAACTGAACGAAGT',
                'ACGT', 'GGGGG']
    pairs = []
    for _ in range(600):
        a = (rng.choice(adapters) if rng.random() < 0.5 else
             ''.join(rng.choice('ACGTN') for _ in range(rng.randint(1, 40))))
        body = ''.join(rng.choice('ACGT' if rng.random() < 0.9 else
                                  'ACGTN-')
                       for _ in range(rng.randint(0, 80)))
        k = rng.random()
        r = (_mutate(rng, a, 0.15) + body if k < 0.3 else
             body + _mutate(rng, a, 0.15) if k < 0.6 else
             body[:len(body) // 2] + _mutate(rng, a, 0.2)
             + body[len(body) // 2:] if k < 0.8 else body)
        pairs.append((r, a))
    reads, rl = ra.pack([r for r, _ in pairs], 'cpu')
    adps, al = ra.pack([a for _, a in pairs], 'cpu')
    got = ra.align(reads, rl, adps, al, (3, -6, -5, -2))
    for n, (r, a) in enumerate(pairs):
        w = spec.align_traceback(r, a)
        if w.read_start == -1:
            assert int(got.read_start[n]) == -1
            continue
        assert (int(got.score[n]), int(got.read_start[n]),
                int(got.read_end[n]), int(got.matches[n]),
                int(got.aligned_len[n]), int(got.full_len[n])) == \
            (w.raw_score, w.read_start, w.read_end + 1, w.matches,
             w.aligned_len, w.full_len), (r, a)


def _jax_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, PORECHOP_TPU_FORCE_HOST='1',
               JAX_PLATFORMS='cpu')
    p = subprocess.run([sys.executable, '-m', 'porechop_tpu'] + args,
                       capture_output=True, env=env, cwd=cwd, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    return p.stdout


GAMMA = dict(length_mean=1500, length_sd=1300, start_adapter_rate=0.9,
             end_adapter_rate=0.5)


@pytest.mark.parametrize('seed,lengths', [(5, dict(read_len=1500)),
                                          (2 ** 31 + 7, dict(read_len=1500)),
                                          (8, GAMMA)])
def test_ligation_output_equals_the_jax_package(tmp_path, seed, lengths):
    path = str(tmp_path / 'in.fastq')
    porechop_synth.write(path, dict(kind='ligation', reads=200,
                                    chimera_rate=0.2, **lengths), seed, 0)
    out = rp.run(path, rp.Options(), 'cpu')
    assert out.streams['stdout'] == _jax_cli(['-i', path, '-v', '0'],
                                             str(tmp_path))


def test_gzipped_input_output_equals_the_jax_package(tmp_path):
    path = str(tmp_path / 'in.fastq.gz')
    porechop_synth.write(path, dict(kind='ligation', reads=150,
                                    read_len=1000, gzip_level=1), 3, 1)
    out = rp.run(path, rp.Options(), 'cpu')
    _jax_cli(['-i', path, '-o', 'out.fastq', '-v', '0'], str(tmp_path))
    assert out.streams['stdout'] == open(tmp_path / 'out.fastq', 'rb').read()


@pytest.mark.parametrize('lengths', [dict(read_len=1500), GAMMA],
                         ids=['fixed', 'gamma'])
def test_barcoded_bins_equal_the_jax_package(tmp_path, lengths):
    path = str(tmp_path / 'in.fastq')
    porechop_synth.write(path, dict(kind='barcoded', reads=200,
                                    chimera_rate=0.2, **lengths), 6, 0)
    out = rp.run(path, rp.Options(barcodes=True), 'cpu')
    _jax_cli(['-i', path, '-b', 'bins', '-v', '0'], str(tmp_path))
    want = {os.path.basename(p): open(p, 'rb').read()
            for p in glob.glob(str(tmp_path / 'bins' / '*'))}
    assert out.streams == want
    assert out.orientation == 'reverse'
