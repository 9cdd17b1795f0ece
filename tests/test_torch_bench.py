"""bench_torch.py's output contract, in the style of
tests/test_bench_contract.py: the measurement (bench_torch.run_once, the
builds, the input and the card's name) monkeypatched, main()'s JSON lines
checked: the keys, medians and quartiles, vs_baseline against the forced
host, a non-zero exit with no card number when the card's child fails or
an output differs, the --sizes lines and the A/B summary.  One real run
on the CPU (--device cpu) at a few 1 kb reads, and one without a card and
without --device, whose children raise."""

import json
import statistics

import pytest

import bench_torch
import stretch_torch

CARD = 'NVIDIA H100 80GB HBM3, 700.00 W'
JAX_OUT = bench_torch.chip_smoke.OUT_SHA[0]
EMPTY = bench_torch.chip_smoke.STDOUT_SHA[0]
PARTS = [p for p, *_ in stretch_torch.PARTS]


def _record(run_s, wall_s, launches=7, device_mib=250.0, out=JAX_OUT,
            lines=(), busy_s=None):
    return {'run_s': run_s, 'wall_s': wall_s,
            'parts_s': {p: 0.5 for p in PARTS}, 'rss_mib': 900.0 + run_s,
            'device_mib': device_mib, 'launches': launches,
            'busy_s': busy_s, 'timing_lines': list(lines),
            'output_sha256': out, 'stdout_sha256': EMPTY}


TRACED = ['[timing] phase load       0.500s',
          '[timing] enqueued 3 launches in 0.010s',
          '[timing] phase detect     0.400s',
          '[timing] phase endtrim    0.100s',
          '[timing] phase middle     0.300s',
          '[timing] phase output     0.200s']


@pytest.fixture()
def fake_bench(tmp_path, monkeypatch, capsys):
    """bench_torch.main with run_once answering from `card` and `host`
    run times (in order; walls 5 s more), the traced run in 2.1 s;
    returns (rc, JSON lines, calls)."""
    monkeypatch.setattr(bench_torch, 'WORK', tmp_path)
    monkeypatch.setattr(bench_torch, 'build', lambda tree, device=None: None)
    monkeypatch.setattr(bench_torch, 'make_workload',
                        lambda n, read_len, seed: tmp_path / 'reads.fastq')
    monkeypatch.setattr(stretch_torch, 'card', lambda: CARD)

    def main(argv, card=(2.0, 1.0, 3.0, 1.5, 2.5), host=(4.0, 5.0, 3.0),
             card_out=JAX_OUT, fail_card=False, trees=None):
        card, host, calls = list(card), list(host), []

        def run_once(tree, input_path, argv_, env=None, profile=False):
            calls.append((str(tree), argv_, env, profile))
            if env == bench_torch.FORCE_HOST:
                t = host.pop(0)
                return _record(t, t + 5, launches=0, device_mib=0.0)
            if fail_card:
                raise RuntimeError('stretch run of this tree exited 1')
            if env and env.get('PORECHOP_TPU_TIMING'):
                return _record(2.1, 9.0, lines=TRACED)
            if profile:
                return _record(2.0, 9.0, busy_s=0.5)
            t = (trees or {}).get(str(tree), card).pop(0)
            return _record(t, t + 5, out=card_out)
        monkeypatch.setattr(bench_torch, 'run_once', run_once)
        rc = bench_torch.main(argv)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == CARD
        return rc, [json.loads(ln) for ln in lines[1:]], calls
    return main


def test_bench_line_keys_medians_and_baseline(fake_bench):
    # Warm-up 2.0, then card runs 1.0 3.0 1.5 2.5 (--runs 4).
    rc, (line,), calls = fake_bench(['--runs', '4', '--profile'],
                                    card=(2.0, 1.0, 3.0, 1.5, 2.5),
                                    host=(4.0, 5.0, 3.0, 6.0))
    assert rc == 0
    assert {'metric', 'value', 'unit', 'vs_baseline', 'baseline',
            'baseline_value', 'run_s', 'process_reads_per_s', 'process_s',
            'startup_s', 'peak_rss_mib', 'peak_device_mib',
            'baseline_figures', 'phases_s', 'timing_overhead_s',
            'reference_porechop', 'correct', 'card', 'reads',
            'device_busy_s', 'device_idle_share'} <= set(line)
    assert line['unit'] == 'reads/s' and line['reads'] == 8192
    assert line['run_s']['all'] == [1.0, 3.0, 1.5, 2.5]
    assert line['run_s']['median'] == 2.0
    assert (line['run_s']['q1'], line['run_s']['q3']) == (1.375, 2.625)
    assert line['value'] == 8192 / 2.0
    assert line['process_reads_per_s'] == 8192 / 7.0
    assert line['baseline_value'] == 8192 / 4.5
    assert line['vs_baseline'] == pytest.approx(4.5 / 2.0)
    assert line['baseline'] == bench_torch.BASELINE
    assert list(line['startup_s']) == PARTS
    assert line['peak_device_mib'] == 250.0
    assert line['peak_rss_mib'] == 903.0
    assert line['phases_s'] == {'load': 0.5, 'detect': 0.4, 'endtrim': 0.1,
                                'middle': 0.3, 'output': 0.2}
    assert line['timing_overhead_s'] == pytest.approx(2.1 - 2.0)
    assert line['device_idle_share'] == pytest.approx(0.75)
    assert line['reference_porechop']['reads_per_s'] == 57.6
    assert 'not this host' in line['reference_porechop']['measured_on']
    assert 'vs_north_star' not in line
    assert line['correct'] is True
    # The card's runs, then the forced host's, then the traced run.
    envs = [c[2] for c in calls]
    assert envs[:5] == [None] * 5
    assert envs[5:9] == [bench_torch.FORCE_HOST] * 4
    assert envs[9] == {'PORECHOP_TPU_TIMING': '1'} and calls[10][3]
    assert calls[0][1] == ['-i', 'reads.fastq', '-o', 'out.fastq', '-v',
                           '0']


def test_failed_card_child_exits_with_no_card_number(fake_bench):
    """The card's child fails: main raises (a non-zero exit) before any
    JSON line; the host's number stands in for nothing."""
    with pytest.raises(RuntimeError, match='exited 1'):
        fake_bench(['--runs', '2'], fail_card=True)


def test_digest_mismatch_exits_non_zero(fake_bench):
    rc, (line,), _ = fake_bench(['--runs', '2'], card=(1.0, 1.0, 1.0),
                                card_out='0' * 64)
    assert rc != 0 and line['correct'] is False


def test_other_sizes_are_held_against_the_forced_host(fake_bench):
    """Away from the recorded input the forced host's output is the
    reference: equal outputs are correct."""
    rc, (line,), _ = fake_bench(['--reads', '64', '--runs', '2'],
                                card=(1.0, 1.0, 1.0), card_out=JAX_OUT)
    assert rc == 0 and line['correct'] is True
    assert line['reference_porechop'] is None


def test_sizes_lines_and_crossover(fake_bench):
    # 512: card 2.0 vs host 1.0 (host wins); 2048: card 1.0 vs host 3.0.
    rc, lines, calls = fake_bench(['--sizes', '512,2048', '--runs', '1'],
                                  card=(9.0, 2.0, 1.0), host=(1.0, 3.0))
    assert rc == 0
    assert [ln['reads'] for ln in lines[:2]] == [512, 2048]
    assert [ln['card_wins'] for ln in lines[:2]] == [False, True]
    assert lines[1]['card_over_host'] == pytest.approx(3.0)
    assert lines[0]['reference_porechop']['reads_per_s'] == 61.2
    assert lines[2] == {'crossover_reads': 2048,
                        'process_crossover_reads': 2048,
                        'sizes': [512, 2048], 'card': CARD}
    assert sum(1 for c in calls if c[2] is None) == 3   # one warm-up


def test_pairs_alternate_and_summarise(fake_bench, tmp_path):
    other = (tmp_path / 'parent').resolve()
    other.mkdir()
    this = str(bench_torch.ROOT)
    trees = {this: [5.0, 2.0, 1.0, 3.0], str(other): [5.0, 1.5, 2.5, 4.0]}
    rc, lines, calls = fake_bench(['--root', str(other), '--pairs', '3'],
                                  trees=trees)
    assert rc == 0
    assert [c[0] for c in calls] == [this, str(other), this, str(other),
                                     str(other), this, this, str(other)]
    summary = {s['tree']: s for s in lines[-1]['summary']}
    assert summary['this']['run_s']['all'] == [2.0, 1.0, 3.0]
    assert summary['this']['run_s']['median'] == 2.0
    assert summary[str(other)]['run_s']['median'] == 2.5
    assert summary['this']['pairs_won'] == 2
    assert summary[str(other)]['pairs_won'] == 1
    assert lines[-1]['correct'] is True
    assert [ln['pair'] for ln in lines[:-1]] == [0, 0, 1, 1, 2, 2]


def test_spread_of_one_run():
    assert bench_torch.spread([2.5]) == {'median': 2.5, 'q1': 2.5,
                                         'q3': 2.5, 'n': 1, 'all': [2.5]}
    s = bench_torch.spread([4.0, 1.0, 2.0])
    assert s['median'] == statistics.median([4.0, 1.0, 2.0]) == 2.0


def test_bench_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Real fresh processes with --device cpu at 6 x 1 kb reads: the
    card's side on the CPU's plain versions and the forced host agree,
    every phase is timed, and no device number is reported."""
    monkeypatch.setattr(bench_torch, 'WORK', tmp_path)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    rc = bench_torch.main(['--reads', '6', '--read-len', '1000', '--runs',
                           '1', '--device', 'cpu'])
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert rc == 0 and line['correct'] is True
    assert line['device'] == 'cpu' and line['peak_device_mib'] == 0
    assert list(line['phases_s']) == list(bench_torch.PHASES)
    assert line['startup_s']['cuda_context'] < 0.5
    assert line['value'] > 0 and line['baseline_value'] > 0


def test_without_a_card_the_children_raise(tmp_path, monkeypatch, capsys):
    """No card and no --device: the card's child raises (no CUDA device),
    so main raises and prints no JSON line."""
    monkeypatch.setattr(bench_torch, 'WORK', tmp_path)
    monkeypatch.setattr(bench_torch, 'build', lambda tree, device=None: None)
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench_torch.main(['--reads', '2', '--read-len', '1000', '--runs',
                          '1'])
    assert not [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{')]
