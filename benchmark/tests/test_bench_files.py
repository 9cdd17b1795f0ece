"""BENCHMARK.json's cells, configurations and metrics load by name, and
each metric's reader declares what BENCHMARK.json says of it."""

import json
import os

import pytest

from pcbench import harness

BENCH = harness.BENCH
SPEC = json.load(open(os.path.join(harness.ROOT, 'BENCHMARK.json')))


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files_load_by_name(cell):
    wl, cfg = harness.cell_files(cell)
    entry = [w for w in SPEC['workloads'] if w['name'] == cell][0]
    assert wl['config'] == entry['config'] == cfg['name']
    assert wl['chips'] == entry['chips']
    assert wl['why'] == entry['why']
    gen = harness.load_module(os.path.join(BENCH, 'generators',
                                           wl['generator'] + '.py'), 'g')
    assert callable(gen.write)
    assert wl['output'] in ('stdout', 'file', 'bins')
    assert (wl['output'] == 'bins') == bool(
        cfg['reference_options'].get('barcodes'))


@pytest.mark.parametrize('entry', SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_reader_declares_its_entry(entry):
    mod = harness.load_module(os.path.join(BENCH, 'metrics',
                                           entry['name'] + '.py'), 'm')
    assert mod.UNIT == entry['unit']
    assert mod.SOURCE == entry['source']
    if 'layer' in entry:
        assert mod.LAYER == entry['layer']
        assert mod.MOVES == entry['moves']
    assert mod.read({}) is None


@pytest.mark.parametrize('cfg', SPEC['configs'], ids=lambda c: c['name'])
def test_config_file(cfg):
    data = json.load(open(os.path.join(harness.ROOT, cfg['file'])))
    assert data['name'] == cfg['name']
    assert data['source'] == cfg['source']
    assert data['reduced'] == cfg['reduced']


def test_cell_metrics_follow_workloads_keys():
    cell = SPEC['workloads'][0]['name']
    names = harness.cell_metrics(SPEC, cell, traced=False)
    assert names == [m['name'] for m in SPEC['end_to_end']]
    traced = harness.cell_metrics(SPEC, cell, traced=True)
    assert 'kernels.roofline_share' in traced


def test_pool_follows_the_seed(tmp_path):
    wl, _ = harness.cell_files(SPEC['workloads'][0]['name'])
    wl = dict(wl, traffic=dict(wl['traffic'], reads=5, length_mean=300,
                               length_sd=260))
    gen = harness.load_module(os.path.join(BENCH, 'generators',
                                           wl['generator'] + '.py'), 'g')
    big = 2 ** 31 + 12345
    (tmp_path / 'a').mkdir()
    (tmp_path / 'b').mkdir()
    a = harness.make_pool(gen, wl, big, str(tmp_path / 'a'))
    b = harness.make_pool(gen, wl, big, str(tmp_path / 'b'))
    assert [open(p, 'rb').read() for p, _, _ in a] == \
        [open(p, 'rb').read() for p, _, _ in b]
    assert open(a[0][0], 'rb').read() != open(a[1][0], 'rb').read()


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_every_seed_gets_the_same_lengths(tmp_path, cell):
    """The bodies' lengths are the gamma's quantiles, the same set in every
    file of every seed; only their order follows the seed."""
    wl, _ = harness.cell_files(cell)
    tr = wl['traffic']
    gen = harness.load_module(os.path.join(BENCH, 'generators',
                                           wl['generator'] + '.py'), 'g')
    lengths = gen.body_lengths(tr, tr['reads'])
    assert abs(lengths.mean() / tr['length_mean'] - 1) < 0.001
    assert abs(lengths.std() / tr['length_sd'] - 1) < 0.01
    small = dict(tr, reads=200, length_mean=800, length_sd=700)
    want = sorted(gen.body_lengths(small, 200).tolist())
    for seed in (1, 2 ** 31 + 3):
        rng = gen.file_rng(seed, 0)
        bodies, _ = gen._blocks(rng, rng.permutation(
            gen.body_lengths(small, 200)), 0)
        assert sorted(len(x) for x in bodies) == want
