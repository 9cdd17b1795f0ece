"""The check has to fail: the control (the reference with a broken
guarantee in the program's place) and the faults a cell can have, each
planted under a whole run of the harness on the CPU at a small size."""

import pytest

from pcbench import check, harness
import control

CELLS = ['ligation_nsk007.gamma15k_batch4000',
         'native_barcoding_nbd103.gamma15k_batch4000']
SMALL = dict(reads=12, length_mean=1500, length_sd=1300, chimera_rate=0.3)


def small_cell(name):
    wl, cfg = harness.cell_files(name)
    wl = dict(wl, traffic=dict(wl['traffic'], **SMALL), pool=2)
    return wl, cfg


def run(name, seed=2 ** 31 + 99):
    wl, cfg = small_cell(name)
    return harness.run_cell(name, wl, cfg, ['mbases_per_s'], seed, 0.5,
                            False, device='cpu')


def test_control_fails_the_check(tmp_path, monkeypatch):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    wl, cfg = harness.cell_files(CELLS[0])
    wl = dict(wl, traffic=dict(wl['traffic'], reads=300, length_mean=1000,
                               length_sd=870))
    monkeypatch.setattr(harness, 'cell_files', lambda name: (wl, cfg))
    rows = control.run(CELLS[0], [12], 'cpu')
    assert rows[0]['outputs_wrong'] >= 1 and not rows[0]['correct']


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct(tmp_path, monkeypatch, name):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    res = run(name)
    assert res['correct'] and res['attempted'] >= 1
    assert list(res)[-1] == 'checks'


def _alter_a_record(monkeypatch):
    from porechop_tpu_torch.pipeline import model
    real = model.Read.get_fastq

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        if self.name.endswith('7') and out:
            out = out.replace('A', 'C', 1)
        return out
    monkeypatch.setattr(model.Read, 'get_fastq', altered)


def _drop_half_the_batch(monkeypatch):
    from porechop_tpu_torch import cli
    real = cli.load_reads

    def half(*a, **k):
        reads, check_reads, kind = real(*a, **k)
        return reads[::2], check_reads, kind
    monkeypatch.setattr(cli, 'load_reads', half)


def _skip_end_trimming(monkeypatch):
    from porechop_tpu_torch import cli
    monkeypatch.setattr(cli, 'find_adapters_at_read_ends',
                        lambda *a, **k: [])


def _detect_nothing(monkeypatch):
    from porechop_tpu_torch import cli
    monkeypatch.setattr(cli, 'find_matching_adapter_sets',
                        lambda *a, **k: [])


FAULTS = {'an answer altered where it is produced': _alter_a_record,
          'half of the batch left out': _drop_half_the_batch,
          'a step that returns its state unchanged': _skip_end_trimming,
          'detection finds nothing': _detect_nothing}


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_a_planted_fault_fails_the_check(tmp_path, monkeypatch, fault,
                                         name):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    FAULTS[fault](monkeypatch)
    res = run(name)
    assert res is not None and not res['correct'], res['checks']
    wrong = sum(v['value'] > v['limit'] for v in res['checks'].values())
    assert wrong >= 1


def test_limits_are_exact():
    assert set(check.LIMITS.values()) == {0}
