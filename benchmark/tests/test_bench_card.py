"""One short traced run of the ligation cell on a card, through the command the
driver runs.  Skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
def test_a_traced_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'ligation_nsk007.gamma15k_batch4000', '--seed', str(2 ** 31 + 5),
         '--seconds', '3', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().split('\n')[-1])
    assert res['correct']
    assert res['device']['platform'] == 'gpu'
    assert res['device']['count'] == 1
    assert 0 < res['device']['busy_s'] <= res['device']['window_s']
    assert 0 < res['metrics']['kernels.roofline_share']['value'] <= 100
    assert res['breakdown']['device_ops']
    assert list(res)[-1] == 'checks'
