"""The port's allocator tuning (porechop_tpu_torch/utils/malloc_tune.py):
applied once by cli.main, never at import, and not at all under
PORECHOP_TPU_NO_MALLOC_TUNE."""

import os
import subprocess
import sys

import pytest

from porechop_tpu_torch.utils import malloc_tune
from porechop_tpu_torch.version import __version__

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_malloc_tune_applies_once(monkeypatch):
    """configure() succeeds on glibc and is idempotent; under the opt-out
    it does nothing (mallopt is not reached)."""
    monkeypatch.setattr(malloc_tune, '_done', False)
    monkeypatch.delenv('PORECHOP_TPU_NO_MALLOC_TUNE', raising=False)
    assert malloc_tune.configure() is True
    assert malloc_tune.configure() is True
    monkeypatch.setattr(malloc_tune, '_done', False)
    monkeypatch.setenv('PORECHOP_TPU_NO_MALLOC_TUNE', '1')

    def no_libc(*a, **k):
        raise AssertionError('mallopt reached under the opt-out')
    monkeypatch.setattr(malloc_tune.ctypes, 'CDLL', no_libc)
    assert malloc_tune.configure() is False
    assert malloc_tune._done is False


@pytest.mark.parametrize('opt_out', [False, True])
def test_importing_the_port_applies_the_tuning(opt_out):
    """Importing the port (its CLI module included) leaves glibc's
    allocator alone; cli.main applies the tuning, unless opted out."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop('PORECHOP_TPU_NO_MALLOC_TUNE', None)
    if opt_out:
        env['PORECHOP_TPU_NO_MALLOC_TUNE'] = '1'
    r = subprocess.run(
        [sys.executable, '-c', 'import porechop_tpu_torch.cli as cli\n'
         'from porechop_tpu_torch.utils import malloc_tune as m\n'
         'print(m._done)\n'
         'try:\n'
         '    cli.main(["--version"])\n'
         'except SystemExit:\n'
         '    pass\n'
         'print(m._done)'], env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ['False', __version__, str(not opt_out)]
