"""The PyTorch port stands alone: it imports neither jax nor porechop_tpu,
and its adapter database (the state it carries over from the JAX package)
equals the JAX package's field by field."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

import porechop_tpu.adapters as jax_adapters
import porechop_tpu_torch.adapters as torch_adapters

PKG = pathlib.Path(__file__).resolve().parent.parent / 'porechop_tpu_torch'


def _forbidden(module):
    return module is not None and (
        module.split('.')[0] == 'jax'
        or module.split('.')[0] == 'porechop_tpu')


def _bad_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [(path.name, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module):
                bad.append((path.name, node.module))
    return bad


def test_source_has_no_jax_or_porechop_tpu_import():
    assert not [b for path in sorted(PKG.rglob('*.py'))
                for b in _bad_imports(path)]


@pytest.mark.parametrize('script', ['chip_smoke.py', 'profile_torch.py',
                                    'time_kernels.py'])
def test_card_scripts_have_no_jax_or_porechop_tpu_import(script):
    """The scripts run on the card's machine, which has no jax."""
    assert not _bad_imports(PKG.parent / script)


def test_port_runs_with_jax_and_porechop_tpu_blocked():
    """In a fresh interpreter where importing jax or porechop_tpu fails,
    the port imports every module and aligns on the CPU."""
    code = '\n'.join([
        'import sys',
        "sys.modules['jax'] = None",
        "sys.modules['porechop_tpu'] = None",
        'import numpy as np',
        'import porechop_tpu_torch.cli',
        'from porechop_tpu_torch.ops import dispatch, spec',
        "w = [spec.encode('TTTAATGTACTTCGTTCAGTTACGTATTGCTGGG')]",
        "a = [spec.encode('AATGTACTTCGTTCAGTTACGTATTGCT')]",
        "r = dispatch.AlignJobs(w, a, [(0, 0)], device='cpu').run()",
        "assert r['full_pct'][0] == 100.0, r",
        "loaded = [k for k, v in sys.modules.items() if v is not None",
        "          and k.split('.')[0] in ('jax', 'porechop_tpu')]",
        'assert not loaded, loaded',
        "print('ISOLATED')",
    ])
    env = dict(os.environ)
    env['PYTHONPATH'] = str(PKG.parent)
    r = subprocess.run([sys.executable, '-c', code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and 'ISOLATED' in r.stdout, r.stderr


def _fields(a):
    return (a.name, a.start_sequence, a.end_sequence)


def test_adapter_sets_equal_jax():
    assert ([_fields(a) for a in torch_adapters.ADAPTERS]
            == [_fields(a) for a in jax_adapters.ADAPTERS])


@pytest.mark.parametrize('constructor', [
    'make_full_native_barcode_adapter',
    'make_old_full_rapid_barcode_adapter',
    'make_new_full_rapid_barcode_adapter'])
def test_full_barcode_constructors_equal_jax(constructor):
    # Native barcodes use reverse barcodes, which exist only for 1-12.
    top = 12 if constructor == 'make_full_native_barcode_adapter' else 96
    for i in range(1, top + 1):
        got = getattr(torch_adapters, constructor)(i)
        want = getattr(jax_adapters, constructor)(i)
        assert _fields(got) == _fields(want), i
