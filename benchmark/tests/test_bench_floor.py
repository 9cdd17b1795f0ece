"""The kernels' floor: the same work for a launch whatever instantiation
runs it, and below every time PERF.md's kernel table records."""

import os

import pytest

from pcbench import harness

floor = harness.load_module(os.path.join(harness.BENCH, 'metrics',
                                         'kernel_floor.py'), 'kernel_floor')


def lanes(B, rl, al):
    return B * rl * al, B * rl, B * al


@pytest.mark.parametrize('name', ['forward_score', 'forward_stats',
                                  'forward_walk'])
def test_floor_counts_needed_cells_not_the_padded_launch(name):
    # 512 lanes of 10,000-bp reads against 66-bp adapters, launched at
    # L = 10,240 and at adapter rungs 96 and 128 (AMAX 96 or 128, chunked
    # or not): the floor reads the lanes' own lengths only.
    need = lanes(512, 10_000, 66)
    at96 = floor.floor_s(name, 512, 10_240, 96, *need)
    at128 = floor.floor_s(name, 512, 16_384, 128, *need)
    assert at96 == at128
    assert at96 == pytest.approx(512 * 10_000 * 66 * 3 / floor.INSTR_RATE)


def test_narrow_lanes_count_the_same_work():
    # Rung 24 as 4 lanes a warp (24/8) or one a warp (32/32).
    need = lanes(16_384, 150, 22)
    assert floor.floor_s('forward_score', 16_384, 150, 24, *need) == \
        floor.floor_s('forward_score', 16_384, 150, 32, *need)


# PERF.md section 6, the kernel table: (entry point, lanes, L, A, the
# H100's ms), the change's times where a row gives two.
RECORDED = [
    ('forward_walk', 16_384, 150, 32, 0.2185),
    ('forward_walk', 512, 10_240, 48, 1.2354),
    ('forward_walk', 512, 10_240, 96, 2.1094),
    ('forward_tiled', 128, 262_144, 32, 3.1244),
    ('forward_stats', 1_024, 10_240, 32, 1.3375),
    ('forward_stats', 512, 10_240, 96, 2.6465),
    ('forward_stats', 1_048_576, 150, 24, 6.9796),
    ('forward_stats', 32_768, 150, 48, 0.4942),
    ('forward_score', 1_024, 10_240, 32, 0.9661),
    ('forward_score', 16_384, 10_240, 24, 3.9725),
    ('forward_score', 8_192, 10_240, 48, 3.9291),
    ('forward_score', 16_384, 10_240, 32, 6.4785),
    ('forward_score', 4_096, 10_240, 96, 3.9659),
    ('forward_score', 32_768, 1_024, 48, 1.3233),
    ('forward_score', 1_048_576, 150, 24, 3.0882),
    ('forward_score', 262_144, 150, 24, 0.7878),
]


@pytest.mark.parametrize('name,B,L,A,ms', RECORDED)
def test_floor_lies_below_every_recorded_time(name, B, L, A, ms):
    # Every lane at its launch's full width: the most these shapes need.
    s = floor.floor_s(name, B, L, A, *lanes(B, L, A))
    assert s * 1e3 < ms


def test_roofline_reader_sums_floors_over_kernel_time():
    mod = harness.load_module(os.path.join(harness.BENCH, 'metrics',
                                           'kernels.roofline_share.py'), 'r')
    launch = ('forward_score', 4_096, 10_240, 96) + lanes(4_096, 10_000, 66)
    s = floor.floor_s(*launch)
    assert mod.read({'launches': [launch], 'port_kernel_s': 4 * s}) == \
        pytest.approx(25.0)
    assert mod.read({'launches': [], 'port_kernel_s': 1.0}) is None
