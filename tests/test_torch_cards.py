"""What the port's multi-card checks and measurements compute, on the CPU:
chip_smoke.py's per-card launch check, its lane layouts of score and
stats, its count of the replay's launches and its check that the barcoded
run's rung-96 trace-bit calls split, profile_torch.py's busy times and
overlap from a profile's device events, and the card each rank of a
multi-process run takes (multihost.rank_device).  Exact: counts and sums
of integers."""

import collections
import types

import pytest
import torch

import chip_smoke
import profile_torch
from porechop_tpu_torch.ops import kernels, middle
from porechop_tpu_torch.parallel import multihost

CARDS = ['cuda:0', 'cuda:1', 'cuda:2']


def _launches(walk_first, walk_rest=4, others=2):
    """(LAUNCHES, DEVICE_LAUNCHES) of a run over CARDS: every card the same
    score and stats launches and walk_rest forward_walk, the first card
    walk_first."""
    by_device = collections.Counter()
    for c in CARDS:
        by_device[('forward_score', c)] = others
        by_device[('forward_stats', c)] = others
        by_device[('forward_walk', c)] = walk_rest
    by_device[('forward_walk', CARDS[0])] = walk_first
    launches = dict.fromkeys(chip_smoke.ALL_KERNELS, 0)
    for (k, _), n in by_device.items():
        launches[k] += n
    return launches, by_device


def test_check_cards_takes_the_replay_surplus_on_the_first_card():
    launches, by_device = _launches(walk_first=7)
    chip_smoke.check_cards('run', CARDS, launches, by_device,
                           collections.Counter(forward_walk=3))


@pytest.mark.parametrize('fault', ['surplus', 'idle card', 'uneven'])
def test_check_cards_raises(fault):
    launches, by_device = _launches(walk_first=7)
    replayed = collections.Counter(forward_walk=3)
    if fault == 'surplus':
        replayed = collections.Counter(forward_walk=2)
    elif fault == 'idle card':
        by_device[('forward_stats', 'cuda:2')] = 0
    else:
        by_device[('forward_score', 'cuda:1')] += 1
    with pytest.raises(AssertionError):
        chip_smoke.check_cards('run', CARDS, launches, by_device, replayed)


def test_check_cards_passes_one_card():
    """Entries that name one card (cuda:0,cuda:0) have no per-card
    split to hold."""
    launches, by_device = _launches(walk_first=9)
    chip_smoke.check_cards('run', ['cuda:0'], launches, by_device,
                           collections.Counter())


@pytest.mark.parametrize('tiled,ok', [
    ([((256, 10240, 24, 6), 1), ((512, 10240, 96, 2), 53),
      ((65536, 150, 96, 1), 1)], True),
    ([((256, 10240, 96, 2), 106), ((128, 10240, 96, 3), 1)], True),
    ([((256, 10240, 32, 6), 1), ((512, 10240, 96, 1), 53)], False),
    ([((512, 10240, 96, 1), 1), ((256, 10240, 96, 2), 4)], False),
    ([((256, 10240, 24, 6), 1), ((65536, 150, 96, 1), 1)], False)],
    ids=['in memory', 'streamed', 'unsplit', 'one unsplit', 'none'])
def test_check_rung96_split(tiled, ok):
    """chip_smoke.py's check of a barcoded run's trace-bit calls at rung
    10,240 and adapter rung 96: there are some, and every one is split;
    the one-tile end windows at adapter rung 96 do not count."""
    if ok:
        chip_smoke.check_rung96_split('run', tiled)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_rung96_split('run', tiled)


def test_replay_launches_counts_only_inside_rounds(monkeypatch):
    def round_(self, n):
        kernels.LAUNCHES['forward_walk'] += n
        return n
    monkeypatch.setattr(middle.ReplayRunner, 'round', round_)
    monkeypatch.setitem(kernels.LAUNCHES, 'forward_walk', 0)
    runner = object.__new__(middle.ReplayRunner)
    with chip_smoke.replay_launches(kernels) as replayed:
        kernels.LAUNCHES['forward_walk'] += 5         # a planner launch
        assert runner.round(2) == 2
        assert runner.round(1) == 1
    assert replayed == collections.Counter(forward_walk=3)
    assert middle.ReplayRunner.round is round_


def _profile(spans):
    """A stand-in for a torch.profiler profile: CUDA events (card, start
    us, end us), and one CPU event that must be left out."""
    events = [types.SimpleNamespace(
        device_type=torch.autograd.DeviceType.CUDA, device_index=c,
        time_range=types.SimpleNamespace(start=a, end=b))
        for c, a, b in spans]
    events.append(types.SimpleNamespace(
        device_type=torch.autograd.DeviceType.CPU, device_index=-1,
        time_range=types.SimpleNamespace(start=0, end=1000)))
    return types.SimpleNamespace(events=lambda: events)


def test_busy_sums_unions_and_overlap():
    got = profile_torch.busy(_profile([(0, 0, 10), (0, 5, 20), (1, 15, 30),
                                     (0, 40, 50), (1, 45, 60)]))
    assert got['busy_by_card'] == {
        'cuda:0': {'busy_ms': 0.035, 'union_ms': 0.03, 'calls': 3,
                   'first_start_ms': 0.0, 'last_start_ms': 0.04},
        'cuda:1': {'busy_ms': 0.03, 'union_ms': 0.03, 'calls': 2,
                   'first_start_ms': 0.015, 'last_start_ms': 0.045}}
    # Two cards at once in 15-20 and 45-50 us of the 0-60 us span.
    assert got['overlap_share'] == pytest.approx(10 / 60)


def test_busy_of_one_card_never_overlaps():
    got = profile_torch.busy(_profile([(0, 0, 10), (0, 10, 30)]))
    assert got['overlap_share'] == 0.0
    assert got['busy_by_card']['cuda:0']['union_ms'] == pytest.approx(0.03)
    assert profile_torch.busy(_profile([])) == {'busy_by_card': {},
                                              'overlap_share': None}


@pytest.mark.parametrize('cards,want', [(1, [0, 0, 0, 0]), (2, [0, 1, 0, 1]),
                                        (4, [0, 1, 2, 3])])
def test_rank_device_spreads_ranks_over_the_cards(monkeypatch, cards, want):
    """Rank r takes cuda:(r % cards): ranks share a lone card and spread
    over several."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    got = []
    for r in range(4):
        monkeypatch.setattr(multihost, 'rank', lambda r=r: r)
        got.append(multihost.rank_device())
    assert got == [torch.device('cuda', k) for k in want]


@pytest.mark.parametrize('name,A,want', [
    ('forward_score', 24, (4, [1, 4])), ('forward_stats', 16, (4, [1, 4])),
    ('forward_score', 48, (2, [1, 2])), ('forward_stats', 40, (2, [1, 2])),
    ('forward_score', 32, (1, [1])), ('forward_stats', 64, (1, [1])),
    ('forward_walk', 24, (1, [1])), ('forward_tiled', 48, (1, [1]))])
def test_smoke_checks_both_layouts_of_the_narrow_rungs(monkeypatch, name, A,
                                                       want):
    """chip_smoke.layouts: score and stats at adapter rungs 16-24 and 48
    are held in both layouts and timed in lane_group's; other widths and
    the trace-bit kernels in one lane a warp."""
    monkeypatch.setattr(kernels, 'lane_group',
                        lambda name, B, A: kernels.narrow_group(A) or 1)
    assert chip_smoke.layouts(kernels, name, 16384, A) == want
