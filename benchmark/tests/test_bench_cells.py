"""Every cell driven end to end on the CPU at 128x64 (the harness's look
for a card skipped): sound runs come out correct; the control (a setting
that breaks a guarantee the configuration states, in the program's
place) and each fault the cell can have, planted in the program's outputs
where they are produced, come out not correct.
`test_control_on_the_card` runs each cell's control at its own size on
the card, on three seeds.

The tiny runs (128x64, clips of at most 10 frames, the bit rate scaled
to the area) are held to limits of their own (`tiny_limits`): the
committed limit for the exact numbers, and for the others the sound
tiny run's reading with room (`ROOM`), since a 128x64 clip's errors are
not a 1080p clip's.
"""
import json
import os

import numpy as np
import pytest
import torch

import faults
import run

SIZE = (128, 64)
FRAMES = 10      # clips cut to this many frames (a GOP's I, P and B)
SEED = 2**31 + 11
SPEC = json.load(open(os.path.join(run.REPO, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
# room over a sound tiny run's reading, by number; the rate's excess is
# an offset from the target, so it gets an absolute room
ROOM = {"tile_mse_worst": lambda v: 2 * v,
        "rate_excess_worst": lambda v: v + 0.5}
_TINY = {}


def tiny_limits(cell):
    """The cell's limits for 128x64 runs."""
    if cell not in _TINY:
        _, compared = run.run(cell, SEED, 0.2, False, "cpu", size=SIZE,
                              frames=FRAMES)
        committed = run.load_cell(cell)[3]
        _TINY[cell] = {k: (committed[k] if committed[k] == 0
                           else ROOM[k](v)) for k, v, _ in compared}
    return _TINY[cell]


def tiny_run(cell, monkeypatch, control=False, seed=SEED):
    limits = tiny_limits(cell)
    real = run.load_cell
    monkeypatch.setattr(run, "load_cell", lambda name: real(name)[:3]
                        + (limits,) + real(name)[4:])
    return run.run(cell, seed, 0.2, False, "cpu", size=SIZE,
                   control=control, frames=FRAMES)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace, monkeypatch):
    result, compared = tiny_run(cell, monkeypatch, seed=SEED + 1)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "check"
    if trace:
        result, _ = run.run(cell, SEED + 2, 0.2, True, "cpu", size=SIZE,
                            frames=FRAMES)
        assert "breakdown" in result and "window_s" in result["device"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, monkeypatch):
    result, compared = tiny_run(cell, monkeypatch, control=True)
    assert not result["correct"], compared


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[c]])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    tiny_limits(cell)                   # from a sound run, before the fault
    faults.plant(fault, cell, monkeypatch.setattr)
    result, compared = tiny_run(cell, monkeypatch)
    assert not result["correct"], compared


def test_passes_differ():
    """No clip of a mix repeats another, so that a stale stream shows."""
    traffic = json.load(open(os.path.join(run.HERE, "traffic",
                                          "encode-pan.json")))
    traffic["frames"] = 2
    from harness import content
    clips = content.make_clips(traffic, *SIZE, "420", 8, SEED, "cpu")
    assert len(clips) == traffic["passes"]
    firsts = {clips[k][0][0].tobytes() for k in range(len(clips))}
    assert len(firsts) == len(clips)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at 1080p on it")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        result, compared = run.run(cell, seed, 2.0, False, "cuda",
                                   control=True)
        assert not result["correct"], compared
    assert np.isfinite(result["metrics"]["setup_s"]["value"])
