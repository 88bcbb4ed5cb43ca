"""The checks that decide `correct`, chosen by the configuration
(`check.CHECKS`), on the CPU at 128x64:

- the low-delay check through the cell that waits on the program
  (`lowdelay_cell`): the program's 8-bit streams read as sound, the
  configuration's control (twice the budget) is read by `budget_off`
  alone, and each planted fault moves its own number (the offset of a
  quarter of the range in the 10-bit path, whichever offset the
  program's 10-bit path takes off);
- the long-GOP check gives encode-pan's tiny run exactly the numbers it
  gave before the checks were dispatched (pinned from a run of the tree
  before the change, at one seed).
"""
import types

import numpy as np
import pytest

import faults
import lowdelay_cell as lc
import run
import vc2spec
from harness import check, content, drive
from harness.codec import Codec

SIZE = (128, 64)
FRAMES = 10
SEED = 2**31 + 31
EXACT = ("lost", "misnumbered", "header", "budget_off")
# the 8-bit path's worst 32x32 tile at 128x64: 8.81 at seed 2**31 + 77,
# and a tile's error swings by its nature
SOUND_TILE = (1.0, 40.0)
LIMITS = {**{k: 0 for k in EXACT}, "tile_mse_worst": 2 * SOUND_TILE[1]}


def lowdelay_run(bit_depth, monkeypatch, seed=SEED, control=False):
    lc.install(bit_depth, LIMITS, monkeypatch.setattr)
    result, compared = run.run(lc.CELL, seed, 0.0, False, "cpu", size=SIZE,
                               frames=FRAMES, control=control)
    return result, {k: v for k, v, _ in compared}


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_eight_bit_streams_are_correct(seed, monkeypatch):
    result, nums = lowdelay_run(8, monkeypatch, seed)
    assert all(nums[k] == 0 for k in EXACT), nums
    assert SOUND_TILE[0] <= nums["tile_mse_worst"] <= SOUND_TILE[1], nums
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 2 * FRAMES


def test_offset_reads_in_the_tiles_alone(monkeypatch):
    """Every source sample raised by 256 of the 10-bit range: streams
    whole, in budget and in number, that decode 256 or more high by the
    standard (65,536 in a tile's error, less what the top clip takes
    off), far above a sound 10-bit tile (16x an 8-bit one's at most)."""
    faults.plant("offset", lc.CELL, monkeypatch.setattr)
    result, nums = lowdelay_run(10, monkeypatch)
    assert all(nums[k] == 0 for k in EXACT), nums
    assert nums["tile_mse_worst"] > 30 * 16 * SOUND_TILE[1], nums
    assert not result["correct"] and result["failed"] == 0


def test_control_is_read_by_the_budget_alone(monkeypatch):
    """The configuration's control, the encoder at twice the stated
    bit rate (scaled with the area, as the budget is): every picture of
    the window is off the budget, and every other number is sound."""
    result, nums = lowdelay_run(8, monkeypatch, control=True)
    assert nums["budget_off"] == result["attempted"] == 2 * FRAMES, nums
    assert all(nums[k] == 0 for k in EXACT if k != "budget_off"), nums
    assert nums["tile_mse_worst"] <= SOUND_TILE[1], nums
    assert not result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("fault,number", [
    ("slice", "tile_mse_worst"), ("stale", "tile_mse_worst"),
    ("drop", "lost"), ("pad", "budget_off"), ("depth3", "header")])
def test_fault_moves_its_own_number(fault, number, monkeypatch):
    faults.plant(fault, lc.CELL, monkeypatch.setattr)
    result, nums = lowdelay_run(8, monkeypatch)
    assert nums[number] > LIMITS[number], nums
    assert not result["correct"]
    if fault == "drop":
        assert result["failed"] == nums["lost"] > 0


@pytest.fixture(scope="module")
def window():
    """(configuration, clips, outputs) of two 8-bit low-delay passes."""
    cfg = lc.load(8, LIMITS)[1]
    fmt = cfg["format"]
    fmt.update(width=SIZE[0], height=SIZE[1],
               budget_bytes=SIZE[0] * SIZE[1] // 4)
    traffic = dict(lc.load(8, LIMITS)[2], frames=6, passes=2)
    clips = content.make_clips(traffic, *SIZE, fmt["chroma"], 8, SEED,
                               "cpu")
    outputs = drive.encode_stream(Codec(cfg, "cpu"), clips, 0.0, "cpu",
                                  min_items=12)[3]
    return cfg, clips, outputs


def _decodes(cfg, clips, outputs, traffic, monkeypatch):
    calls = []
    real = vc2spec.decode_picture

    def counted(data, seq):
        calls.append(data)
        return real(data, seq)
    monkeypatch.setattr(vc2spec, "decode_picture", counted)
    nums, attempted, failed = check.check_lowdelay(
        cfg, clips, outputs, "cpu", [0, 1], traffic, SEED)
    return nums, len(calls)


def test_pictures_drawn_from_the_mix(window, monkeypatch):
    cfg, clips, outputs = window
    nums, n = _decodes(cfg, clips, outputs, {"check_pictures": 4},
                       monkeypatch)
    assert n == 2 * 4 and nums["tile_mse_worst"] > 0
    nums, n = _decodes(cfg, clips, outputs, {}, monkeypatch)
    assert n == 2 * 6, "without the key every picture is decoded"


class _Poison:
    def __getattr__(self, name):
        raise AssertionError("the low-delay check used refcodec")

    __call__ = __getattr__


def test_lowdelay_reads_nothing_of_refcodec(window, monkeypatch):
    for name in ("rbs", "BitReader", "StreamDecoder"):
        monkeypatch.setattr(check, name, _Poison())
    cfg, clips, outputs = window
    nums, attempted, failed = check.check_lowdelay(
        cfg, clips, outputs, "cpu", [1], {"check_pictures": 2}, SEED)
    assert all(nums[k] == 0 for k in EXACT) and failed == 0, nums
    assert attempted == 12


def test_a_picture_twice_is_misnumbered(window):
    cfg, clips, outputs = window
    k, s = outputs[0]
    pos, size, _ = faults._picture_units(s)[2]
    twice = s[:pos + size] + s[pos:pos + size] + s[pos + size:]
    b = bytearray(twice)
    b[pos + size + 5:pos + size + 9] = size.to_bytes(4, "big")
    nums, _, _ = check.check_lowdelay(cfg, clips, [(k, bytes(b))], "cpu",
                                      [0], {"check_pictures": 1}, SEED)
    assert nums["misnumbered"] == 1 and nums["lost"] == 0, nums


def test_interlacing_is_the_formats():
    fmt = dict(lc.load(10, LIMITS)[1]["format"])
    vf = types.SimpleNamespace(
        width=fmt["width"], height=fmt["height"], chroma_format=1,
        frame_rate_numerator=25, frame_rate_denominator=1,
        interlaced_coding=True, **{k: fmt[k] for k in check.RANGE})
    assert check._header_mismatches(vf, fmt) == 1
    assert check._header_mismatches(vf, dict(fmt, interlaced=True)) == 0


# encode-pan's tiny run (128x64, clips of 10 frames, a window of two
# passes) at seed 2**31 + 41, read on the tree before the checks were
# dispatched by the configuration
PINNED = {"numbers": {"lost": 0, "misnumbered": 0, "header": 0,
                      "rate_excess_worst": 1.712947728135679,
                      "tile_mse_worst": 32.302734375},
          "attempted": 20, "failed": 0, "correct": False}


def test_encode_pan_check_is_unchanged():
    result, compared = run.run("dirac-longgop-1080p25-cbr8m.encode-pan",
                               2**31 + 41, 0.0, False, "cpu", size=SIZE,
                               frames=FRAMES)
    assert {k: v for k, v, _ in compared} == PINNED["numbers"]
    assert {k: result[k] for k in ("attempted", "failed", "correct")} == {
        k: PINNED[k] for k in ("attempted", "failed", "correct")}
    assert np.isfinite(result["metrics"]["setup_s"]["value"])
