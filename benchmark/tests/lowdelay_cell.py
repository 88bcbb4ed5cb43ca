"""The low-delay cell that waits on the program (PERF.md, Open questions),
run through `run.run` before `BENCHMARK.json` names it:
`vc2-lowdelay-1080p25-422p10.encode-file`, the mix of
`traffic/encode-file.json` (encode-pan's eight 50-frame pan + noise clips
coded whole through `encode_stream`, two streams and `check_pictures`
(4) pictures of each judged by the configuration's low-delay check).  At
8 bits the configuration's format takes its 8-bit form (full-range
offsets), as the program's 8-bit path codes it."""
import json
import os

import run

CELL = "vc2-lowdelay-1080p25-422p10.encode-file"
CONFIG = "vc2-lowdelay-1080p25-422p10"
EIGHT_BIT = {"bit_depth": 8, "luma_offset": 0, "luma_excursion": 255,
             "chroma_offset": 128, "chroma_excursion": 255}
TRAFFIC = "encode-file"


def load(bit_depth, limits):
    """`run.load_cell`'s tuple for the cell at `bit_depth` (10, as the
    configuration states, or 8), held to `limits`."""
    with open(os.path.join(run.HERE, "configs", CONFIG + ".json")) as f:
        cfg = json.load(f)
    if bit_depth == 8:
        cfg["format"] = dict(cfg["format"], **EIGHT_BIT)
    with open(os.path.join(run.HERE, "traffic", TRAFFIC + ".json")) as f:
        traffic = json.load(f)
    cell = {"name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1}
    return cell, cfg, traffic, dict(limits), [], []


def install(bit_depth, limits, setattr_=setattr):
    """Let `run.load_cell` find the cell by its name."""
    real = run.load_cell
    setattr_(run, "load_cell", lambda name: load(bit_depth, limits)
             if name == CELL else real(name))
