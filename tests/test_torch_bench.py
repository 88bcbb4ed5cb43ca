"""The port's bench entry points against the repo's JAX-side bench, on the
CPU at 128x64.

The content generators equal `bench.py`'s at the same size; the port's
`encode_leg` (bench.py's `bench_ours`: GopEncoder with CONFIG_BENCH, the
biref TM5 CBR encode with B pictures batched) gives the JAX encoder's
stream byte for byte on scene-cut content (cuts at frames 4 and 8, the
last of a subgroup: a cut subgroup of two B pictures coded one at a time
and a one-reference P before each cut), on zoom-and-rotation content
(a full subgroup as one batch) and on bench_rd's clip at a rate the
coder cannot meet (the rate control at its limit), and passes the legs' gates there; the
BD-rate equals `tools/bench_rd.py`'s; the runner prints one JSON line
per leg, each in its own process, and a merged line; a corrupted stream
fails the decode leg; every entry point raises without a card unless it
is asked for the CPU.
"""
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import bench as jbench
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu_torch import bench as tbench
from schroedinger_tpu_torch.slice_config import CONFIG_BENCH, video_format
from schroedinger_tpu_torch.tools import bench_4k, bench_breadth, bench_rd

torch.set_num_threads(1)

W, H = 128, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the runner's legs at 128x64 and the keys each leg's line must hold
RUNNER_ARGS = ["--device", "cpu", "--size", f"{W}x{H}", "--frames", "6",
               "--frames-extra", "6"]
ENCODE_KEYS = {"frames", "fps", "bytes", "padding_bytes", "psnr_db",
               "psnr_min_db", "mix",
               "batches", "searches", "launches", "searches_per_reference",
               "references_checked", "decode_fps_pipelined",
               "decode_fps_per_picture", "bytes_vs_pro_rata", "wall_s"}
LEG_KEYS = {
    "headline": ENCODE_KEYS | {"fps_pass1", "fps_pass2", "passes_equal"},
    "zoomrot": ENCODE_KEYS | {"fps_warm_pass", "passes_equal"},
    "scenecut": ENCODE_KEYS | {"fps_warm_pass", "passes_equal", "cuts",
                               "per_picture_b"},
    "decode": {"frames", "bytes", "decode_fps_pipelined",
               "decode_fps_per_picture", "turns_pipelined",
               "turns_per_picture", "psnr_db", "references_checked",
               "wall_s"}}
CUT_EVERY = 4
# the bitrate of each content held to the JAX encoder; "rd binding" is
# bench_rd's clip at a rate that the coder cannot meet (the rate control
# at its limit, as at the low rates of PROFILE.md §6)
BITRATES = {"scenecut": CONFIG_BENCH["bitrate"],
            "zoomrot": CONFIG_BENCH["bitrate"], "rd binding": 8_000}


def _env(threads=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def _start(argv, work):
    """The runner in its own process on one thread, beside the JAX
    encodes."""
    return subprocess.Popen(
        [sys.executable, "-m", "schroedinger_tpu_torch.bench", *argv,
         *RUNNER_ARGS, "--work", str(work)],
        cwd=REPO, env=_env(threads=1), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Started first, so that they run beside the JAX encodes: the runner
    over all four legs, and the decode leg on a headline stream with
    bytes flipped in its I picture.  {name: (process, work directory)}."""
    work = tmp_path_factory.mktemp("bench")
    bad = tmp_path_factory.mktemp("corrupt")
    run = tbench.encode_leg(tbench.make_frames(6, W, H), torch.device("cpu"),
                            warmup=False, tag="headline")
    stream = bytearray(run.stream)
    for k in range(300, 340):
        stream[k] ^= 0x5A
    (bad / "headline.drc").write_bytes(bytes(stream))
    (bad / "headline.refs.json").write_text(json.dumps(
        {"frames": 6, "size": [W, H], "refs": tbench.ref_digests(run.made)}))
    procs = {"runner": (_start(["--out", str(work / "merged.json")], work),
                        work),
             "corrupt": (_start(["--legs", "decode"], bad), bad)}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def contents(runs):
    """The contents at 128x64 and the JAX encoder's streams of them
    (bench.py's configuration at each one's bitrate), encoded on three
    threads that start with the module: (frames, {name: future})."""
    frames = {"scenecut": tbench.make_frames_scenecut(12, CUT_EVERY, W, H),
              "zoomrot": tbench.make_frames_zoomrot(5, width=W, height=H),
              "rd binding": tbench.make_frames_zoomrot(5, noise=1.0,
                                                       width=W, height=H)}
    with ThreadPoolExecutor(3) as pool:
        yield frames, {name: pool.submit(
            j_gop.GopEncoder(video_format(W, H), **dict(
                CONFIG_BENCH, bitrate=BITRATES[name])).encode_stream, f)
            for name, f in frames.items()}


@pytest.mark.parametrize("name,call", [
    ("pan", lambda m: m.make_frames(5)),
    ("zoomrot", lambda m: m.make_frames_zoomrot(4)),
    ("zoomrot noise 1", lambda m: m.make_frames_zoomrot(4, noise=1.0)),
    ("scenecut", lambda m: m.make_frames_scenecut(13)),
    ("scenecut every 4", lambda m: m.make_frames_scenecut(9, cut_every=4))])
def test_generators_equal_bench(monkeypatch, name, call):
    monkeypatch.setattr(jbench, "W", W)
    monkeypatch.setattr(jbench, "H", H)
    want = call(jbench)
    monkeypatch.setattr(tbench, "W", W)
    monkeypatch.setattr(tbench, "H", H)
    got = call(_Sized(tbench))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    # the mean luma PSNR of the frames against their reversed order
    assert tbench.mean_psnr(got[::-1], got) == jbench.mean_psnr(want[::-1],
                                                                want)


class _Sized:
    """The port's generators at 128x64 (they take the size as arguments;
    bench.py's read its module globals)."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        return lambda *a, **k: fn(*a, width=W, height=H, **k)


def test_root_bench_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import bench; "
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'schroedinger_tpu')) for m in sys.modules), 'jax'; "
            "print('OK')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-2000:]


TOOL_LEGS = {
    "4k-backref": (bench_4k, ["--size", f"{W}x{H}", "--frames", "5"]),
    "4k-biref": (bench_4k, ["--size", f"{W}x{H}", "--frames", "6"]),
    "576i25": (bench_breadth, ["--sd-size", f"{W}x{H}", "--frames", "4"]),
    "720p10-422-intra": (bench_breadth, ["--hd-size", f"{W}x{H}",
                                         "--frames", "4"]),
    "rd": (bench_rd, ["--size", f"{W}x{H}", "--frames", "5",
                      "--bitrates", "200000,800000"])}


@pytest.mark.parametrize("leg", list(TOOL_LEGS))
def test_tool_legs_on_the_cpu(capsys, leg):
    """Each tool's leg, run in place (`--leg`) on the CPU at 128x64:
    its gates hold and it prints its JSON line."""
    module, argv = TOOL_LEGS[leg]
    assert module.main([*argv, "--device", "cpu", "--leg", leg]) == 0
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rep["leg"] == leg and rep["wall_s"] > 0
    if leg == "rd":
        lo, hi = rep["points"]
        assert hi["bytes"] > lo["bytes"] and "bd_rate_vs_jax_pct" not in rep
    elif leg == "720p10-422-intra":
        assert rep["frames"] == 8 and rep["psnr_min_db"] >= 30
    else:
        assert rep["launches"] == 0 and rep["searches"] > 0
        assert rep["mix"] == {"4k-backref": "1 I, 4 P, 0 B",
                              "4k-biref": "1 I, 2 P, 3 B",
                              "576i25": "1 I, 2 P, 5 B"}[leg]


@pytest.mark.parametrize("name", list(BITRATES))
def test_encode_leg_equals_jax(contents, name):
    """encode_leg on the CPU == the JAX GopEncoder byte for byte, and the
    legs' gates hold on its stream."""
    frames, streams = contents
    dev = torch.device("cpu")
    run = tbench.encode_leg(frames[name], dev, BITRATES[name], warmup=False,
                            tag=name)
    assert run.stream == streams[name].result()
    rep = tbench.quality(run, frames[name], name, BITRATES[name])
    kinds = {n: (r, ref) for n, r, ref in tbench.picture_kinds(run.stream)}
    if name == "scenecut":
        # each cut (the last frame of a subgroup) becomes an I picture;
        # the subgroup before it is cut short: a one-reference P and two
        # B pictures coded one at a time
        assert all(kinds[c] == (0, True) for c in (4, 8))
        assert kinds[3] == (1, True) and kinds[7] == (1, True)
        assert [s[:2] for s in run.seen] == [([1, 2], False),
                                             ([5, 6], False),
                                             ([9, 10], False)]
        assert rep["batches"] == 0 and rep["mix"] == "3 I, 3 P, 6 B"
    else:
        assert rep["batches"] == 1 and rep["mix"] == "1 I, 1 P, 3 B"
    if name == "rd binding":
        # over its share with no padding: the rate binds
        assert rep["bytes_vs_pro_rata"] > 1 and rep["padding_bytes"] == 0
    assert rep["searches_per_reference"] == 5    # a 3-level pyramid
    assert rep["launches"] == 0        # the CPU runs the plain search


@pytest.mark.parametrize("deg", [4, 3, 2])
def test_bd_rate_equals_tool(deg):
    rng = np.random.default_rng(deg)
    rate_ref = np.sort(rng.uniform(2e5, 4e6, deg))
    psnr_ref = np.sort(rng.uniform(38, 46, deg))
    rate_test = rate_ref * rng.uniform(0.7, 1.6, deg)
    psnr_test = np.sort(psnr_ref + rng.uniform(-0.5, 0.5, deg))
    want = jbench_rd().bd_rate(rate_ref, psnr_ref, rate_test, psnr_test)
    got = bench_rd.bd_rate(rate_ref, psnr_ref, rate_test, psnr_test)
    assert got == want and np.isfinite(got)
    # disjoint PSNR ranges have no BD-rate
    assert np.isnan(bench_rd.bd_rate(rate_ref, psnr_ref, rate_test,
                                     psnr_ref + 20))


def jbench_rd():
    """tools/bench_rd.py, loaded from its file (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "tools_bench_rd", os.path.join(REPO, "tools", "bench_rd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runner_prints_each_leg(runs):
    proc, work = runs["runner"]
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    legs = [d for d in lines if "leg" in d]
    assert [d["leg"] for d in legs] == list(LEG_KEYS)
    for d in legs:
        assert set(d) - {"leg"} == LEG_KEYS[d["leg"]], d["leg"]
    merged = lines[-1]
    assert "leg" not in merged and merged["device"] == "cpu"
    assert list(merged["legs"]) == list(LEG_KEYS)
    assert merged["value"] == merged["legs"]["headline"]["fps"]
    assert merged == json.loads((work / "merged.json").read_text())
    head = merged["legs"]["headline"]
    assert merged["legs"]["decode"]["bytes"] == head["bytes"]
    assert head["mix"] == "1 I, 2 P, 3 B" and head["batches"] == 1
    assert "record_bytes" not in head    # not the record's settings


def test_decode_leg_fails_on_corrupt_stream(runs):
    proc, _ = runs["corrupt"]
    out, err = proc.communicate(timeout=240)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "leg decode FAILED" in err


@pytest.mark.parametrize("main,argv", [
    (tbench.main, ["--legs", "headline"]),
    (bench_4k.main, []),
    (bench_breadth.main, []),
    (bench_rd.main, [])])
def test_entry_points_need_the_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
