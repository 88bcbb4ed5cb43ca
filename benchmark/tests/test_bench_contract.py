"""The benchmark's files against its contract: nothing under benchmark/
imports JAX or the JAX package, the yardstick imports nothing of the
program, and every cell, traffic mix and metric has the files the
harness finds by name."""
import ast
import json
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "schroedinger_tpu"}
PROGRAM = "schroedinger_tpu_torch"
# the only files that may import the program: the system under test's
# adapter, and the tests that hold the yardstick to the program's own
# arithmetic or drive the program against it
MAY_IMPORT_PROGRAM = {"harness/codec.py", "tests/test_bench_roofline.py",
                      "tests/test_bench_cells.py",
                      "tests/test_bench_vc2spec.py",
                      "tests/vc2_conformance.py"}


def _sources():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                yield os.path.relpath(path, BENCH), path


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel,path", sorted(_sources()))
def test_no_jax_and_no_program_in_the_yardstick(rel, path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN, f"{rel} imports {names & FORBIDDEN}"
    if rel not in MAY_IMPORT_PROGRAM:
        assert PROGRAM not in names, f"{rel} imports the program"


def test_every_name_has_its_files():
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert spec["paths"] == ["benchmark"]
    for c in spec["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        for f in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(BENCH, f)), f
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))


def test_every_configuration_names_a_check():
    """A configuration's `check` (the long-GOP one where it names none)
    is one the harness has, and the checks import nothing of the
    program."""
    from harness import check
    configs = os.path.join(BENCH, "configs")
    for f in sorted(os.listdir(configs)):
        cfg = json.load(open(os.path.join(configs, f)))
        assert cfg.get("check", "longgop") in check.CHECKS, f
    names = set(_top_level_imports(os.path.join(BENCH, "harness",
                                                "check.py")))
    assert not names & (FORBIDDEN | {PROGRAM}), names


def test_every_configuration_has_a_control():
    """A control (encoder settings that break a guarantee the
    configuration states) for every configuration, so that its cells'
    control tests can run the moment a cell names it."""
    configs = os.path.join(BENCH, "configs")
    for f in sorted(os.listdir(configs)):
        cfg = json.load(open(os.path.join(configs, f)))
        assert isinstance(cfg.get("control", {}).get("encoder"), dict), f
