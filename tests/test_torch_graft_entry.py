"""The port's driver entry points (`schroedinger_tpu_torch/graft_entry.py`)
on the CPU: entry() against the JAX package's `__graft_entry__.entry()`
on the same frame, the dry run's stages 1-3 over a gloo world of 4 ranks,
and one run of stage 4 (two worker processes at 64x64) whose merged
stream is the JAX package's single-process sharded encode of the same
clip byte for byte."""
import importlib.util
import os

import numpy as np
import torch

from schroedinger_tpu.parallel import gops as j_gops

from schroedinger_tpu_torch import graft_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *parts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(outs):
    return list(outs[:3]) + [a for agg in outs[3:] for a in agg]


def test_entry_matches_jax():
    """The low-delay analysis of the CIF frame: every output (slices, the
    per-base bit sums and last nonzero positions) equal to JAX's."""
    jfn, jargs = _load("jax_graft_entry", "__graft_entry__.py").entry()
    want = _flat(jfn(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    for a, ja in zip(args, jargs):
        assert torch.equal(a, torch.from_numpy(ja))
    got = _flat(fn(*args))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(np.array(w)))


def test_dryrun_multichip_stages_1_to_3():
    """Frames-within-GOP (every rank's B picture == rank 0's batched
    step), tiles and GOP sharding, over 4 gloo ranks."""
    reports = graft_entry.dryrun_multichip(4, stages=(1, 2, 3),
                                           device="cpu")
    assert reports[1]["launches"] == [0, 0, 0, 0]   # the plain ME on CPU
    assert reports[1]["batch_ms"] is None
    assert reports[3]["bytes"] > 0


def test_dryrun_stage_4_matches_jax():
    """Two worker processes gather and merge: the stream equals JAX's
    single-process sharded encode of the JAX worker's clip."""
    merged = graft_entry.dryrun_multichip(2, stages=(4,),
                                          device="cpu")[4]["stream"]
    jmw = _load("jax_multihost_worker", "tools", "multihost_worker.py")
    want = j_gops.encode_gops_sharded(jmw.make_frames(), jmw.make_encoder,
                                      n_shards=2, sequential=True,
                                      exact=False)
    assert merged == want
