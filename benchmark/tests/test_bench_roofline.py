"""`me_pass_roofline`'s count of the ME's searches equals the smoke run's
bound of kernel #1 (`chip_smoke.refine_bound_ms`) at the seven 1080p
launch shapes of one reference."""
import importlib.util
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metric():
    path = os.path.join(BENCH, "metrics", "me_pass_roofline.py")
    spec = importlib.util.spec_from_file_location("me_pass_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_count_equals_refine_bound_at_the_seven_shapes():
    import chip_smoke
    from schroedinger_tpu_torch.tools import profile_patch_refine as pp
    m = _metric()
    assert len(pp.REFINE_SHAPES) == len(m.SEARCHES_1080P)
    for shape, mine in zip(pp.REFINE_SHAPES, m.SEARCHES_1080P):
        _, nby, nbx, bs, rad, scale, grid = shape
        want_ms, _ = chip_smoke.refine_bound_ms(pp.make_inputs(shape, "cpu"))
        assert (nby, nbx, bs, rad) == mine[:4]
        assert (grid if scale else None) == mine[4]
        assert m.search_bound_s(*mine) * 1e3 == pytest.approx(want_ms,
                                                              rel=1e-12)


def test_share_reads_nothing_without_searches():
    m = _metric()
    assert m.read({"spans": {}, "refs_used": 10}) is None
    row = {"count": 1, "host_s": 1.0, "device_s": 1.0}
    assert m.read({"spans": {"me_pass": row}, "refs_used": 0}) is None
    share = m.read({"spans": {"me_pass": row}, "refs_used": 1})
    assert share == pytest.approx(100 * m.reference_bound_s())
