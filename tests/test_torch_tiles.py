"""The port's tile sharding (`schroedinger_tpu_torch/parallel/tiles.py`) on
a gloo world of 4 CPU ranks started with spawn, bit for bit against the
JAX package's sharded forms on the 8-device CPU mesh of conftest.py and
its unsharded ops: the wavelet forward of every wavelet and the round
trip (128x64 int16 at depth 2), the half-pel upsample with its halo, the
banded two-reference OBMC render, and the ValueErrors of a tile shorter
than the halo and of a render whose rows do not split.  One world serves
the whole module.  Also the rules of `parallel/group.py`: the backend
(NCCL only where every rank has a GPU of its own) and each rank's
device."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu.ops import obmc as j_obmc
from schroedinger_tpu.ops import wavelet as j_wv
from schroedinger_tpu.parallel import tiles as j_tiles
from schroedinger_tpu.params import Params as JParams
from schroedinger_tpu.video_format import (ChromaFormat as JChroma,
                                           VideoFormat as JVideoFormat)
from schroedinger_tpu.wavelets import Wavelet as JWavelet

from schroedinger_tpu_torch.parallel import group
from schroedinger_tpu_torch.wavelets import Wavelet
from tests import torch_world

WORLD = 4
DEPTH = 2
PIC = (64, 64, 12, 8)     # (W, H, block length, block separation)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.integers(-512, 512, (128, 64)).astype(np.int16)
    plane = rng.integers(0, 255, (64, 32)).astype(np.uint8)
    W, H, _, bsep = PIC
    yb, xb = -(-H // bsep), -(-W // bsep)
    mv = {k: rng.integers(lo, hi, (yb, xb)).astype(np.int32)
          for k, lo, hi in (("dx1", -8, 8), ("dy1", -8, 8), ("dx2", -8, 8),
                            ("dy2", -8, 8), ("pred_mode", 0, 4),
                            ("dc0", -50, 50))}
    ups = [np.asarray(j_obmc.make_halfpel(j_obmc.upsample_plane(
        jnp.asarray(rng.integers(0, 255, (H, W)).astype(np.uint8)))))
        for _ in range(2)]
    return x, plane, mv, ups


@pytest.fixture(scope="module")
def sharded():
    """The inputs and the ranks' outputs, rows concatenated in rank
    order."""
    x, plane, mv, ups = _inputs()
    ranks = group.run_world(torch_world.tiles_rank, WORLD, x, DEPTH, plane,
                            mv, ups, PIC, device="cpu")

    def cat(get):
        return np.concatenate([get(r) for r in ranks], axis=-2)

    out = {"x": x, "plane": plane, "mv": mv, "ups": ups, "ranks": ranks,
           "upsample": cat(lambda r: r["upsample"]),
           "render": cat(lambda r: r["render"]), "forward": {},
           "inverse": {}}
    for w in Wavelet:
        out["forward"][w] = {
            "ll": cat(lambda r: r["forward"][w]["ll"]),
            "levels": [{k: cat(lambda r: r["forward"][w]["levels"][i][k])
                        for k in ("hl", "lh", "hh")} for i in range(DEPTH)]}
        out["inverse"][w] = cat(lambda r: r["inverse"][w])
    return out


def _mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("tile",))


def _jparams():
    W, H, blen, bsep = PIC
    vf = JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                      chroma_format=JChroma.C420)
    p = JParams(video_format=vf, num_refs=2,
                wavelet_filter_index=JWavelet.LE_GALL_5_3, transform_depth=3)
    p.set_default_codeblocks()
    p.set_default_quant_matrix()
    p.xblen_luma = p.yblen_luma = blen
    p.xbsep_luma = p.ybsep_luma = bsep
    return p


def _assert_pyramid(got, want, what):
    np.testing.assert_array_equal(got["ll"], np.asarray(want["ll"]),
                                  err_msg=f"{what} ll")
    for lg, lw in zip(got["levels"], want["levels"]):
        for k in ("hl", "lh", "hh"):
            np.testing.assert_array_equal(lg[k], np.asarray(lw[k]),
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("wavelet", list(Wavelet), ids=lambda w: w.name)
def test_sharded_forward_matches_jax(sharded, wavelet):
    """4 gloo ranks == JAX's shard_map over 8 devices == JAX's unsharded
    forward, every band."""
    mesh = _mesh()
    x = sharded["x"]
    jw = JWavelet(int(wavelet))
    fwd = j_tiles.make_sharded_forward(mesh, DEPTH, jw)
    want = fwd(jax.device_put(jnp.asarray(x),
                              NamedSharding(mesh, P("tile", None))))
    _assert_pyramid(sharded["forward"][wavelet], want,
                    f"{wavelet.name} vs JAX sharded")
    _assert_pyramid(sharded["forward"][wavelet],
                    j_wv.forward(jnp.asarray(x), DEPTH, jw),
                    f"{wavelet.name} vs JAX unsharded")


@pytest.mark.parametrize("wavelet", list(Wavelet), ids=lambda w: w.name)
def test_sharded_roundtrip(sharded, wavelet):
    """The sharded inverse of the sharded forward gives the input back."""
    np.testing.assert_array_equal(sharded["inverse"][wavelet], sharded["x"])


def test_sharded_upsample_matches_jax(sharded):
    mesh = _mesh()
    plane = jnp.asarray(sharded["plane"])
    want = j_tiles.make_sharded_upsample(mesh)(
        jax.device_put(plane, NamedSharding(mesh, P("tile", None))))
    np.testing.assert_array_equal(sharded["upsample"], np.asarray(want))
    np.testing.assert_array_equal(
        sharded["upsample"],
        np.asarray(j_obmc.make_halfpel(j_obmc.upsample_plane(plane))))


def test_banded_render_matches_jax(sharded):
    mesh = _mesh()
    p = _jparams()
    mv = {k: jnp.asarray(v) for k, v in sharded["mv"].items()}
    ups = [jnp.asarray(u) for u in sharded["ups"]]
    want = j_tiles.make_sharded_obmc_render(mesh, p, num_refs=2)(mv, *ups)
    np.testing.assert_array_equal(sharded["render"], np.asarray(want))
    W, H = PIC[:2]
    whole = j_obmc.render_component(
        mv["dx1"], mv["dy1"], mv["dx2"], mv["dy2"], mv["pred_mode"],
        mv["dc0"], ups[0], ups[1], None, p.xblen_luma, p.yblen_luma,
        p.xbsep_luma, p.ybsep_luma, p.mv_precision, p.picture_weight_1,
        p.picture_weight_2, p.picture_weight_bits, H, W)
    np.testing.assert_array_equal(sharded["render"],
                                  np.asarray(whole).astype(np.int16))


def test_short_tile_raises(sharded):
    """A tile whose half is shorter than Fidelity's 4-row halo is refused
    (ValueError naming the height it needs), not gathered."""
    for r in sharded["ranks"]:
        assert "FIDELITY reads 4 rows" in r["short"]
        assert "at least 16" in r["short"]


def test_uneven_render_raises(sharded):
    for r in sharded["ranks"]:
        assert "do not split evenly over 4 ranks" in r["uneven"]


def test_backend_and_device_rules(monkeypatch):
    """NCCL only where every rank has a GPU of its own, gloo otherwise;
    rank r on cuda:(r % device_count), or the CPU when asked; no card and
    no CPU request raises (a rank never falls back to the CPU)."""
    cpu = torch.device("cpu")
    assert group.rank_device(3, "cpu") == cpu
    assert group.choose_backend(4, cpu) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        group.rank_device(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, world, backend in ((4, 4, "nccl"), (8, 4, "nccl"),
                                  (1, 4, "gloo"), (2, 4, "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert group.rank_device(5) == torch.device("cuda", 5 % count)
        assert group.choose_backend(world, torch.device("cuda", 0)) == backend
