"""The photon mapper of pathtracer_tpu_torch on a group of ranks
(PPMRenderer(group=, shard_photon_map=), parallel/ppm_ring.py)
on the CPU (the kernels' plain versions), against the same renderer on one
process and against the JAX package's ring.

Multi-rank runs go through parallel.group.spawn: gloo ranks of one thread
each, in new processes that import the port only, joined by a file://
rendezvous under tmp_path. Each module fixture spawns once and renders
every configuration of its world size there. The cornell settings are the
JAX package's sharding tests': 64x64, 1 iteration, 2,000 photons, 3
bounces.

Tolerances, and why:
  - lane ranges, concatenated, against the whole photon trace, and the
    replicated map at world n against a group of one: equal (the samples
    are positional and every lane's path is its own; a group's bands are
    ppm.GROUP_BAND_ROWS rows at any world size, and the chunk gather's
    blocks are of one band's hits, so the bands must be the same);
  - the sharded (True) and ring maps against the replicated one: atol
    1e-6, rtol 1e-4, the JAX package's (tests/test_sharding.py): the flux
    adds the sub-grids' partial sums, which regroups the sum;
  - the ring against the JAX ring on two virtual CPU devices: max |d| <=
    1e-4 and RMSE <= 1e-5, the port's cornell bounds against the JAX
    renderer (tests/test_torch_ppm.py); the emission and scatter take
    sin/cos/acos, which torch and XLA round differently in the last bit."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.io.png import read_png
from pathtracer_tpu.models import cornell as jcornell
from pathtracer_tpu.ppm import PPMRenderer as JPPMRenderer
from pathtracer_tpu_torch import cli, ppm
from pathtracer_tpu_torch.models import cornell, ganesha
from pathtracer_tpu_torch.parallel import group

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402

PPM = "pathtracer_tpu_torch.parallel.ranks:render_ppm"
CORNELL = dict(scene="cornell", width=64, height=64, iterations=1,
               photons=2000, bounces=3)
# 8x520: three bands of a group (256, 256 and 8 rows), so rank 0 of two
# renders bands 0 and 2 and rank 1 band 1
TALL = dict(CORNELL, width=8, height=520)
# the tiny ganesha at 64x32 with the tile kernel: on two ranks the ring's
# bands are 32 rows, so rank 1's band lies past the image
MESH = dict(scene="ganesha", width=64, height=32, iterations=1,
            photons=1200, bounces=3, shard="ring")
KW = dict(iterations=1, photon_count=2000, max_bounces=3, verbose=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process while the module runs, as in
    the spawned ranks: the test workers share the machine's cores, and
    small tensors split over many threads wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_ply(tmp_path_factory):
    verts, faces = uv_sphere(10, 6, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("parallel_ppm") / "tiny_ganesha.ply")
    jply.write_mesh(path, verts, faces)
    return path


@pytest.fixture(scope="module")
def world2(tiny_ply, tmp_path_factory):
    """{name: rank 0's result} of the world-2 renders."""
    specs = {"replicated": dict(CORNELL, shard=False),
             "replicated_tall": dict(TALL, shard=False),
             "sharded": dict(CORNELL, shard=True),
             "ring": dict(CORNELL, shard="ring"),
             "mesh_ring": dict(MESH, ply=tiny_ply)}
    out = group.spawn(PPM, 2, "cpu", None,
                      str(tmp_path_factory.mktemp("rdv2")),
                      list(specs.values()))
    return dict(zip(specs, out))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The replicated maps of world2 on a group of one."""
    specs = {"replicated": dict(CORNELL, shard=False),
             "replicated_tall": dict(TALL, shard=False)}
    out = group.spawn(PPM, 1, "cpu", None,
                      str(tmp_path_factory.mktemp("rdv1")),
                      list(specs.values()))
    return dict(zip(specs, out))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    specs = {"ring": dict(CORNELL, shard="ring"),
             "sharded": dict(CORNELL, shard=True)}
    out = group.spawn(PPM, 4, "cpu", None,
                      str(tmp_path_factory.mktemp("rdv4")),
                      list(specs.values()))
    return dict(zip(specs, out))


def _bits(x):
    """x with float32 as its bit patterns: the dead lanes' deposits hold
    NaN, which torch.equal never finds equal."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _lanes_and_rows(n):
    _, _, lights = cornell.build(1.0, CPU)
    lanes = ppm.photon_lanes(lights, KW["photon_count"])
    lo, hi = ppm.rank_lane_range(lanes, n, 0)
    return lanes, (hi - lo) * KW["max_bounces"]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_lane_ranges_concatenate_to_the_whole_trace(n):
    """make_photon_pass over each rank's lane range: the deposits,
    concatenated along the lane axis and cut to the lanes, equal the whole
    trace's bit for bit, the segments add up, every rank holds the same
    rows, and the valid deposits are the whole trace's as a multiset."""
    scene, _, lights = cornell.build(1.0, CPU)
    args = (scene, lights, KW["photon_count"], KW["max_bounces"])
    whole, _, rows = ppm.make_photon_pass(*args)
    want = whole.deposits(123)
    lanes = ppm.photon_lanes(lights, KW["photon_count"])
    assert rows == lanes * KW["max_bounces"]
    parts, segments = [], 0
    for k in range(n):
        trace, _, rows_k = ppm.make_photon_pass(
            *args, lane_range=ppm.rank_lane_range(lanes, n, k))
        got = trace.deposits(123)
        assert rows_k == got[0].shape[1] * KW["max_bounces"]
        assert rows_k == _lanes_and_rows(n)[1]
        parts.append(got[:4])
        segments += int(got[4])
    for i in range(4):
        cat = torch.cat([p[i] for p in parts], dim=1)[:, :lanes]
        assert torch.equal(_bits(cat), _bits(want[i])), i
    assert segments == int(want[4])
    ok = want[3].reshape(-1)
    rows_a = torch.cat([want[0].reshape(-1, 3), want[2].reshape(-1, 3)],
                       1)[ok].numpy()
    rows_b = np.concatenate([torch.cat([p[0].reshape(-1, 3),
                                        p[2].reshape(-1, 3)], 1)
                             [p[3].reshape(-1)].numpy() for p in parts])
    np.testing.assert_array_equal(rows_a[np.lexsort(rows_a.T)],
                                  rows_b[np.lexsort(rows_b.T)])
    with pytest.raises(ValueError, match="1024"):
        ppm.make_photon_pass(*args, lane_range=(0, 1000))


@pytest.mark.parametrize("name", ["replicated", "replicated_tall"])
def test_replicated_map_equals_a_group_of_one(world1, world2, name):
    """Two ranks, the replicated map: equal to a group of one, bit for
    bit, with the same photon map length (64x64: one band, on rank 0;
    8x520: three bands round-robin, the last of 8 rows); every rank holds
    its own lane range's deposits and returns the same image; one process
    without a group renders the whole image as one band, which regroups
    the gather's sums only."""
    want, got = world1[name], world2[name]
    assert torch.equal(got["img"], want["img"])
    assert float(want["img"].max()) > 0
    assert got["photon_map_lengths"] == want["photon_map_lengths"]
    assert got["deposit_rows"] == [_lanes_and_rows(2)[1]] * 2
    assert want["deposit_rows"] == [_lanes_and_rows(1)[1]]
    assert got["same_on_every_rank"] and want["same_on_every_rank"]
    c = CORNELL if name == "replicated" else TALL
    scene, cam, lights = cornell.build(c["width"] / c["height"], CPU)
    alone = ppm.PPMRenderer(scene, cam, lights, c["width"], c["height"],
                            **KW).render()
    np.testing.assert_allclose(alone.numpy(), want["img"].numpy(),
                               atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("world,mode", [(2, "sharded"), (2, "ring"),
                                        (4, "sharded"), (4, "ring")])
def test_sharded_and_ring_maps_agree_with_replicated(world2, world4, world,
                                                     mode):
    """The sharded and ring maps at world 2 and 4 (4: two ranks trace only
    dead lanes, and the ring's bands are 16 rows) against the replicated
    map: atol 1e-6, rtol 1e-4; the photon map lengths equal; each rank
    holds lanes_r * max_bounces deposit rows and returns the same
    image."""
    want = world2["replicated"]
    got = (world2 if world == 2 else world4)[mode]
    np.testing.assert_allclose(got["img"].numpy(), want["img"].numpy(),
                               atol=1e-6, rtol=1e-4)
    assert float(got["img"].max()) > 0
    assert got["photon_map_lengths"] == want["photon_map_lengths"]
    assert got["deposit_rows"] == [_lanes_and_rows(world)[1]] * world
    assert got["same_on_every_rank"]


def test_mesh_ring_with_a_dead_band_agrees_with_one_device(world2,
                                                           tiny_ply):
    """The tiny ganesha at 64x32 with the tile kernel on a 2-rank ring:
    rank 0's band is the whole image, rank 1's lies past it (its tile maps
    the zero chunk's). Against one process: atol 1e-6, rtol 1e-4."""
    scene, cam, lights, mesh = ganesha.build(tiny_ply, 2.0, CPU)
    rend = ppm.PPMRenderer(scene, cam, lights, 64, 32, iterations=1,
                           photon_count=1200, max_bounces=3, verbose=False,
                           mesh=mesh)
    want = rend.render()
    assert rend.tile_table is not None
    got = world2["mesh_ring"]
    np.testing.assert_allclose(got["img"].numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-4)
    assert float(want.max()) > 0
    assert got["photon_map_lengths"] == [int(n) for n in
                                         rend.photon_map_lengths]


def test_ring_matches_jax_ring(world2):
    """The port's ring on two gloo ranks against the JAX PPMRenderer's
    ring over two virtual CPU devices, the same cornell settings."""
    jscene, jcam, jlights = jcornell.build(1.0)
    want = np.asarray(JPPMRenderer(
        jscene, jcam, jlights, 64, 64, shard_photon_map="ring",
        devices=jax.devices()[:2], **KW).render())
    got = world2["ring"]["img"].numpy()
    d = got - want
    assert float(np.abs(d).max()) <= 1e-4
    assert float(np.sqrt(np.mean(d ** 2))) <= 1e-5


def test_cli_shard_flag_without_torchrun_changes_nothing(tmp_path):
    """Without torchrun there is one process: -shard-photon-map ring
    writes the PNG of the run without the flag."""
    base = ["cornell-box", "-width", "32", "-height", "32", "-iterations",
            "1", "-photon-count", "800", "-max-bounces", "2", "-no-progress",
            "-device", "cpu"]
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    cli.main(base + ["-o", str(a)])
    cli.main(base + ["-shard-photon-map", "ring", "-o", str(b)])
    img = read_png(str(b))
    assert img.shape == (32, 32, 3) and img.max() > 0
    np.testing.assert_array_equal(img, read_png(str(a)))


def test_renderer_refuses_unknown_modes_and_sizes_its_bands():
    """shard_photon_map takes False, True or 'ring'. The bands: the whole
    image without a group; GROUP_BAND_ROWS rows (at most H) at any world
    size for the replicated and sharded maps; the ring's one band per
    rank, ceil(H/n) rows; rounded up to 32 with the tile kernel."""
    scene, cam, lights = cornell.build(1.0, CPU)
    with pytest.raises(ValueError, match="shard_photon_map"):
        ppm.PPMRenderer(scene, cam, lights, 32, 32, shard_photon_map="host")
    tall = ppm.PPMRenderer(scene, cam, lights, 8, 520, **KW)
    ring = ppm.PPMRenderer(scene, cam, lights, 8, 520,
                           shard_photon_map="ring", **KW)
    assert ppm.GROUP_BAND_ROWS == 256
    assert tall._bands(None, False) == (520, 1)
    assert tall._bands(None, True) == (544, 1)
    assert [tall._bands(n, False) for n in (1, 2, 4)] == [(256, 3)] * 3
    assert tall._bands(3, True) == (256, 3)
    assert ring._bands(None, False) == (520, 1)
    assert [ring._bands(n, False) for n in (1, 2, 3)] == [
        (520, 1), (260, 2), (174, 3)]
    assert ring._bands(4, True) == (160, 4)
    assert ring._bands(32, True) == (32, 32)  # the last 15 bands all dead
