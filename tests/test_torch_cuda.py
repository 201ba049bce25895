"""The CUDA kernels of pathtracer_tpu_torch against their plain PyTorch
versions, on the card. These tests need an NVIDIA GPU and nvcc, and skip
without them. This file imports no JAX (the machine with the card has none),
so it runs there without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: the kernels are built without FMA contraction and fast math,
so they round every operation as their plain versions do: the fused bounce
and compaction must equal their plain versions exactly (state, radiance,
alive flags, offsets). The small render is held to the budget of
tests/test_golden.py, and to the CPU render of the same image: the same
segments, and pixels within 1e-4. The CPU's vectorised sin/cos differ from
CUDA's in the last bit, and the film's convolution sums in another order;
measured on an H100: equal segments, 7 of 12,800 pixels apart, by at most
4.3e-6."""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import Renderer, make_render_fn
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk

ROOT = os.path.join(os.path.dirname(__file__), "..")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_fused_bounce_kernel_matches_plain(dev):
    scene, cam, bg = shirley.build(2.0, dev)
    r = Renderer(scene, cam, bg, 128, 64, 1, 3, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    for b in range(3):
        args = (r.sph_table, state, r.pack_table, off,
                r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad)
        kw = dict(bg_mode=bg[0], origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None)
        before = fbk.fused_bounce.launches
        st_k, rad_k = fbk.fused_bounce(*args, **kw)
        assert fbk.fused_bounce.launches == before + 1
        st_p, rad_p = fbk.fused_bounce_plain(*args, **kw)
        assert torch.equal(st_k, st_p), (st_k - st_p).abs().max()
        assert torch.equal(rad_k, rad_p), (rad_k - rad_p).abs().max()
        state, rad = st_k, rad_k


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
def test_compact_kernel_bit_identical(dev, frac):
    rng = np.random.default_rng(int(frac * 100))
    rows = 40
    state = rng.standard_normal((10, rows, 128)).astype(np.float32)
    state[9] = rng.random((rows, 128)) < frac
    off = rng.integers(-2 ** 31, 2 ** 31, size=(rows, 128), dtype=np.int64)
    state = torch.from_numpy(state).to(dev)
    off = torch.from_numpy(off.astype(np.int32)).to(dev)
    got = ck.compact_blocks(state, off)
    want = ck.compact_blocks_plain(state, off)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_wrappers_refuse_malformed_input(dev):
    state = torch.zeros(10, 8, 128, device=dev)
    with pytest.raises(ValueError):
        ck.compact_blocks(state, torch.zeros(8, 128, dtype=torch.int64,
                                             device=dev))
    with pytest.raises(ValueError):
        ck.compact_blocks(state[:, :7], torch.zeros(7, 128, dtype=torch.int32,
                                                    device=dev))
    sph = torch.zeros(4, 8, device=dev)
    pack = torch.zeros(10, 1, 128, device=dev)
    off = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    rad = torch.zeros(3, 8, 128, device=dev)
    limbs = np.zeros((2, 2), np.uint32)
    bgc = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    with pytest.raises(ValueError):  # radiance on the CPU
        fbk.fused_bounce(sph, state, pack, off, limbs, bgc, rad.cpu(),
                         bg_mode=1, origin_zero=False)
    with pytest.raises(ValueError):  # not contiguous
        fbk.fused_bounce(sph, state.transpose(1, 2).contiguous()
                         .transpose(1, 2), pack, off, limbs, bgc, rad,
                         bg_mode=1, origin_zero=False)


def test_card_render_equals_cpu_render(dev):
    """The same 160x80 spp=2 render through the kernels on the card and
    through their plain versions on the CPU."""
    scene, cam, bg = shirley.build(2.0, dev)
    fbk.fused_bounce.launches = ck.compact_blocks.launches = 0
    img_k, segs_k = make_render_fn(cam, bg, 160, 80, 2, 8, dev)(scene)
    assert fbk.fused_bounce.launches > 0 and ck.compact_blocks.launches > 0
    cpu = torch.device("cpu")
    scene_c, cam_c, bg_c = shirley.build(2.0, cpu)
    img_c, segs_c = make_render_fn(cam_c, bg_c, 160, 80, 2, 8, cpu)(scene_c)
    assert segs_k == segs_c
    assert (img_k.cpu() - img_c).abs().max() <= 1e-4


def test_small_render_on_card_matches_golden(dev):
    g = np.load(os.path.join(ROOT, "scenes", "golden_shirley_160x80_spp4.npz"))
    scene, cam, bg = shirley.build(2.0, dev)
    fbk.fused_bounce.launches = ck.compact_blocks.launches = 0
    img, segs = make_render_fn(cam, bg, 160, 80, 4, 8, dev)(scene)
    assert fbk.fused_bounce.launches > 0 and ck.compact_blocks.launches > 0
    img = img.cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(np.mean((img - g["img"]) ** 2)))
    assert rmse < 2.5e-3, rmse
    assert abs(segs - int(g["segments"])) < 100, segs
