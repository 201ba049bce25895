"""The port's wavefront at 16 bounces, the depth of the HQ configuration
(bench.py's spp = 512, 16 bounces), on the CPU. Past 8 bounces the port
compacts the lanes at bounces 2 and 4 (_default_compact_at), so it runs
two compactions, both over the full width, and a two-link _to_orig
chain.

  - trace_wavefront (the kernels' plain versions) against the JAX
    _trace_pallas2 with its Pallas kernels in interpret mode, on the
    seed-42 shirley scene, 64x64 rays from the origin (the size of
    tests/test_torch_render.py's 6-bounce test). The JAX side runs without
    its compaction (compact_at=()): its compaction moves lanes, not
    values (the two gave equal radiance and segments at 64x32, 16
    bounces), and in interpret mode it cost ~210 s at 64x32.
    Tolerances, those of the 6-bounce test, and why: the per-bounce FMA
    differences of tests/test_torch_fused_bounce.py compound over
    bounces, and a lane whose path flips (another sphere or another alive
    flag) changes its pixel outright. Held: segment counts within 0.1%,
    at most 1% of pixels off by more than 1e-3, and the mean radiance
    within 1e-3 relative. Measured: 11,075 vs 11,085 segments, 14 of 4,096
    pixels off, mean radiance +6.1e-6 relative. (At 64x32 the segments
    were 5,292 vs 5,298, one segment past 0.1% of so few: 9 of 2,048
    lanes flipped.)
  - the same 16-bounce wavefront of the port with compaction at (2, 4),
    at (3,) and with none: equal bit for bit, since each lane's result
    does not depend on where the compaction moves it."""

import numpy as np
import jax.numpy as jnp
import torch

from pathtracer_tpu.integrator import _trace_pallas2
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.lds import Sampler as JSampler
from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
from pathtracer_tpu_torch.ops.cuda import shade_kernel as tshk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as tsk
from pathtracer_tpu_torch.ops.lds import Sampler

CPU = torch.device("cpu")
W, H, B = 64, 64, 16


def test_trace_wavefront_16_bounces_matches_pallas(monkeypatch):
    assert integrator._default_compact_at(B) == (2, 4)
    jscene, cam, background = jshirley.build(W / H)
    jsampler = JSampler(2 + 2 * B)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    offset = jnp.asarray((ys * W + xs).reshape(-1).astype(np.uint32))
    cx = (jnp.asarray(xs.reshape(-1), jnp.float32)
          + jsampler.get(offset, 0)) / W
    cy = 1.0 - (jnp.asarray(ys.reshape(-1), jnp.float32)
                + jsampler.get(offset, 1)) / H
    d = cam.ray_dirs(cx, cy, jnp.float32).reshape(-1, 3)
    want_rad, want_segs = _trace_pallas2(jscene, jsampler, jnp.zeros_like(d),
                                         d, offset, B, background, None,
                                         compact_at=(), interpret=True)
    want_rad = np.asarray(want_rad)

    compactions, links = [], []
    compact, to_orig = ck.compact_blocks, integrator._to_orig
    monkeypatch.setattr(ck, "compact_blocks", lambda *a: compactions.append(
        a[0].shape) or compact(*a))
    monkeypatch.setattr(integrator, "_to_orig", lambda rad, chain: links.append(
        len(chain)) or to_orig(rad, chain))
    scene, _, bg = shirley.build(W / H, CPU)
    state = integrator.initial_state(torch.from_numpy(np.array(d)),
                                     torch.ones(W * H, dtype=torch.bool))
    off = torch.from_numpy(np.array(offset).view(np.int32)).reshape(-1, 128)
    rad, segs = integrator.trace_wavefront(
        tsk.pack_spheres(scene.center, scene.radius, scene.valid),
        tshk.pack_material_tables(scene.shade_pack), state, off,
        Sampler(2 + 2 * B), B, bg, origin_zero=False)
    got = rad.reshape(3, -1).T.numpy()
    # compactions before bounces 2 and 4, both over every row (the pass
    # keeps its width); the flushes at each and at the end walk chains of
    # 0, 1 and 2 links
    assert len(compactions) == 2 and compactions[1] == compactions[0]
    assert links == [0, 1, 2]

    segs, want_segs = int(segs), int(want_segs)
    assert segs > 2 * W * H
    assert abs(segs - want_segs) <= 1e-3 * want_segs, (segs, want_segs)
    bad = (np.abs(got - want_rad) > 1e-3).any(axis=1)
    assert bad.mean() <= 0.01, (bad.sum(), np.abs(got - want_rad).max())
    assert abs(got.mean() / want_rad.mean() - 1) < 1e-3, (got.mean(),
                                                           want_rad.mean())


def test_compaction_chain_moves_lanes_not_values(monkeypatch):
    """Pass 0 of a 64x32 render as Renderer traces it (bounce 0 listed):
    the 16-bounce wavefront compacted at (2, 4), at (3,) and not at all
    gives the same radiance and segments bit for bit."""
    scene, cam, bg = shirley.build(2.0, CPU)
    r = integrator.Renderer(scene, cam, bg, 64, 32, 1, B, CPU)
    state, off = r.initial_wavefront(0)
    out = {}
    for at in ((2, 4), (3,), ()):
        monkeypatch.setattr(integrator, "_default_compact_at",
                            lambda b, at=at: at)
        out[at] = integrator.trace_wavefront(
            r.sph_table, r.pack_table, state, off, r.sampler, B,
            r.background, origin_zero=True,
            block_lists0=(r.lists, r.counts))
    rad, segs = out[(2, 4)]
    assert int(segs) > 2 * 64 * 32
    for at in ((3,), ()):
        assert torch.equal(out[at][0], rad) and int(out[at][1]) == int(segs)
