"""The sphere hierarchy of the full-variant bounce (sphere_kernel.
build_sphere_bvh), the plain emulation of the kernel's per-warp walk over
it (intersect_culled_plain: leaves in depth-first order, a 32-lane
any-lane vote, the (key, index) rule) and the pair test's early reject
(csrc/pt_bounce.cuh:nearest_sphere).

Tolerances: none. The walk must give intersect_regs' result bit for bit
on every live lane, since the kernels that run it must equal their plain
versions, which run intersect_regs; the early reject must drop no pair that
the pair test (_select) takes. intersect_regs itself is held to the JAX
package's in tests/test_torch_fused_bounce.py and
tests/test_torch_two_kernel.py."""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import Renderer
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

CPU = torch.device("cpu")
W, H = 64, 64


@pytest.fixture(scope="module")
def scene():
    return shirley.build(W / H, CPU)


@pytest.fixture(scope="module")
def bounces(scene):
    """The renderer and the state entering each bounce 0-7 of pass 0 of a
    64x64 shirley render (4 tiles), chained through the plain bounce."""
    sc, cam, bg = scene
    r = Renderer(sc, cam, bg, W, H, 1, 8, CPU)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128)
    states = []
    for b in range(8):
        states.append(state)
        state, rad = fbk.fused_bounce_plain(
            r.sph_table, state, r.pack_table, off,
            r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad,
            bg_mode=bg[0], origin_zero=b == 0,
            block_lists=(r.lists, r.counts) if b == 0 else None)
    return r, states


@pytest.fixture(scope="module")
def hier(bounces):
    """The hierarchy of the render's sphere table, as the kernels get it."""
    return sk.build_sphere_bvh(bounces[0].sph_table)


def _rays(state):
    comps = [state[c].reshape(-1) for c in range(6)]
    return comps, state[9].reshape(-1) > 0.0


def _walk_vs_brute(sph, hier, comps, alive):
    """The emulated walk and intersect_regs on the same rays: equal on
    every live lane. Returns the walk's stats."""
    at, idx, stats = sk.intersect_culled_plain(sph, hier, *comps, alive,
                                               origin_zero=False)
    want_at, want_idx = sk.intersect_regs(sph, *comps, origin_zero=False)
    assert torch.equal(at[alive], want_at[alive])
    assert torch.equal(idx[alive], want_idx[alive])
    return stats, want_idx


def test_hierarchy_holds_every_sphere_once(scene):
    """scenes/shirley_seed42.json: each of the 531 valid spheres sits in
    exactly one leaf or in the unconditional set (the ground alone), no
    pad is in a leaf, leaves hold at most SPHERE_LEAF spheres, and every
    node's bound, before and after its growth, holds the spheres under
    it."""
    sc, _, _ = scene
    sph = sk.pack_spheres(sc.center, sc.radius, sc.valid)
    hier = sk.build_sphere_bvh(sph)
    order = hier.order.numpy()
    valid = np.nonzero(sc.valid.numpy())[0]
    assert sorted(order.tolist()) == valid.tolist()
    ground = int(np.argmax(sc.radius.numpy() * sc.valid.numpy()))
    assert hier.n_uncond == 1 and order[0] == ground
    links = hier.links.numpy()
    nodes = hier.nodes.numpy().astype(np.float64)
    # the radius the pair test's float A implies (A = r^2 - |c|^2 rounds
    # away up to ~3e-4 of a small sphere's radius) against the scene's
    c, r, _ = sk._sphere_radii(sph)
    assert np.allclose(r[valid], sc.radius.numpy()[valid], rtol=1e-3)
    g_n = hier.n_groups
    runs = [(f, n) for f, n, _, _ in links[g_n:]]
    assert sum(n for _, n in runs) == len(order) - hier.n_uncond
    assert all(0 < n <= sk.SPHERE_LEAF for _, n in runs)
    covered = np.zeros(len(order), bool)
    for f, n in runs:
        assert not covered[f:f + n].any()
        covered[f:f + n] = True
    assert covered[hier.n_uncond:].all()
    # the groups hold the leaves in order, each leaf once
    assert [f for f, _, _, _ in links[:g_n]] == list(
        np.cumsum([0] + [n for _, n, _, _ in links[:g_n - 1]]) + g_n)
    assert sum(n for _, n, _, _ in links[:g_n]) == len(links) - g_n
    assert all(0 < n <= sk.GROUP_LEAVES for _, n, _, _ in links[:g_n])
    for k, (f, n, _, _) in enumerate(links):
        # the spheres under node k: its run, or its leaves' runs
        under = (order[f:f + n] if k >= g_n else np.concatenate(
            [order[lf:lf + ln] for lf, ln, _, _ in links[f:f + n]]))
        reach = (np.linalg.norm(c[under] - nodes[k, :3], axis=1)
                 + r[under]).max()  # the least R that holds them
        grown = reach + sk.CULL_SLOPE * (np.linalg.norm(nodes[k, :3])
                                         + reach)
        assert grown <= nodes[k, 3]
        assert nodes[k, 3] <= grown * 1.1  # and not much more


def test_renderer_keeps_a_given_hierarchy_and_builds_none_on_the_cpu(
        bounces):
    """The plain versions on the CPU do not read the hierarchy, so a CPU
    Renderer builds none and keeps none."""
    r, _ = bounces
    assert r.sphere_hierarchy() is None and r._sphere_bvh is None


@pytest.mark.parametrize("b", range(1, 8))
def test_walk_matches_brute_force_on_render_rays(bounces, hier, b):
    """The rays of bounce b of the render: the walk equals intersect_regs;
    at b = 1 some warp skips a leaf."""
    r, states = bounces
    comps, alive = _rays(states[b])
    assert int(alive.sum()) > 0
    stats, _ = _walk_vs_brute(r.sph_table, hier, comps, alive)
    n_leaves = hier.links.shape[0] - hier.n_groups
    live_warp = stats["live_lanes"] > 0
    if b == 1:
        assert bool((stats["leaves_entered"][live_warp] < n_leaves).any())
    tested = stats["spheres_tested"][live_warp]
    assert int(tested.min()) >= hier.n_uncond


def test_walk_ties_to_the_lowest_index(bounces):
    """A sphere copied into a pad slot (a higher index): the pair keys tie
    wherever either is hit, and the copy must never win."""
    r, states = bounces
    sph = r.sph_table.clone()
    comps, alive = _rays(states[1])
    _, idx = sk.intersect_regs(sph, *comps, origin_zero=False)
    hits = idx[alive]
    src = int(torch.mode(hits[hits != int(sk.build_sphere_bvh(sph).order[0])])
              .values)  # the most hit sphere that is not the ground
    dup = sph.shape[1] - 1
    sph[:, dup] = sph[:, src]
    hier = sk.build_sphere_bvh(sph)
    assert int((hier.order == dup).sum()) == 1
    _, want_idx = _walk_vs_brute(sph, hier, comps, alive)
    assert int((want_idx[alive] == src).sum()) > 0
    assert int((want_idx[alive] == dup).sum()) == 0


def test_walk_skips_leaves_of_a_narrow_beam(bounces, hier):
    """A beam of 2,048 rays from one point in a ~2-degree cone at the big
    sphere at (-4, 1, 0): every warp skips most leaves, and the result is
    still the brute force's."""
    r, _ = bounces
    rng = np.random.default_rng(3)
    n = 2048
    d = np.array([0.8, 0.0, -0.6]) + rng.normal(0, 0.02, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([-8.0, 1.0, 3.0], (n, 1))
    comps = [torch.from_numpy(x.astype(np.float32)) for x in (*o.T, *d.T)]
    alive = torch.ones(n, dtype=torch.bool)
    stats, idx = _walk_vs_brute(r.sph_table, hier, comps, alive)
    n_leaves = hier.links.shape[0] - hier.n_groups
    assert int(stats["leaves_entered"].max()) < n_leaves // 2
    assert int((idx != int(hier.order[0])).sum()) > 0  # hits off the ground


def test_lanes_the_bounds_do_not_cover_enter_every_node(bounces, hier):
    """Lanes with a direction far from unit length, a NaN or a far origin
    make their warp enter every node (every group and leaf visited); the
    results stay the brute force's."""
    r, states = bounces
    comps, alive = _rays(states[1])
    comps = [x.clone() for x in comps]
    n_nodes = hier.nodes.shape[0]
    live = torch.nonzero(alive)[:, 0]
    odd = live[::97][:4]
    for c in (3, 4, 5):  # |d| = 2
        comps[c][odd[0]] *= 2.0
    comps[4][odd[1]] = float("nan")
    comps[0][odd[2]] = 2.0 ** 51  # |o|^2 past ORG_Q_MAX
    for c in (3, 4, 5):  # |d|^2 - 1 ~ 2^-13, past DIR_TOL
        comps[c][odd[3]] *= 1.0 + 2.0 ** -14
    stats, _ = _walk_vs_brute(r.sph_table, hier, comps, alive)
    for lane in odd.tolist():
        assert int(stats["nodes_visited"][lane // sk.WARP]) == n_nodes


def _pair_terms(sph, o, d, origin_zero):
    """bp, g and disc of the pair test, in _select's arithmetic."""
    cx, cy, cz, a_s = (sph[c][None, :] for c in range(4))
    d0, d1, d2 = (x[:, None] for x in d)
    if origin_zero:
        bp = cx * d0 + cy * d1 + cz * d2
        g = a_s
    else:
        o0, o1, o2 = (x[:, None] for x in o)
        od = o0 * d0 + o1 * d1 + o2 * d2
        oq = o0 * o0 + o1 * o1 + o2 * o2
        bp = cx * d0 + cy * d1 + cz * d2 - od
        g = a_s + 2.0 * (cx * o0 + cy * o1 + cz * o2) - oq
    return bp, g, g + bp * bp


def _keys(sph, o, d, origin_zero):
    od, oq = sk._ray_terms([x[:, None] for x in o], [x[:, None] for x in d],
                           origin_zero)
    return sk._select(*(sph[c][None, :] for c in range(4)),
                      [x[:, None] for x in o], [x[:, None] for x in d], od,
                      oq, origin_zero)


def _f32(rows):
    return [torch.tensor(c, dtype=torch.float32) for c in zip(*rows)]


# crafted (sphere [cx, cy, cz, A], origin, direction, origin_zero, taken)
CRAFTED = [
    # bp = -0.0 (0 * negative components) and disc = 0: taken at key 0
    ((0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (-0.6, -0.8, -0.0), True, True),
    # a tangent ray from outside, disc exactly 0 (A = 16 - 25): key 3
    ((3.0, 4.0, 0.0, -9.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), True, True),
    # the origin inside (g >= 0), facing the far wall: key 1.5
    ((0.0, 0.0, 0.0, 1.0), (0.5, 0.0, 0.0), (-1.0, 0.0, 0.0), False, True),
    # the origin inside, the centre behind (bp < 0): rejected
    ((0.0, 0.0, 0.0, 1.0), (0.5, 0.0, 0.0), (1.0, 0.0, 0.0), False, False),
    # a miss by a hair (disc < 0): rejected
    ((3.0, 4.0, 0.0, -9.000001), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), True,
     False),
    # a NaN direction, a NaN centre: rejected
    ((0.0, 0.0, 5.0, 1.0), (0.0, 0.0, 0.0), (0.0, float("nan"), 1.0), False,
     False),
    ((float("nan"), 0.0, 5.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), False,
     False),
    # a sphere behind the ray: rejected
    ((0.0, 0.0, -5.0, -24.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), True,
     False),
]


@pytest.mark.parametrize("case", range(len(CRAFTED)))
def test_early_reject_drops_no_taken_pair_crafted(case):
    sph_r, o_r, d_r, origin_zero, taken = CRAFTED[case]
    sph = torch.tensor(sph_r, dtype=torch.float32)[:, None]
    o, d = _f32([o_r]), _f32([d_r])
    bp, _, disc = _pair_terms(sph, o, d, origin_zero)
    reject = bool((~(bp >= 0.0) | ~(disc >= 0.0))[0, 0])
    key = float(_keys(sph, o, d, origin_zero)[0, 0])
    assert (key < sk.BIG) == taken
    assert not (reject and taken)
    if case == 0:
        assert bool(torch.signbit(bp)[0, 0]) and not reject


def test_early_reject_drops_no_taken_pair_random(bounces):
    """The render's bounce-1 rays against every sphere of the scene, and
    random rays against random spheres: where the early reject holds, the
    pair test's key is BIG."""
    r, states = bounces
    comps, alive = _rays(states[1])
    cases = [(r.sph_table, comps[:3], comps[3:], False)]
    rng = np.random.default_rng(11)
    n, k = 4096, 64
    sph = rng.normal(0, 3, (4, k)).astype(np.float32)
    sph[3] = rng.uniform(0.01, 4, k) ** 2 - (sph[:3] ** 2).sum(0)
    d = rng.normal(0, 1, (3, n))
    d /= np.linalg.norm(d, axis=0)
    o = rng.normal(0, 3, (3, n))
    t = lambda x: [torch.from_numpy(c.astype(np.float32)) for c in x]
    cases += [(torch.from_numpy(sph), t(o), t(d), False),
              (torch.from_numpy(sph), t(o), t(d), True)]
    for sph_t, o_t, d_t, origin_zero in cases:
        bp, _, disc = _pair_terms(sph_t, o_t, d_t, origin_zero)
        reject = ~(bp >= 0.0) | ~(disc >= 0.0)
        key = _keys(sph_t, o_t, d_t, origin_zero)
        assert not bool((reject & (key < sk.BIG)).any())
        assert int((key < sk.BIG).sum()) > 0 and bool(reject.any())
