"""The walk of csrc/intersect_clustered.cu, on the CPU: its tables
(sphere_kernel.cluster_walk: each cluster's real slots and grown bound;
cached_cluster_walk: built once per table),
its plain emulation (intersect_clustered_walk_plain: the block mask, the
warp skip over grown bounds, the real slots) against the plain version
intersect_clustered_plain, and each case that the kernel header's proofs
name: no pad is taken, no pair that the warp skip drops would be taken,
lanes outside the skip's proof enter every surviving cluster, the block
decision's rewritten last term and the pair test's early reject.

Tolerances: none. The kernel must equal intersect_clustered_plain bit for
bit (inv_a is NaN on NaN lanes in both, and compared as equal there), so
its emulation must too; the plain version itself is held to the JAX
package's intersect_clustered_pallas in tests/test_torch_clustered.py."""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import Renderer
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

CPU = torch.device("cpu")
BIG = sk.BIG
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def shirley_scene():
    scene, cam, bg = shirley.build(1.0, CPU)
    tables = sk.pack_spheres_clustered(scene.center, scene.radius,
                                       scene.valid)
    return scene, cam, bg, tables, sk.cluster_walk(tables)


@pytest.fixture(scope="module")
def scattered(shirley_scene):
    """(org, d, alive) of the rays entering bounce 1 of a 64x64 shirley
    pass (4 blocks): rays scattered off the spheres' surfaces, through the
    plain bounce."""
    scene, cam, bg, _, _ = shirley_scene
    r = Renderer(scene, cam, bg, 64, 64, 1, 8, CPU)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128)
    st, _ = fbk.fused_bounce_plain(
        r.sph_table, state, r.pack_table, off, r.sampler.limbs(2, 3), bg[1],
        rad, bg_mode=bg[0], origin_zero=True, block_lists=(r.lists, r.counts))
    return (st[0:3].reshape(3, -1).T.contiguous(),
            st[3:6].reshape(3, -1).T.contiguous(), st[9].reshape(-1) > 0)


def _rays(scene, cam, kind, n, seed):
    """(org, d, alive): camera rays from the origin, or rays leaving points
    near random spheres in random directions; 85% alive."""
    rng = np.random.default_rng(seed)
    if kind == "origin":
        cx, cy = (torch.from_numpy(rng.random(n).astype(np.float32))
                  for _ in range(2))
        d = cam.ray_dirs(cx, cy).numpy()
        org = np.zeros_like(d)
    else:
        c = scene.center.numpy().astype(np.float64)
        r = scene.radius.numpy().astype(np.float64)
        s = rng.choice(np.nonzero(scene.valid.numpy())[0], n)
        u = rng.standard_normal((n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        org = c[s] + u * (r[s] + rng.uniform(0.01, 2.0, n))[:, None]
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.random(n) < 0.85
    return (torch.from_numpy(org.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)), torch.from_numpy(alive))


def _equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _uncovered(org, d):
    """Copies of (org, d) with six kinds of lanes outside the warp skip's
    proof, every 97th lane from lane 5: a NaN direction, an infinite one, a
    zero one, |d| = 2, |d|^2 - 1 ~ 2^-13 (past DIR_TOL = 2^-17) and an
    origin at |o|^2 >= 2^100. Returns (org, d, the lanes)."""
    org, d = org.clone(), d.clone()
    lanes = torch.arange(5, org.shape[0], 97)
    d[lanes[0::6], 1] = float("nan")
    d[lanes[1::6], 0] = float("inf")
    d[lanes[2::6]] = 0.0
    d[lanes[3::6]] *= 2.0
    d[lanes[4::6]] *= 1.0 + 2.0 ** -14
    org[lanes[5::6], 0] = 2.0 ** 51
    return org, d, lanes


CASES = ["origin", "offset", "scattered", "dead", "shuffled", "uncovered"]


@pytest.mark.parametrize("case", CASES)
def test_walk_emulation_matches_plain(shirley_scene, scattered, case):
    """The emulated walk equals intersect_clustered_plain on every output
    and every lane, dead ones included: camera rays, offset rays, rays
    scattered off sphere surfaces, dead lanes with an all-dead block,
    scattered rays in shuffled lane order (each warp's lanes far apart, the
    skip's worst case), and lanes outside the skip's proof."""
    scene, cam, _, tables, walk = shirley_scene
    if case in ("origin", "offset"):
        org, d, alive = _rays(scene, cam, case, 4096, 7)
    elif case == "dead":
        org, d, alive = _rays(scene, cam, "offset", 4096, 8)
        alive[1024:2048] = False
    else:
        org, d, alive = scattered
        if case == "shuffled":
            perm = torch.from_numpy(np.random.default_rng(2).permutation(
                org.shape[0]))
            org, d, alive = org[perm], d[perm], alive[perm]
        elif case == "uncovered":
            org, d, lanes = _uncovered(org, d)
    want = sk.intersect_clustered_plain(tables, org, d, alive)
    at, idx, hit, inv_a, st = sk.intersect_clustered_walk_plain(
        tables, walk, org, d, alive)
    _equal((at, idx, hit, inv_a), want)
    assert 0.05 < float(hit[alive].float().mean()) < 1.0
    n_warps = org.shape[0] // sk.WARP
    warp_block = torch.arange(n_warps) // (sk.RAY_BLOCK // sk.WARP)
    surviving = st["surviving"][warp_block]
    assert bool((st["entered"] <= surviving).all())
    if case == "dead":  # no live lane: no cluster survives, all miss
        assert int(st["surviving"][1]) == 0
        assert not bool(hit[1024:2048].any())
        assert bool((idx[1024:2048] == tables[2][0]).all())
    if case in ("scattered", "shuffled"):
        # the skip drops surviving clusters for some warps, fewer when the
        # lanes are shuffled
        assert bool((st["entered"] < surviving).any())
        assert not bool(st["uncovered"].any())
    if case == "uncovered":
        assert bool(st["uncovered"][lanes].all())
        warps = torch.unique(lanes // sk.WARP)
        assert torch.equal(st["entered"][warps], surviving[warps])


def test_shuffled_lanes_enter_more_clusters(shirley_scene, scattered):
    """The warp skip pays for the union of its lanes: with the lanes of
    the scattered rays shuffled, a warp enters more clusters and tests more
    pairs than in the pass's own tile order."""
    _, _, _, tables, walk = shirley_scene
    org, d, alive = scattered
    perm = torch.from_numpy(np.random.default_rng(2).permutation(
        org.shape[0]))
    st = sk.intersect_clustered_walk_plain(tables, walk, org, d, alive)[4]
    sh = sk.intersect_clustered_walk_plain(tables, walk, org[perm], d[perm],
                                           alive[perm])[4]
    assert float(sh["entered"].float().mean()) > float(
        st["entered"].float().mean())
    assert float(sh["pairs"].float().mean()) > float(
        st["pairs"].float().mean())


def test_walk_tables_equal_a_numpy_recomputation(shirley_scene):
    """cluster_walk on shirley's 178 clusters: each cluster's count is the
    number of its slots up to its last non-pad word, and those are exactly
    the valid spheres (531); first is the counts' running sum; each bound
    is the box centre of the cluster's real spheres (float32) and RL = R +
    2^-7 (|C| + R) rounded up to float32, R the largest |c - C| + r; every
    real sphere lies inside its cluster's grown bound, with the radius the
    float A implies."""
    scene, _, _, tables, walk = shirley_scene
    sph = tables[0].numpy().astype(np.float64)
    k = tables[1].shape[1]
    runs, bounds = walk.runs.numpy(), walk.bounds.numpy()
    assert runs.shape == (k, 2) and bounds.shape == (k, 4)
    c = sph[:3].T
    with np.errstate(invalid="ignore"):
        r = np.sqrt(np.maximum(sph[3] + (c * c).sum(1), 0.0))
    pad = (sph[:3] == 0).all(axis=0) & (sph[3] == -BIG)
    first = 0
    for ci in range(k):
        slots = np.arange(ci * sk.CLUSTER, (ci + 1) * sk.CLUSTER)
        real = slots[~pad[slots]]
        count = real.max() - slots[0] + 1 if len(real) else 0
        assert tuple(runs[ci]) == (first, count)
        assert pad[slots[count:]].all()
        first += count
        s = slots[:count]
        cen = (0.5 * ((c[s] - r[s, None]).min(0) + (c[s] + r[s, None]).max(0))
               ).astype(np.float32).astype(np.float64)
        rad = (np.linalg.norm(c[s] - cen, axis=1) + r[s]).max()
        grown = rad + 2.0 ** -7 * (np.linalg.norm(cen) + rad)
        rl = np.float32(grown)
        if float(rl) < grown:
            rl = np.nextafter(rl, np.float32(np.inf))
        np.testing.assert_array_equal(bounds[ci], [*cen, max(rl, 2.0 ** -60)])
        assert ((np.linalg.norm(c[s] - bounds[ci, :3], axis=1) + r[s])
                <= bounds[ci, 3]).all()
    assert walk.n_real == first == int(scene.valid.sum()) == 531
    assert sorted(tables[2].numpy()[~pad]) == sorted(
        np.nonzero(scene.valid.numpy())[0])


def test_walk_tables_of_unbounded_and_empty_clusters(shirley_scene):
    """A cluster holding a sphere that is not finite, or that reaches past
    FAR = 2^50, gets RL = inf (every lane enters it); a cluster of pads
    only gets count 0; a pad word between real ones is walked (only the
    trailing pads are dropped)."""
    _, _, _, tables, _ = shirley_scene
    sph = tables[0].clone()
    sph[0, 1 * sk.CLUSTER] = float("nan")  # cluster 1: a NaN centre
    sph[1, 2 * sk.CLUSTER] = 2.0 ** 51  # cluster 2: a far centre
    sph[:, 3 * sk.CLUSTER:4 * sk.CLUSTER] = torch.tensor(
        [0.0, 0.0, 0.0, -BIG])[:, None]  # cluster 3: pads only
    n4 = int(sk.cluster_walk(tables).runs[4, 1])
    assert n4 >= 2
    sph[:, 4 * sk.CLUSTER] = torch.tensor([0.0, 0.0, 0.0, -BIG])  # a hole
    walk = sk.cluster_walk((sph, tables[1], tables[2]))
    assert float(walk.bounds[1, 3]) == float(walk.bounds[2, 3]) == np.inf
    assert int(walk.runs[3, 1]) == 0
    assert int(walk.runs[4, 1]) == n4


def test_cached_walk_is_built_once_per_table(shirley_scene):
    """cached_cluster_walk builds a table's walk at its first call and
    returns that one object at the next; a copy of the table gets a walk
    of its own, an in-place change of the table (here: cluster 0's
    trailing real sphere made a pad) builds it anew, and an inference
    tensor's walk is built at every call."""
    _, _, _, tables, walk = shirley_scene
    sph = tables[0].clone()
    own = (sph, tables[1], tables[2])
    first = sk.cached_cluster_walk(own)
    assert sk.cached_cluster_walk(own) is first
    for got, want in zip(first, walk):
        assert torch.equal(got, want) if torch.is_tensor(got) else got == want
    other = sk.cached_cluster_walk((sph.clone(), tables[1], tables[2]))
    assert other is not first
    n0 = int(first.runs[0, 1])
    sph[:, n0 - 1] = torch.tensor([0.0, 0.0, 0.0, -BIG])
    changed = sk.cached_cluster_walk(own)
    assert changed is not first
    assert int(changed.runs[0, 1]) < n0
    assert changed.n_real == first.n_real - 1
    assert sk.cached_cluster_walk(own) is changed
    with torch.inference_mode():  # no version counter: built every call
        inf = (tables[0].clone(), tables[1], tables[2])
        once = sk.cached_cluster_walk(inf)
        assert sk.cached_cluster_walk(inf) is not once
    assert torch.equal(once.runs, walk.runs)


def _pad_table():
    """Two clusters under a bounding sphere of r^2 = inf, which the block
    cull passes for every lane with a finite fb and a != 0: cluster 0 of 16
    pad words, cluster 1 one real sphere (|c| = 5, r = 1) and 15 pads.
    perm marks the pads -1."""
    sph = np.zeros((4, 2 * sk.CLUSTER), np.float32)
    sph[3] = -BIG
    sph[:, sk.CLUSTER] = [3.0, 4.0, 0.0, 1.0 - 25.0]
    clus = np.array([[0.0, 3.0], [0.0, 4.0], [0.0, 0.0], [np.inf, np.inf]],
                    np.float32)
    perm = np.full(2 * sk.CLUSTER, -1, np.int32)
    perm[sk.CLUSTER] = 7
    return tuple(torch.from_numpy(x) for x in (sph, clus, perm))


def _extreme_rays():
    """Rays that the pad proof names, 1,024 of them (one block): NaN and
    infinite components, |o|^2 near FLT_MAX and near BIG on both sides,
    zero, subnormal, tiny (a = 2^-126, 2^-128) and huge directions,
    directions along o (od^2 = |o|^2 |d|^2), non-unit d; and ordinary rays
    at the real sphere, so that it is hit too."""
    rows = []
    s = 2.0 ** 0.5
    for o_len in (0.0, 1.0, 1e18, 1.3e19, (BIG / 2) ** 0.5, (F32_MAX / 2)
                  ** 0.5, 1.7e19, (0.4e38 / 2) ** 0.5, 1e19):
        for d_len in (1.0, 0.0, 1e-40, 2.0 ** -63, 2.0 ** -64, 1e-19, 1e19,
                      2.0, 0.5, 3e-23):
            for o_dir, d_dir in (((1, 1, 0), (1, 1, 0)), ((1, 1, 0),
                                                           (-1, -1, 0)),
                                 ((1, 0, 0), (0, 1, 0)), ((0, 1, 1),
                                                          (1, 1, 1))):
                o = np.array(o_dir, np.float64)
                dd = np.array(d_dir, np.float64)
                rows.append((*(o / np.linalg.norm(o) * o_len),
                             *(dd / np.linalg.norm(dd) * d_len)))
    for bad in (float("nan"), float("inf"), -float("inf")):
        for j in range(6):
            row = [0.5, 0.5, 0.0, 0.0, 0.0, 1.0]
            row[j] = bad
            rows.append(tuple(row))
    rng = np.random.default_rng(3)
    while len(rows) < 1024:  # rays from near the origin at the real sphere
        o = rng.uniform(-1, 1, 3)
        dd = np.array([3.0, 4.0, 0.0]) + rng.uniform(-0.5, 0.5, 3) - o
        rows.append((*o, *(dd / np.linalg.norm(dd) * rng.choice([1, s]))))
    a = np.array(rows[:1024], np.float64).astype(np.float32)
    return torch.from_numpy(a[:, :3].copy()), torch.from_numpy(a[:, 3:].copy())


def test_no_pad_is_taken():
    """Proof 1 of the kernel header: on every extreme ray, with every lane
    alive and a cull that every lane with a finite fb passes, the plain
    version never takes a pad word (perm -1), whether its cluster has no
    real slot or one; so the kernel, which never tests pads, equals it.
    The real sphere is hit by the ordinary rays."""
    tables = _pad_table()
    org, d = _extreme_rays()
    alive = torch.ones(org.shape[0], dtype=torch.bool)
    at, idx, hit, inv_a = sk.intersect_clustered_plain(tables, org, d, alive)
    assert not bool((hit & (idx == -1)).any())
    assert bool((idx[hit] == 7).all()) and int(hit.sum()) > 500
    assert bool((at[~hit] == BIG).all())
    walk = sk.cluster_walk(tables)
    assert walk.runs.tolist() == [[0, 0], [0, 1]]
    _equal(sk.intersect_clustered_walk_plain(tables, walk, org, d,
                                             alive)[:4],
           (at, idx, hit, inv_a))


def _pair_cands(sph, org, d):
    """Each ray's candidate on each slot of sph, in the plain version's
    pair arithmetic: (rays, slots) f32, BIG where the pair is not
    taken."""
    cx, cy, cz, a_s = (sph[c][None, :] for c in range(4))
    o0, o1, o2 = (org[:, c, None] for c in range(3))
    d0, d1, d2 = (d[:, c, None] for c in range(3))
    od = o0 * d0 + o1 * d1 + o2 * d2
    oq = o0 * o0 + o1 * o1 + o2 * o2
    a = d0 * d0 + d1 * d1 + d2 * d2
    bp = cx * d0 + cy * d1 + cz * d2 - od
    g = a_s + 2.0 * (cx * o0 + cy * o1 + cz * o2) - oq
    disc = g + bp * bp * (1.0 / a)
    sq = torch.sqrt(a * disc)
    at = bp + torch.where((g >= 0.0) & (bp >= 0.0), sq, -sq)
    cand = torch.where((disc >= 0.0) & (at >= 0.0), at, BIG)
    return cand, bp, disc


def _grazing_rays(bounds, seed, n_per):
    """Rays whose lines pass each grown bound (C, RL) at a distance
    lim * (1 + s), lim = RL + 2^-7 |o| the lane's own limit, for s from
    -2^-6 to 2^-4, from origins 2 to 10^4 away, with |d|^2 within 0.99
    DIR_TOL of 1; and rays that start just past the bound, heading away
    (b near -lim)."""
    rng = np.random.default_rng(seed)
    rows = []
    for cen, rl in ((b[:3].astype(np.float64), float(b[3])) for b in bounds):
        for _ in range(n_per):
            e = rng.standard_normal(3)
            e /= np.linalg.norm(e)
            nrm = np.cross(e, rng.standard_normal(3))
            nrm /= np.linalg.norm(nrm)
            t = rng.choice([2.0, 30.0, 1e3, 1e4]) * (1 + rl)
            s = rng.choice([-2.0 ** -6, -2.0 ** -12, 0.0, 2.0 ** -12,
                            2.0 ** -9, 2.0 ** -6, 2.0 ** -4])
            o = cen - t * e
            lim = rl + 2.0 ** -7 * np.linalg.norm(o)
            o = o + nrm * lim * (1 + s)
            scale = 1.0 + rng.uniform(-0.99, 0.99) * 2.0 ** -18
            rows.append((*o, *(e * scale)))
            # just past the bound, heading away
            o2 = cen + e * (rl + 2.0 ** -7 * np.linalg.norm(cen) * 2
                            + abs(s) * rl)
            rows.append((*o2, *(e * scale)))
    a = np.array(rows, np.float64).astype(np.float32)
    pad = -len(a) % sk.RAY_BLOCK
    a = np.concatenate([a, np.tile(a[:1], (pad, 1))])
    return torch.from_numpy(a[:, :3].copy()), torch.from_numpy(a[:, 3:].copy())


def test_no_skipped_pair_is_taken(shirley_scene):
    """Proof 3 of the kernel header: for every lane and every cluster whose
    grown bound the lane's test rejects, no real sphere of the cluster
    gives a candidate in the float32 pair test; so no warp that the skip
    keeps out of a cluster (all of its lanes reject it) drops a pair that
    would be taken. On rays built to graze each of shirley's grown bounds
    at the lane's own limit, from near and far."""
    _, _, _, tables, walk = shirley_scene
    sph = tables[0]
    org, d = _grazing_rays(walk.bounds.numpy(), 5, 6)
    votes = sk.bound_votes(walk.bounds, (org[:, 0], org[:, 1], org[:, 2]),
                           (d[:, 0], d[:, 1], d[:, 2]), False)  # (N, K)
    count = walk.runs[:, 1].long()
    real = (torch.arange(sk.CLUSTER).repeat(len(count))
            < count.repeat_interleave(sk.CLUSTER))
    cand, _, _ = _pair_cands(sph[:, real], org, d)
    slot_cluster = torch.arange(sph.shape[1])[real] // sk.CLUSTER
    rejected = ~votes[:, slot_cluster]
    assert int(rejected.sum()) > 0.5 * rejected.numel()
    assert not bool((rejected & (cand < BIG)).any())
    # the rays that graze a bound from just outside it hit nothing under
    # it, and some rays hit a sphere of a cluster they graze
    assert bool(((cand < BIG) & ~rejected).any())
    warp_rejects = rejected.reshape(-1, sk.WARP, rejected.shape[1]).all(1)
    warp_takes = (cand < BIG).reshape(-1, sk.WARP, cand.shape[1]).any(1)
    assert not bool((warp_rejects & warp_takes).any())


# crafted (sphere [cx, cy, cz, A], origin, direction, taken)
CRAFTED = [
    # bp = -0.0 (0 * negative components) and disc = 0: taken at key 0
    ((0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (-0.6, -0.8, -0.0), True),
    # a tangent ray, disc exactly 0 (A = 16 - 25): key 3
    ((3.0, 4.0, 0.0, -9.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), True),
    # the origin inside (g >= 0), facing the far wall, |d| = 2: key 3
    ((0.0, 0.0, 0.0, 1.0), (0.5, 0.0, 0.0), (-2.0, 0.0, 0.0), True),
    # the origin inside, the centre behind (bp < 0): rejected
    ((0.0, 0.0, 0.0, 1.0), (0.5, 0.0, 0.0), (1.0, 0.0, 0.0), False),
    # a miss by a hair (disc < 0): rejected
    ((3.0, 4.0, 0.0, -9.000001), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), False),
    # a NaN direction, a NaN centre, a zero direction: rejected
    ((0.0, 0.0, 5.0, 1.0), (0.0, 0.0, 0.0), (0.0, float("nan"), 1.0), False),
    ((float("nan"), 0.0, 5.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), False),
    ((0.0, 0.0, 5.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), False),
    # a sphere behind the ray: rejected
    ((0.0, 0.0, -5.0, -24.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), False),
]


def test_early_reject_drops_no_candidate():
    """The pair test's early reject (skip the root when !(bp >= 0) or
    !(disc >= 0)) drops no pair with a candidate, on the crafted pairs
    (each taken or not as listed) and on 200,000 random ones."""
    rows = [(*s, *o, *d) for s, o, d, _ in CRAFTED]
    t = torch.tensor(rows, dtype=torch.float32)
    cand, bp, disc = _pair_cands(t[:, :4].T.contiguous(), t[:, 4:7],
                                 t[:, 7:10])
    cand, bp, disc = (torch.diagonal(x) for x in (cand, bp, disc))
    assert [bool(x) for x in cand < BIG] == [tk for *_, tk in CRAFTED]
    assert not bool(((~(bp >= 0) | ~(disc >= 0)) & (cand < BIG)).any())
    rng = np.random.default_rng(9)
    c = rng.uniform(-3, 3, (400, 3))
    r = rng.uniform(0.05, 2.0, 400)
    sph = torch.from_numpy(np.concatenate(
        [c.T, (r * r - (c * c).sum(1))[None]]).astype(np.float32))
    o = torch.from_numpy(rng.uniform(-4, 4, (500, 3)).astype(np.float32))
    d = torch.from_numpy((rng.standard_normal((500, 3))
                          * rng.choice([1.0, 0.5, 3.0], (500, 1)))
                         .astype(np.float32))
    cand, bp, disc = _pair_cands(sph, o, d)
    assert int((cand < BIG).sum()) > 1000
    assert not bool(((~(bp >= 0) | ~(disc >= 0)) & (cand < BIG)).any())


def test_predicate_rewrite():
    """Proof 2 of the kernel header: the block decision's last term
    fb >= -sqrt(x) equals (x >= 0) where fb >= 0, and is false where fb is
    NaN, in float32, on every pair of special values (signed zeros,
    subnormals, infinities, NaN, negatives)."""
    vals = [float("-inf"), -F32_MAX, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1e-38,
            1.0, 3e38, F32_MAX, float("inf"), float("nan")]
    fb = torch.tensor(vals, dtype=torch.float32)[:, None]
    x = torch.tensor(vals, dtype=torch.float32)[None, :]
    want = fb >= -torch.sqrt(x)
    rewritten = torch.where(fb >= 0.0, x >= 0.0, want)
    assert torch.equal(rewritten, want)
    assert not bool(want[torch.isnan(fb[:, 0])].any())
