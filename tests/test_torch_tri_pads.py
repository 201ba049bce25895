"""The triangle-pool kernel's two skips (csrc/intersect_tris.cu), on the
CPU: it walks only the columns with a nonzero edge component, and it runs a
division-free pre-reject before each pair's full test. Its header proves
that neither drops a pair that the full test accepts; these tests check
that argument with the plain versions of ops/cuda/tri_kernel.py:

- pads never win: on a table whose real columns are scattered among pads
  (T = 45, not a multiple of 32; pads with +0.0 and -0.0 edges), with rays
  of inf and NaN components, origins on a triangle's plane, rays parallel
  to it and a duplicated triangle (ties), intersect_tris_plain over the
  whole table equals the plain walk over the real columns alone, exactly;
- the pre-reject is conservative: tri_pair_tests, the plain emulation of
  both skips, marks no pair both skipped and accepted, on random pairs of
  many scales, on rays aimed within a few ulps of the triangles' edges and
  on each case the header names.

No tolerance: both sides run the same float32 operations. This file
imports no JAX; tests/test_torch_cuda.py holds the kernel to its plain
version on the same cases on the card, and tests/test_torch_intersect.py
holds them to the JAX kernel."""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
from pathtracer_tpu_torch.ops.cuda.sphere_kernel import BIG

N_COLS = 45
REAL = [2, 5, 6, 11, 17, 23, 24, 30, 33, 38, 40, 44]
TIE = (REAL[3], REAL[9])  # the second column is a copy of the first
PLANE_Z = 0.5  # REAL[0] lies in this plane, as two triangles of a quad


def scattered_case(seed, n=2048):
    """A (9, 45) f32 table with the real columns REAL among pads, and n
    rays (org, d (n, 3) f32, alive (n,) bool; numpy): block 0 all alive,
    the last block with one live lane. Rays: aimed at the real triangles
    from around them (|d| from 1/4 to 2 of the distance); from points of
    the z = 0.5 plane of REAL[0] and REAL[1] (t = +-0 there); parallel to
    that plane; with an inf or NaN direction component; from an inf or NaN
    origin. Every finite coordinate is a multiple of 2^-3 (the table) or
    2^-6 (the rays) of a few bits, so that every product and dot product
    of the test is exact in float32, and XLA's FMA contraction in the JAX
    kernel changes no bit of u, v or t."""
    rng = np.random.default_rng(seed)
    grid = lambda lo, hi, step, shape: rng.integers(
        round(lo / step), round(hi / step) + 1, shape) * step
    a = grid(-1.0, 1.0, 0.125, (N_COLS, 3))
    e1 = np.zeros((N_COLS, 3))
    e2 = np.zeros((N_COLS, 3))
    real = np.array(REAL)
    e1[real] = grid(-1.0, 1.0, 0.125, (len(REAL), 3))
    e2[real] = grid(-1.0, 1.0, 0.125, (len(REAL), 3))
    # REAL[0], REAL[1]: the quad [-1, 1]^2 at z = 0.5, split on a diagonal
    a[REAL[0]], e1[REAL[0]], e2[REAL[0]] = ([-1, -1, PLANE_Z], [2, 0, 0],
                                            [0, 2, 0])
    a[REAL[1]], e1[REAL[1]], e2[REAL[1]] = ([1, 1, PLANE_Z], [-2, 0, 0],
                                            [0, -2, 0])
    a[TIE[1]], e1[TIE[1]], e2[TIE[1]] = a[TIE[0]], e1[TIE[0]], e2[TIE[0]]
    table = np.ascontiguousarray(np.concatenate([a.T, e1.T, e2.T]),
                                 np.float32)
    pads = [c for c in range(N_COLS) if c not in REAL]
    table[3:, pads[::2]] = -0.0  # pads with negative-zero edges
    tri = table.astype(np.float64)

    k = rng.integers(0, len(REAL), n)
    bu = rng.integers(1, 7, n)
    bv = rng.integers(1, 8 - bu)
    tc = tri[:, real[k]]
    target = (tc[0:3].T + bu[:, None] / 8 * tc[3:6].T
              + bv[:, None] / 8 * tc[6:9].T)
    off = grid(-2.0, 2.0, 0.125, (n, 3))
    org = target + off
    d = -off * 2.0 ** rng.integers(-2, 1, (n, 1))
    q = np.arange(n)
    on = (q % 1024 >= 600) & (q % 1024 < 800)  # from the z = 0.5 plane
    org[on, 0:2] = grid(-1.0, 1.0, 2.0 ** -6, (int(on.sum()), 2))
    org[on, 2] = PLANE_Z
    par = (q % 1024 >= 800) & (q % 1024 < 900)  # parallel to it
    d[par, 2] = 0.0
    bad = q % 1024 >= 900
    d[bad & (q % 5 == 0), q[bad & (q % 5 == 0)] % 3] = np.inf
    d[bad & (q % 5 == 1), 1] = -np.inf
    d[bad & (q % 5 == 2), 2] = np.nan
    org[bad & (q % 5 == 3), 0] = np.inf
    org[bad & (q % 5 == 4), 1] = np.nan
    alive = np.ones(n, bool)
    alive[n - 1024:] = False
    alive[n - 1024 + 476] = True
    return (table, org.astype(np.float32), d.astype(np.float32), alive)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def real_only(table, org, d, alive):
    """intersect_tris_plain over the real columns alone, its indices mapped
    back to the full table's columns (a miss keeps (BIG, 0))."""
    t, idx, hit = tk.intersect_tris_plain(table[:, REAL].contiguous(), org, d,
                                          alive)
    cols = torch.tensor(REAL, dtype=torch.int32)
    return t, torch.where(hit, cols[idx.long()], 0).to(torch.int32), hit


@pytest.mark.parametrize("seed", [0, 1])
def test_pads_never_win(seed):
    table, org, d, alive = _t(*scattered_case(seed))
    got = tk.intersect_tris_plain(table, org, d, alive)
    want = real_only(table, org, d, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    t, idx, hit = got
    assert bool(hit[:1024].any()) and hit[:1024].float().mean() > 0.4
    assert not bool(hit[900:1024].any())  # inf and NaN rays miss
    assert bool((t[600:800] == 0.0).any())  # hits at t = +-0
    assert bool((idx == TIE[0]).any()) and not bool((idx == TIE[1]).any())
    # a block with one live lane is walked for all its lanes
    assert bool(hit[1024:].any()) and bool((t[1024:] == BIG).any())


def _random_pairs(seed, n=4096):
    """Rays against random triangles of scales 2^-8 to 2^24, aimed at
    barycentrics within a few float32 ulps of each edge and vertex, or
    anywhere; returns (table (9, 32), org, d) tensors."""
    rng = np.random.default_rng(seed)
    cols = 32
    scale = 2.0 ** rng.integers(-8, 25, cols)
    a = rng.uniform(-1.0, 1.0, (cols, 3)) * scale[:, None]
    e1 = rng.uniform(-1.0, 1.0, (cols, 3)) * scale[:, None]
    e2 = rng.uniform(-1.0, 1.0, (cols, 3)) * scale[:, None]
    table = np.concatenate([a.T, e1.T, e2.T]).astype(np.float32)
    tri = table.astype(np.float64)
    k = rng.integers(0, cols, n)
    ulps = rng.integers(-4, 5, (n, 2)) * 2.0 ** -24
    kind = rng.integers(0, 4, n)
    bu = np.where(kind == 0, ulps[:, 0], rng.random(n))
    bv = np.where(kind == 1, ulps[:, 1],
                  np.where(kind == 2, 1.0 - bu + ulps[:, 1], rng.random(n)))
    bu = np.where(kind == 3, np.where(rng.random(n) < 0.5, 0.0, 1.0)
                  + ulps[:, 0], bu)
    tc = tri[:, k]
    target = tc[0:3].T + bu[:, None] * tc[3:6].T + bv[:, None] * tc[6:9].T
    org = target + rng.standard_normal((n, 3)) * scale[k, None]
    d = (target - org) * 2.0 ** rng.integers(-10, 11, (n, 1))
    return _t(table, org.astype(np.float32), d.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_reject_is_conservative_on_random_pairs(seed):
    table, org, d = _random_pairs(seed)
    skipped, accepted = tk.tri_pair_tests(table, org, d)
    assert not bool((skipped & accepted).any())
    # the test has teeth: pairs accepted, and most others skipped unread
    assert int(accepted.sum()) > 500
    assert float(skipped.float().mean()) > 0.6


def test_pre_reject_is_conservative_on_the_scattered_table():
    table, org, d, _ = _t(*scattered_case(0))
    skipped, accepted = tk.tri_pair_tests(table, org, d)
    assert not bool((skipped & accepted).any())
    pads = [c for c in range(N_COLS) if c not in REAL]
    assert bool(skipped[:, pads].all())
    assert int(accepted.sum()) > 500


def _one(a, e1, e2, o, d):
    f = lambda x: torch.tensor([x], dtype=torch.float32)
    return torch.cat([f(a).T, f(e1).T, f(e2).T]), f(o), f(d)


EPS = float(np.float32(1e-6))
BELOW_EPS = float(np.nextafter(np.float32(1e-6), np.float32(0)))
X, Y, DOWN = [1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]
ROUNDS_D = float.fromhex("0x1.d38948p+9")
ROUNDS_U = float(np.nextafter(np.float32(ROUNDS_D), np.float32(np.inf)))
# the unit right triangle at z = 0 (det = 1, u = o.x, v = o.y, t = o.z),
# and with its edges swapped (det = -1)
NAMED = {
    # name: (a, e1, e2, origin, direction, accepted)
    "det_at_eps": ([0, 0, 0], [0, -EPS, 0], [0, 0, 1.0], [-1.0, -0.25e-6,
                   0.5], X, True),
    "det_below_eps": ([0, 0, 0], [0, -BELOW_EPS, 0], [0, 0, 1.0],
                      [-1.0, -0.25e-6, 0.5], X, False),
    "u_exactly_0": ([0, 0, 0], X, Y, [0.0, 0.5, 1.0], DOWN, True),
    "u_exactly_1": ([0, 0, 0], X, Y, [1.0, 0.0, 1.0], DOWN, True),
    "u_plus_v_exactly_1": ([0, 0, 0], X, Y, [0.25, 0.75, 1.0], DOWN, True),
    "u_just_over_1": ([0, 0, 0], X, Y, [float(np.nextafter(np.float32(1),
                                                           np.float32(2))),
                                        0.0, 1.0], DOWN, False),
    # uu = -2^-149: not pre-rejected (|su| < TINY), rejected by `uu >= 0`
    "u_tiny_negative": ([0, 0, 0], X, Y, [-2.0 ** -149, 0.5, 1.0], DOWN,
                        False),
    "u_negative": ([0, 0, 0], X, Y, [-2.0 ** -60, 0.5, 1.0], DOWN, False),
    # det = D, U = the next float above D: uu = fl(fl(1/D) * U) is exactly 1
    "u_over_1_rounds_to_1": ([0, 0, 0], [ROUNDS_D, 0, 0], Y,
                             [ROUNDS_U, 0.0, 1.0], DOWN, True),
    # det = 2^60, U = -2^-100: uu = -2^-160 underflows to -0.0
    "u_underflows_to_minus_0": ([0, 0, 0], [2.0 ** 60, 0, 0], Y,
                                [-2.0 ** -100, 0.25, 1.0], DOWN, True),
    # det = 2^90 > 2^64, U = -2^-62 < -TINY: uu = -2^-152 underflows too
    "u_underflows_above_regular": ([0, 0, 0], [2.0 ** 90, 0, 0], Y,
                                   [-2.0 ** -62, 0.25, 1.0], DOWN, True),
    "t_exactly_0": ([0, 0, 0], X, Y, [0.25, 0.25, 0.0], DOWN, True),
    "t_minus_0": ([0, 0, 0], Y, X, [0.25, 0.25, -0.0], DOWN, True),
    "t_negative": ([0, 0, 0], X, Y, [0.25, 0.25, -2.0 ** -60], DOWN, False),
    # det = 2^200 overflows: det_inv = 0 and u = v = t = 0 are accepted
    "det_inf": ([0, 0, 0], [2.0 ** 100, 0, 0], [0, 2.0 ** 100, 0],
                [0.25, 0.25, 2.0 ** -100], DOWN, True),
    "det_above_regular": ([0, 0, 0], [2.0 ** 40, 0, 0], [0, 2.0 ** 40, 0],
                          [0.25 * 2 ** 40, 0.25 * 2 ** 40, 1.0], DOWN, True),
    "nan_direction": ([0, 0, 0], X, Y, [0.25, 0.25, 1.0], [0, float("nan"),
                      -1.0], False),
    "inf_direction": ([0, 0, 0], X, Y, [0.25, 0.25, 1.0],
                      [0, 0, float("-inf")], False),
    "nan_origin": ([0, 0, 0], X, Y, [float("nan"), 0.25, 1.0], DOWN, False),
    "inf_origin": ([0, 0, 0], X, Y, [0.25, 0.25, float("inf")], DOWN,
                   False),
    "pad_plus_0": ([0.3, 0.2, 0.1], [0, 0, 0], [0, 0, 0], [0.25, 0.25, 1.0],
                   DOWN, False),
    "pad_minus_0": ([0.3, 0.2, 0.1], [-0.0, 0, -0.0], [0, -0.0, 0],
                    [0.25, 0.25, 1.0], DOWN, False),
    "pad_inf_direction": ([0, 0, 0], [0, 0, 0], [0, 0, 0], [0.25, 0.25, 1.0],
                          [float("inf"), 0, -1.0], False),
}


def named_case(name):
    """(table (9, 1), org (1, 3), d (1, 3)) of NAMED[name]."""
    return _one(*NAMED[name][:5])


@pytest.mark.parametrize("name", list(NAMED))
def test_pre_reject_named_case(name):
    table, org, d = named_case(name)
    skipped, accepted = tk.tri_pair_tests(table, org, d)
    assert bool(accepted[0, 0]) == NAMED[name][5]
    assert not bool(skipped[0, 0] & accepted[0, 0])
    if name.startswith("pad"):
        assert bool(skipped[0, 0])
    # and the plain walk agrees with the full test
    t, _, hit = tk.intersect_tris_plain(
        table, org.expand(1024, 3).contiguous(), d.expand(1024, 3)
        .contiguous(), torch.ones(1024, dtype=torch.bool))
    assert bool(hit[0]) == NAMED[name][5]
    if name == "u_underflows_to_minus_0":
        e1, pv = table[3:6, 0], torch.tensor([1.0, 0.0, 0.0])
        uu = (1.0 / (e1 * pv).sum()) * (org[0] * pv).sum()
        assert float(uu) == 0.0 and bool(torch.signbit(uu))
    if name in ("t_minus_0", "det_inf"):
        assert float(t[0]) == 0.0


@pytest.mark.parametrize("name, stage", [
    ("pad_minus_0", tk.PAD), ("det_below_eps", tk.AT_DET),
    ("nan_direction", tk.AT_DET), ("u_negative", tk.AT_U),
    ("t_negative", tk.AT_VT), ("u_exactly_1", tk.FULL),
    ("det_above_regular", tk.FULL)])
def test_pair_stage_of_named_case(name, stage):
    """tri_pair_stages puts each pair where the kernel leaves it: a pad
    column, the |det| test, the u tests, the v / t / u + v tests, or the
    full test (a det past 2^64 skips the pre-reject)."""
    stage_got, accepted = tk.tri_pair_stages(*named_case(name))
    assert int(stage_got[0, 0]) == stage
    assert bool(accepted[0, 0]) == NAMED[name][5]


def test_pair_stages_on_random_pairs():
    """Every stage but PAD occurs on random pairs, only FULL pairs are
    accepted, and tri_pair_tests is tri_pair_stages below FULL."""
    table, org, d = _random_pairs(0)
    stage, accepted = tk.tri_pair_stages(table, org, d)
    assert stage.dtype == torch.int8 and stage.shape == accepted.shape
    counts = torch.bincount(stage.flatten().long(), minlength=5)
    assert int(counts[tk.PAD]) == 0
    assert all(int(counts[k]) > 0
               for k in (tk.AT_DET, tk.AT_U, tk.AT_VT, tk.FULL))
    assert not bool((accepted & (stage != tk.FULL)).any())
    skipped, _ = tk.tri_pair_tests(table, org, d)
    assert torch.equal(skipped, stage != tk.FULL)
