"""Host-side reimplementation of OCaml 5's `Random` (the LXM / L64X128 PRNG).

Copy of pathtracer_tpu/utils/ocaml_random.py (OCaml5Random, OCaml4Random,
_seed_state and its SEED_VARIANTs), verbatim apart from this paragraph:
pure Python integers and MD5, so models/shirley.generate_sphere_list draws
the same stream as the JAX package for every seed.

The reference's shirley-spheres scene is generated with `Random.init 42`
followed by `Random.float 1.0` draws (`shirley_spheres/bin/main.ml:56-101,251`).
Scene parity therefore requires bit-reproducing OCaml 5's PRNG stream.

The generator core is the L64X128 member of the LXM family (Steele & Vigna,
OOPSLA 2021) exactly as implemented by the OCaml 5 runtime:

    state: 4 x uint64 [s, a, x0, x1]; a odd; (x0,x1) != 0
    next():
      z  = (s + x0) mixed with lea64: twice (z ^= z>>32; z *= 0xdaba0b6eb09322e3),
           then z ^= z>>32
      s  = s * 0xd1342543de82ef95 + a                 (LCG update)
      (x0, x1) = xoroshiro128 v1.0 step, constants (24, 16, 37)
    float bound = ((next() >> 11) as float) * 2^-53 * bound

Seeding (`Random.init n` == reinit with seed array [|n|]) hashes the
little-endian int64 encoding of the seed array with MD5 to fill the 128+128
bit state. The exact domain-separation byte used by the OCaml stdlib for the
second digest could not be verified in this environment (no OCaml toolchain;
zero egress) — SEED_VARIANT selects among the plausible constructions and
`tools/dump_rng_candidates.py` prints the first draws under each variant so a
human with an OCaml toolchain can confirm in seconds. The scene built from
this stream is additionally frozen to `scenes/shirley_seed42.json` so the
render pipeline is insulated from any later seeding fix.
"""

from __future__ import annotations

import hashlib
import struct

MASK64 = (1 << 64) - 1
_M = 0xD1342543DE82EF95  # LCG multiplier
_MIX = 0xDABA0B6EB09322E3  # lea64 mixing multiplier

# How the second MD5 digest is derived during seeding; see module docstring.
SEED_VARIANT = "digest_chain"  # d2 = md5(d1)
_SEED_VARIANTS = ("digest_chain", "append_one", "digest_plus_one")


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & MASK64


def _seed_state(seed_ints, variant: str = None):
    """Map a seed int array to the 4-word LXM state via MD5 mixing."""
    variant = variant or SEED_VARIANT
    b = b"".join(struct.pack("<q", ((s + (1 << 63)) % (1 << 64)) - (1 << 63)) for s in seed_ints)
    d1 = hashlib.md5(b).digest()
    if variant == "digest_chain":
        d2 = hashlib.md5(d1).digest()
    elif variant == "append_one":
        d2 = hashlib.md5(b + b"\x01").digest()
    elif variant == "digest_plus_one":
        d2 = hashlib.md5(d1 + b"\x01").digest()
    else:
        raise ValueError(variant)
    i1, i2 = struct.unpack_from("<QQ", d1)
    i3, i4 = struct.unpack_from("<QQ", d2)
    s = i1
    a = i2 | 1  # must be odd
    x0 = i3 if i3 != 0 else 1
    x1 = i4 if i4 != 0 else 2
    return [s, a, x0, x1]


class OCaml4Random:
    """OCaml 4's `Random`: 55-element lagged-Fibonacci (lags 55/24) over 30-bit
    ints with an xor tweak, seeded by chained MD5 digests. The reference repo
    predates a fixed OCaml version, so this generator is a candidate for the
    stream behind the committed sample render.
    """

    def __init__(self, seed: int):
        self.st = [0] * 55
        self.idx = 0
        self._full_init([seed])

    def _full_init(self, seed_ints):
        seed = seed_ints if seed_ints else [0]
        l = len(seed)
        for i in range(55):
            self.st[i] = i
        accu = b"x"
        for i in range(55 + max(55, l)):
            j = i % 55
            k = i % l
            accu = hashlib.md5(accu + str(seed[k]).encode()).digest()
            extract = accu[0] | (accu[1] << 8) | (accu[2] << 16) | (accu[3] << 24)
            self.st[j] = (self.st[j] ^ extract) & 0x3FFFFFFF
        self.idx = 0

    def bits(self) -> int:
        self.idx = (self.idx + 1) % 55
        curval = self.st[self.idx]
        newval = self.st[(self.idx + 24) % 55] + (curval ^ ((curval >> 25) & 0x1F))
        newval30 = newval & 0x3FFFFFFF
        self.st[self.idx] = newval30
        return newval30

    def rawfloat(self) -> float:
        scale = 1073741824.0  # 2^30
        r1 = float(self.bits())
        r2 = float(self.bits())
        return (r1 / scale + r2) / scale

    def float(self, bound: float) -> float:
        return self.rawfloat() * bound


class OCaml5Random:
    """Bit-level reimplementation of OCaml 5's Random (LXM L64X128)."""

    def __init__(self, seed: int, variant: str = None):
        self.st = _seed_state([seed], variant)

    def next_bits64(self) -> int:
        st = self.st
        z = (st[0] + st[2]) & MASK64
        z = ((z ^ (z >> 32)) * _MIX) & MASK64
        z = ((z ^ (z >> 32)) * _MIX) & MASK64
        z = z ^ (z >> 32)
        st[0] = (st[0] * _M + st[1]) & MASK64
        q0, q1 = st[2], st[3]
        q1 ^= q0
        q0 = _rotl(q0, 24)
        q0 = (q0 ^ q1 ^ ((q1 << 16) & MASK64)) & MASK64
        q1 = _rotl(q1, 37)
        st[2], st[3] = q0, q1
        return z

    def rawfloat(self) -> float:
        """Uniform in [0,1) with 53 bits, as OCaml 5's Random.float builds it."""
        return (self.next_bits64() >> 11) * (2.0 ** -53)

    def float(self, bound: float) -> float:
        return self.rawfloat() * bound
