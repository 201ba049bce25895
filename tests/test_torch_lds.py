"""Port parity: the Roberts sampler of pathtracer_tpu_torch against the JAX
package's, BIT-EXACT. Both sides run the same 64-bit fixed-point limb
arithmetic (the port in int64 masked to 32 bits, since torch on the CPU has
no uint32 add or shift), so any differing bit is a port fault.

Offsets come from numpy with a fixed seed and include the edges 0,
2^31 - 1, 2^31 and 2^32 - 1 (where offset + 1 wraps to 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.ops import lds as jlds
from pathtracer_tpu.ops.pallas import shade_kernel as jshk
from pathtracer_tpu_torch.ops import lds as tlds
from pathtracer_tpu_torch.ops.cuda import shade_kernel as tshk

EDGES = np.array([0, 1, 2, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                 np.uint32)


def _offsets(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    return np.concatenate([EDGES, rand.astype(np.uint32)])


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("dimension", [2, 6, 18])
def test_sampler_tables_equal(dimension):
    assert tlds.phi(dimension) == jlds.phi(dimension)
    np.testing.assert_array_equal(tlds.alphas_fixed64(dimension),
                                  jlds.alphas_fixed64(dimension))
    ts, js = tlds.Sampler(dimension), jlds.Sampler(dimension)
    np.testing.assert_array_equal(ts.hi, js.hi)
    np.testing.assert_array_equal(ts.lo, js.lo)
    lim = ts.limbs(0, dimension - 1)
    assert lim.dtype == np.uint32
    np.testing.assert_array_equal(
        lim, [[js.hi[0], js.lo[0]], [js.hi[-1], js.lo[-1]]])


@pytest.mark.parametrize("dimension", [2, 6, 18])
def test_sample_fixed_bit_exact(dimension):
    off = _offsets(dimension)
    js, ts = jlds.Sampler(dimension), tlds.Sampler(dimension)
    off_t = torch.from_numpy(off.view(np.int32))
    for d in range(dimension):
        want = js.get(jnp.asarray(off), d)
        got = ts.get(off_t, d)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"dim {d}")


@pytest.mark.parametrize("dimension", [4, 18])
def test_in_kernel_lds_bit_exact(dimension):
    """The shading kernel's own draw (f32(int32(v >> 1)) * 2^-31), which
    differs from sample_fixed's f32(v) * 2^-32 in the last bit."""
    off = _offsets(100 + dimension)
    fixed = tlds.alphas_fixed64(dimension)
    off_t = torch.from_numpy(off.view(np.int32))
    for d in range(dimension):
        hi, lo = fixed[d]
        want = jshk._lds(jnp.asarray(off), jnp.uint32(hi), jnp.uint32(lo))
        got = tshk._lds(off_t, int(hi), int(lo))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"dim {d}")


def test_offsets_of_any_integer_dtype_agree():
    """int64 offsets (the renderer's) and int32 bit patterns (the kernel
    layout's) name the same uint32 offsets."""
    off = _offsets(7)
    s = tlds.Sampler(4)
    a = s.get(torch.from_numpy(off.astype(np.int64)), 3)
    b = s.get(torch.from_numpy(off.view(np.int32)), 3)
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
