"""Port parity: lane compaction of pathtracer_tpu_torch against the JAX
package, EXACT. A stable partition only moves bits, so the port's
compact_blocks (its plain version on the CPU), pack_rows and dest_map must
equal compact_blocks_ref, the Pallas kernel in interpret mode and the JAX
glue bit for bit, including the garbage dest entries of dead lanes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.ops.pallas import compact_kernel as jck
from pathtracer_tpu_torch.ops.cuda import compact_kernel as tck

LANES = 128


def _wavefront(rng, rows, alive):
    state = rng.standard_normal((10, rows, LANES)).astype(np.float32)
    state[9] = alive.reshape(rows, LANES).astype(np.float32)
    off = rng.integers(0, 2 ** 32, size=(rows, LANES), dtype=np.uint64)
    return state, off.astype(np.uint32)


def _port(state, off):
    return tck.compact_blocks(torch.from_numpy(state),
                              torch.from_numpy(off.view(np.int32)))


def _assert_same(got, want, what):
    st, off, k = got
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32),
                                  err_msg=f"state {what}")
    np.testing.assert_array_equal(off.numpy().view(np.uint32),
                                  np.asarray(want[1]), err_msg=f"off {what}")
    np.testing.assert_array_equal(k.numpy(), np.asarray(want[2]),
                                  err_msg=f"k {what}")


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.3, 0.7, 1.0])
def test_compact_matches_ref_and_kernel(frac):
    rng = np.random.default_rng(int(frac * 100))
    rows = 16
    state, off = _wavefront(rng, rows, rng.random(rows * LANES) < frac)
    got = _port(state, off)
    assert got[2].dtype == torch.int32
    js, jo = jnp.asarray(state), jnp.asarray(off)
    _assert_same(got, jck.compact_blocks_ref(js, jo), f"ref frac={frac}")
    _assert_same(got, jck.compact_blocks(js, jo, interpret=True),
                 f"pallas frac={frac}")


def test_compact_structured_masks():
    """Runs, alternating lanes, single lanes at the block edges."""
    n = 8 * LANES
    patterns = [np.arange(n) % 2 == 0, np.arange(n) % 2 == 1,
                np.arange(n) < 1, np.arange(n) >= n - 1,
                (np.arange(n) // 100) % 2 == 0, (np.arange(n) // 33) % 3 == 1]
    rng = np.random.default_rng(1)
    for i, pat in enumerate(patterns):
        state, off = _wavefront(rng, 8, pat)
        _assert_same(_port(state, off),
                     jck.compact_blocks_ref(jnp.asarray(state),
                                            jnp.asarray(off)), f"pattern {i}")


@pytest.mark.parametrize("frac", [0.05, 0.4, 0.9])
def test_pack_rows_and_dest_map_match_jax(frac):
    rng = np.random.default_rng(7)
    rows = 24
    alive = rng.random(rows * LANES) < frac
    alive[8 * LANES:16 * LANES] = False  # one fully dead block
    state, off = _wavefront(rng, rows, alive)
    st_c, off_c, k = _port(state, off)
    st_p, off_p, n_used = tck.pack_rows(st_c, off_c, k)
    js_c, jo_c, jk = jck.compact_blocks_ref(jnp.asarray(state),
                                            jnp.asarray(off))
    want = jck.pack_rows(js_c, jo_c, jk)
    np.testing.assert_array_equal(st_p.numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    np.testing.assert_array_equal(off_p.numpy().view(np.uint32),
                                  np.asarray(want[1]))
    assert int(n_used) == int(want[2])

    alive_pre = torch.from_numpy(state[9] > 0)
    dest = tck.dest_map(alive_pre, k)
    assert dest.dtype == torch.int32
    np.testing.assert_array_equal(
        dest.numpy(), np.asarray(jck.dest_map(jnp.asarray(state[9] > 0), jk)))
    # round trip: every live lane's payload sits at its dest
    live = alive_pre.reshape(-1)
    src = torch.from_numpy(state[0]).reshape(-1)
    packed = st_p[0].reshape(-1)
    assert torch.equal(packed[dest[live].long()], src[live])


def test_compact_refuses_other_devices():
    state = torch.zeros(10, 8, LANES, device="meta")
    off = torch.zeros(8, LANES, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tck.compact_blocks(state, off)
    assert tck.compact_blocks.launches == 0
