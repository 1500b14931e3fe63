"""The port's replay of ``jax.random`` (``repro_torch.core.prng``) against
JAX itself, on the CPU, on the same raw uint32 keys.

``fold_in``, ``split``, the uint64 and uint32 ``bits`` and the float64
``uniform`` (on [0, 1) and on the normal's [nextafter(-1, 0), 1)) are held
equal, bit for bit; ``normal`` within rel 1e-12, since torch's ``erfinv``
on the CPU rounds otherwise than XLA's ``erf_inv`` in the last bits.  The
shapes are the fleet scan's: the kernel noise (N, G, Kc), the comm noise
(N, Km) and the TP jitter (N, K), at the test fleets' and at the
population's 256 nodes; counters of 2^32 and more, which no array here can
reach, are held through JAX's threefry2x32 primitive on explicit (hi, lo)
pairs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend.random import threefry2x32_p

from repro_torch.core import prng

NORMAL_RTOL = 1e-12
SHAPES = [(4, 8, 37), (4, 11), (4, 16), (256, 8, 129)]


def _keys(seed, n=3):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(n, 2)).astype(np.uint32)


def _torch_keys(keys):
    return torch.as_tensor(keys.view(np.int32))        # as the kernel takes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_and_split_equal_jax(seed):
    keys = _keys(seed)
    tk = _torch_keys(keys)
    for data in (0, 29, 31, 2 ** 20 + 7, 2 ** 32 - 1):
        got = prng.fold_in(tk, data).numpy()
        for k in range(len(keys)):
            want = np.asarray(jax.random.fold_in(jnp.asarray(keys[k]), data))
            np.testing.assert_array_equal(got[k], want, err_msg=f"{data}")
    for n in (2, 3, 5):
        got = prng.split(tk, n).numpy()
        for k in range(len(keys)):
            want = np.asarray(jax.random.split(jnp.asarray(keys[k]), n))
            np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_equal_jax(shape):
    keys = _keys(len(shape))
    tk = _torch_keys(keys)
    b64 = prng.bits64(tk, shape).numpy().view(np.uint64)
    x0, x1 = prng.words(tk, torch.arange(int(np.prod(shape))).view(shape))
    b32 = (x0 ^ x1).numpy().astype(np.uint32)    # JAX's 32-bit draw
    with jax.enable_x64():
        for k in range(len(keys)):
            key = jnp.asarray(keys[k])
            np.testing.assert_array_equal(
                b64[k], np.asarray(jax.random.bits(key, shape, jnp.uint64)))
            np.testing.assert_array_equal(
                b32[k], np.asarray(jax.random.bits(key, shape, jnp.uint32)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_equals_jax_on_both_ranges(shape):
    keys = _keys(10 + len(shape))
    tk = _torch_keys(keys)
    for lo, hi in ((0.0, 1.0), (prng.NORMAL_LO, 1.0)):
        got = prng.uniform(tk, shape, lo, hi).numpy()
        with jax.enable_x64():
            for k in range(len(keys)):
                want = np.asarray(jax.random.uniform(
                    jnp.asarray(keys[k]), shape, jnp.float64, lo, hi))
                np.testing.assert_array_equal(got[k], want, err_msg=f"{lo}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(shape):
    """The fleet scan's draws: normals of keys folded and split as
    ``_fleet_scan_core`` folds and splits them."""
    keys = _keys(20 + len(shape))
    k1 = prng.split(prng.fold_in(_torch_keys(keys), 31), 3)[:, 0]
    got = prng.normal(k1, shape).numpy()
    with jax.enable_x64():
        for k in range(len(keys)):
            jk = jax.random.split(jax.random.fold_in(jnp.asarray(keys[k]), 31),
                                  3)[0]
            want = np.asarray(jax.random.normal(jk, shape, jnp.float64))
            np.testing.assert_allclose(got[k], want, rtol=NORMAL_RTOL,
                                       atol=0.0)
            assert np.array_equal(np.signbit(got[k]), np.signbit(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_counters_past_two_to_the_32_equal_jax(seed):
    """Counter c is the pair (c >> 32, c & 0xffffffff): held past 2^32
    through JAX's threefry2x32 primitive."""
    keys = _keys(30 + seed)
    c = np.array([0, 7, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 32 + 7,
                  2 ** 40 + 1, 2 ** 62 + 3], np.int64)
    x0, x1 = prng.words(_torch_keys(keys), torch.as_tensor(c))
    hi = jnp.asarray((c >> 32).astype(np.uint32))
    lo = jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32))
    for k in range(len(keys)):
        y0, y1 = threefry2x32_p.bind(jnp.uint32(keys[k, 0]),
                                     jnp.uint32(keys[k, 1]), hi, lo)
        np.testing.assert_array_equal(x0[k].numpy(), np.asarray(y0))
        np.testing.assert_array_equal(x1[k].numpy(), np.asarray(y1))
    # the low counters agree with the draw layout jax.random.bits uses
    with jax.enable_x64():
        want = np.asarray(jax.random.bits(jnp.asarray(keys[0]), (8,),
                                          jnp.uint64))
    got = (x0[0, :2].numpy().astype(np.uint64) << np.uint64(32)) | \
        x1[0, :2].numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want[[0, 7]])


def test_keys_must_be_pairs():
    with pytest.raises(ValueError, match="2 words"):
        prng.fold_in(torch.zeros(3, dtype=torch.int32), 1)
