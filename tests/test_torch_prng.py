"""The port's threefry stream (`repro_torch.core.prng`) against JAX's own,
bit for bit, on the CPU.

  * `split` (n = 1, 2, 3) and `random_bits32` over a hypothesis grid of
    seeds and shapes that holds seeds 0 and 2^31 - 1;
  * `permutation` at n = 1 (no round), 2, 54 (the Covertype width), 533
    (the kNN head's), 1,625 and 1,626 (the last size of one sort round and
    the first of two), 1,627 and 200,000, a size whose 32-bit sort keys tie:
    only a stable sort gives JAX's permutation there;
  * the trainer's 20-tree key chain `key, sub, sub2 = split(key, 3)`.

The card's sort is held to the CPU's by `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import prng  # noqa: E402

torch.set_num_threads(1)

SEEDS = st.one_of(st.sampled_from([0, 2 ** 31 - 1]),
                  st.integers(0, 2 ** 31 - 1))
GRID = settings(max_examples=60, deadline=None)
TIE_ROWS = 200_000


def _jax_key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@GRID
@given(seed=SEEDS, n=st.sampled_from([1, 2, 3]))
def test_split_is_jax_split(seed, n):
    key = _jax_key(seed)
    got = prng.split(key, n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, np.asarray(jax.random.split(key, n)))


@GRID
@given(seed=SEEDS, shape=st.sampled_from([(1,), (7,), (54,), (3, 5),
                                          (2, 3, 4)]))
def test_random_bits32_is_jax_bits(seed, shape):
    key = _jax_key(seed)
    got = prng.random_bits32(key, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    want = np.asarray(jax.random.bits(key, shape, dtype=np.uint32))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("n", [1, 2, 54, 533, 1625, 1626, 1627])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_permutation_is_jax_permutation(seed, n):
    key = _jax_key(seed)
    got = prng.permutation(key, n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.permutation(key, n)))


def test_shuffle_rounds_switch_where_jax_switches():
    assert [prng.shuffle_rounds(n) for n in (1, 2, 1625, 1626, 325_360)] \
        == [0, 1, 1, 2, 2]


def test_permutation_with_tied_sort_keys_is_jax_permutation():
    key = _jax_key(0)
    _, sub = prng.split(key)
    sort_keys = prng.random_bits32(sub, (TIE_ROWS,))
    ties = TIE_ROWS - torch.unique(sort_keys).numel()
    assert ties > 0                 # about n^2 / 2^33 pairs tie
    want = np.asarray(jax.random.permutation(key, TIE_ROWS))
    np.testing.assert_array_equal(prng.permutation(key, TIE_ROWS).numpy(),
                                  want)
    # the order of tied rows decides the permutation: taking them last
    # row first instead of first row first gives another one
    rows = torch.arange(TIE_ROWS - 1, -1, -1)
    reordered = rows[torch.sort(sort_keys[rows], stable=True).indices]
    first = torch.sort(sort_keys, stable=True).indices
    assert not torch.equal(reordered, first)


def test_key_chain_of_twenty_trees_is_jax():
    key, jkey = prng.initial_key(5), jax.random.PRNGKey(5)
    for _ in range(20):
        key, sub, sub2 = prng.split(key, 3)
        jkey, jsub, jsub2 = jax.random.split(jkey, 3)
        for got, want in ((key, jkey), (sub, jsub), (sub2, jsub2)):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_key_must_be_a_pair():
    with pytest.raises(ValueError, match="shape"):
        prng.split(np.zeros((3,), np.uint32))
