"""The port's MNIST pipeline (ddl_tpu_torch/data/mnist.py) against the JAX
package's (ddl_tpu/data/mnist.py): the procedural set is byte-equal for
the same seed, one-hot and the mnist.pkl semantics are identical."""

import pickle

import numpy as np
import pytest

from ddl_tpu.data import mnist as jax_mnist
from ddl_tpu_torch.data import mnist as torch_mnist


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 3), (1000, 11)])
def test_synthesize_byte_equal(n, seed):
    xj, yj = jax_mnist.synthesize(n, seed)
    xt, yt = torch_mnist.synthesize(n, seed)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
    assert xt.tobytes() == xj.tobytes()
    assert yt.tobytes() == yj.tobytes()


def test_one_hot_equal():
    labels = np.random.default_rng(5).integers(0, 10, size=97).astype(np.int32)
    np.testing.assert_array_equal(torch_mnist.one_hot(labels), jax_mnist.one_hot(labels))
    assert torch_mnist.one_hot(labels).dtype == np.float32


def test_load_mnist_pickle_semantics(tmp_path):
    """A 3-way (train, valid, test) pickle loads identically; the
    validation split is discarded, as in the reference."""
    rng = np.random.default_rng(2)
    split = lambda n: (rng.random((n, 784), dtype=np.float32),
                       rng.integers(0, 10, size=n))
    path = tmp_path / "mnist.pkl"
    with open(path, "wb") as f:
        pickle.dump((split(20), split(5), split(8)), f)
    dj = jax_mnist.load_mnist(path)
    dt = torch_mnist.load_mnist(path)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(dt, field), getattr(dj, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert dt.num_train == 20 and dt.num_test == 8


def test_load_mnist_synthetic_fallback_equal():
    dj = jax_mnist.load_mnist(None, synthetic_train=64, synthetic_test=16, seed=4)
    dt = torch_mnist.load_mnist(None, synthetic_train=64, synthetic_test=16, seed=4)
    assert dt.x_train.tobytes() == dj.x_train.tobytes()
    assert dt.x_test.tobytes() == dj.x_test.tobytes()
    np.testing.assert_array_equal(dt.test_onehot(), dj.test_onehot())
