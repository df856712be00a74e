"""MNIST data pipeline.

Reference parity: the reference loads ``data/mnist.pkl`` — the classic
deeplearning.net 3-way pickle ``(train, valid, test)`` with ``x`` as
``float32 [N, 784]`` in ``[0, 1]`` and integer labels — and one-hot encodes
labels with ``pd.get_dummies`` (reference: mnist_sync/model/model.py:6-14).
This module reproduces those semantics (numpy one-hot instead of pandas) and
adds a deterministic *procedural* MNIST-style dataset with identical shapes
and dtypes for hermetic environments with no network egress: glyph-rendered
digits with random shift / thickness / intensity / noise augmentation.

The procedural set is fully determined by its seed, so convergence tests and
benchmarks are reproducible bit-for-bit across runs and hosts.

This is the PyTorch port's own numpy copy of ``ddl_tpu/data/mnist.py``
(the port imports nothing of ``ddl_tpu``): ``synthesize(n, seed)`` is
byte-equal to the JAX package's, pinned by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

NUM_CLASSES = 10
IMAGE_DIM = 784  # 28 x 28

# 5x7 bitmap glyphs for digits 0-9 (classic dot-matrix font).
_GLYPHS = {
    0: ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    1: ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    2: ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    3: ("11111", "00010", "00100", "00010", "00001", "10001", "01110"),
    4: ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    5: ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    6: ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    7: ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    8: ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    9: ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
}


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Train/test split with the reference's shapes.

    ``x_*``: float32 ``[N, 784]`` in [0, 1]; ``y_*``: int32 ``[N]`` labels.
    Mirrors ``Model.x_train/y_train/x_test/y_test``
    (reference: mnist_sync/model/model.py:10-14), except labels stay integer
    here and are one-hot encoded on demand.
    """

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_train(self) -> int:
        return self.x_train.shape[0]

    @property
    def num_test(self) -> int:
        return self.x_test.shape[0]

    def train_onehot(self) -> np.ndarray:
        return one_hot(self.y_train)

    def test_onehot(self) -> np.ndarray:
        return one_hot(self.y_test)


def one_hot(labels: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Numpy equivalent of the reference's ``pd.get_dummies(y)``
    (mnist_sync/model/model.py:13-14): float32 ``[N, 10]``."""
    labels = np.asarray(labels)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def _blur3(img: np.ndarray) -> np.ndarray:
    """Separable 3-tap binomial blur ([1,2,1]/4 per axis) over the last two
    axes, zero-padded. Vectorized over leading axes."""
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    padded = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(1, 1), (0, 0)])
    img = (
        k[0] * padded[..., :-2, :]
        + k[1] * padded[..., 1:-1, :]
        + k[2] * padded[..., 2:, :]
    )
    padded = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(0, 0), (1, 1)])
    return (
        k[0] * padded[..., :, :-2]
        + k[1] * padded[..., :, 1:-1]
        + k[2] * padded[..., :, 2:]
    )


def _glyph_bases() -> np.ndarray:
    """Render the base bank: ``[10 digits, 2 thicknesses, 34, 34]`` floats.

    Each 5x7 glyph is upscaled 3x (15x21), optionally dilated one pixel
    (thickness variant), centered on a 28x28 canvas, blurred, then padded to
    34x34 so +/-3-pixel shifts are pure slicing.
    """
    bases = np.zeros((NUM_CLASSES, 2, 34, 34), dtype=np.float32)
    for digit, rows in _GLYPHS.items():
        glyph = np.array([[c == "1" for c in row] for row in rows], dtype=np.float32)
        big = np.kron(glyph, np.ones((3, 3), dtype=np.float32))  # 21x15
        for thick in range(2):
            g = big
            if thick:
                # 1-pixel 4-neighbour dilation for a bolder stroke.
                p = np.pad(g, 1)
                g = np.maximum.reduce(
                    [p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]]
                )
            canvas = np.zeros((28, 28), dtype=np.float32)
            top, left = (28 - g.shape[0]) // 2, (28 - g.shape[1]) // 2
            canvas[top : top + g.shape[0], left : left + g.shape[1]] = g
            bases[digit, thick] = np.pad(_blur3(canvas), 3)
    return bases


def synthesize(
    num_samples: int, seed: int, *, max_shift: int = 3, noise: float = 0.08
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic procedural MNIST-style images.

    Returns ``(x [N, 784] float32 in [0,1], y [N] int32)``. Labels cycle
    through 0-9 then are shuffled, so every class is balanced to within one
    sample. Augmentation: per-sample shift in ``[-max_shift, max_shift]^2``,
    thickness variant, intensity scale in [0.7, 1.0], additive Gaussian
    noise, clipped to [0, 1].
    """
    rng = np.random.default_rng(np.random.PCG64(seed))
    bases = _glyph_bases()

    y = np.arange(num_samples, dtype=np.int32) % NUM_CLASSES
    rng.shuffle(y)
    thick = rng.integers(0, 2, size=num_samples)
    dy = rng.integers(-max_shift, max_shift + 1, size=num_samples)
    dx = rng.integers(-max_shift, max_shift + 1, size=num_samples)

    x = np.empty((num_samples, 28, 28), dtype=np.float32)
    # Group by (dy, dx): each group is a pure slice of the padded base bank.
    span = 2 * max_shift + 1
    shift_id = (dy + max_shift) * span + (dx + max_shift)
    for sid in np.unique(shift_id):
        idx = np.nonzero(shift_id == sid)[0]
        sy, sx = divmod(int(sid), span)
        sy -= max_shift
        sx -= max_shift
        window = bases[:, :, 3 + sy : 31 + sy, 3 + sx : 31 + sx]
        x[idx] = window[y[idx], thick[idx]]

    x *= rng.uniform(0.7, 1.0, size=(num_samples, 1, 1)).astype(np.float32)
    x += rng.normal(0.0, noise, size=x.shape).astype(np.float32)
    np.clip(x, 0.0, 1.0, out=x)
    return x.reshape(num_samples, IMAGE_DIM), y


def load_mnist(
    path: str | os.PathLike | None = "data/mnist.pkl",
    *,
    synthetic_train: int = 50_000,
    synthetic_test: int = 10_000,
    seed: int = 0,
) -> Dataset:
    """Load MNIST with the reference's semantics, or synthesize it.

    If ``path`` exists it must be the 3-way pickle the reference consumes
    (mnist_sync/model/model.py:8-11): ``(train, valid, test)`` tuples of
    ``(x, y)``; like the reference, the validation split is discarded.
    Otherwise a deterministic procedural dataset of the requested size is
    generated (train seed = ``seed``, test seed = ``seed + 1``).
    """
    if path is not None and os.path.exists(path):
        with open(path, "rb") as f:
            train_set, _, test_set = pickle.load(f, encoding="latin1")
        x_train, y_train = train_set
        x_test, y_test = test_set
        return Dataset(
            x_train=np.asarray(x_train, dtype=np.float32),
            y_train=np.asarray(y_train, dtype=np.int32),
            x_test=np.asarray(x_test, dtype=np.float32),
            y_test=np.asarray(y_test, dtype=np.int32),
        )
    x_train, y_train = synthesize(synthetic_train, seed)
    x_test, y_test = synthesize(synthetic_test, seed + 1)
    return Dataset(x_train=x_train, y_train=y_train, x_test=x_test, y_test=y_test)
