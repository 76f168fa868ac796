"""The LK pyramid's blur + decimation on the CPU: the plain twin of
``csrc/pyramid.cu`` (``ops/lk.py::pyr_down_plain``) against the banded
products that ``pyr_down`` runs on a CPU tensor, ``build_pyramid``
against the JAX package's, and the twin's ``fmaf`` against exact
rational arithmetic. The kernel itself is held to the twin on the card
(``tests/test_torch_cuda.py``)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_annotator_tpu.ops import lk as jlk
from video_annotator_tpu_torch.ops import lk
from video_annotator_tpu_torch.ops.warp_plain import box_downsample


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def levels_input(kind: str, shape, seed: int) -> torch.Tensor:
    """Values as the analysers' level 0 holds them: integers (a uint8
    frame tracked at full size) or quarters (``box_downsample`` of a
    uint8 frame at level 1, the 4K cell's analysis scale)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "integer":
        return torch.randint(0, 256, shape, generator=g).to(torch.float32)
    big = torch.randint(0, 256, (*shape[:-2], 2 * shape[-2], 2 * shape[-1]), generator=g)
    return box_downsample(big.to(torch.float32), 1)


# (kind, shape, levels the products are exact at): even and odd sides, no
# batch, one and two leading axes, a level 1 of one row or one column.
CASES = [
    ("integer", (48, 64), 2),
    ("integer", (3, 61, 83), 2),
    ("integer", (2, 2, 30, 17), 2),
    ("integer", (2, 9, 6), 2),
    ("integer", (5, 2, 7), 1),
    ("integer", (3, 40, 3), 1),
    ("quarter", (3, 54, 96), 1),
    ("quarter", (2, 45, 77), 1),
    ("quarter", (4, 3, 10), 1),
]


@pytest.mark.parametrize("kind,shape,exact", CASES)
def test_plain_pyramid_is_the_banded_products(kind, shape, exact):
    img = levels_input(kind, shape, seed=sum(shape))
    banded, plain = img, img
    for _ in range(exact):
        banded, plain = lk.pyr_down_banded(banded), lk.pyr_down_plain(plain)
        assert plain.shape == (*shape[:-2], banded.shape[-2], banded.shape[-1])
        assert torch.equal(plain, banded)
    assert torch.equal(lk.pyr_down(img), lk.pyr_down_banded(img))

    got = lk.build_pyramid(img, exact + 1)
    frames = img.reshape(-1, *shape[-2:]).numpy()
    for i, frame in enumerate(frames):
        want = jlk.build_pyramid(jnp.asarray(frame), exact + 1)
        for level, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.reshape(-1, *g.shape[-2:])[i].numpy(),
                                          np.asarray(w), err_msg=f"level {level}")


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the rational ``q``, ties to even."""
    f = np.float32(float(q))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - q)
        key = (d, int(np.array(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def test_plain_fmaf_rounds_once():
    """Over random triples, sums of k/16 entries and the case a product
    of two float32 puts 2^-60 past the midpoint of 1 and its successor:
    there a float64 sum rounds onto the midpoint and then, to even, down,
    where ``fmaf`` rounds up."""
    rng = np.random.default_rng(5)
    n = 2000
    a = np.concatenate([rng.choice(np.float32([1, 4, 6, 4, 1, 11, 5]) / 16, n),
                        rng.normal(size=n).astype(np.float32), [4097 * 2.0 ** -30]])
    b = np.concatenate([(rng.random(n) * 256).astype(np.float32),
                        rng.normal(size=n).astype(np.float32) * 1e-3, [16773121 * 2.0 ** -30]])
    c = np.concatenate([(rng.random(n) * 256).astype(np.float32),
                        rng.normal(size=n).astype(np.float32), [1.0]])
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    got = lk._fmaf(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.nextafter(np.float32(1), np.float32(2))
    naive = np.float32(np.float64(a[-1]) * np.float64(b[-1]) + np.float64(c[-1]))
    assert naive == np.float32(1)
