"""The BoW vocabulary and the keyframe database of the port against the JAX
reference (`models/vocabulary.py`, `tracking/reloc.PlaceRecognition`), on
the vocabulary file the repository ships (k=10, depth 4) and on seeded 0/1
descriptors made with numpy.

Tolerances: word ids, trained centroids and query ids are equal (integer
Hamming distances, first-index argmin); idf of a trained vocabulary is
equal (the same f64 numpy arithmetic on the same word ids); BoW vectors
and L1 scores within 1e-6 (f32 sums of up to 512 terms in another order).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.models import vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking import reloc as jrl  # noqa: E402
from orbslam3lib_tpu_torch.models import vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking import reloc as trl  # noqa: E402


@pytest.fixture(scope="module")
def vocs():
    return jvb.load_vocabulary(jvb.DEFAULT_VOCAB_PATH), \
        tvb.load_vocabulary(tvb.DEFAULT_VOCAB_PATH)


def _bits(n, seed, p=0.5):
    return (np.random.default_rng(seed).random((n, 256)) < p).astype(np.int8)


def _near_copies(base, n, flips, seed):
    """n descriptors, each `base[i % len(base)]` with `flips` random bits
    flipped: keyframe-like sets that share words."""
    rng = np.random.default_rng(seed)
    out = base[np.arange(n) % len(base)].copy()
    for row in out:
        row[rng.choice(256, flips, replace=False)] ^= 1
    return out


def test_default_path_and_arrays_equal(vocs):
    jv, tv = vocs
    assert os.path.samefile(tvb.DEFAULT_VOCAB_PATH, jvb.DEFAULT_VOCAB_PATH)
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words) == (10, 4, 10_000)
    for c_t, c_j in zip(tv.centroids, jv.centroids):
        assert c_t.dtype == torch.int8
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.5), (2, 0.1), (3, 0.9)])
def test_word_ids_equal_with_ties(vocs, seed, p):
    """Random bits put many descriptors at equal distance from two children;
    both packages must take the lower child. The test checks that ties are
    reached at the first level."""
    jv, tv = vocs
    d = _bits(512, seed, p)
    w_t = tvb.word_ids(tv, torch.from_numpy(d)).numpy()
    w_j = np.asarray(jvb.word_ids(jv, jnp.asarray(d)))
    np.testing.assert_array_equal(w_t, w_j)
    c0 = np.asarray(jv.centroids[0]).astype(np.int32)
    ham = (d[:, None, :] != c0[None]).sum(-1)
    assert ((ham == ham.min(1, keepdims=True)).sum(1) > 1).any()


@pytest.mark.parametrize("n_valid", [512, 300, 0])
def test_bow_vector_and_l1_scores(vocs, n_valid):
    jv, tv = vocs
    d = _bits(512, 10)
    valid = np.arange(512) < n_valid
    v_t = tvb.bow_from_descriptors(tv, torch.from_numpy(d), torch.from_numpy(valid))
    v_j = jvb.bow_from_descriptors(jv, jnp.asarray(d), jnp.asarray(valid))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-6)
    db = np.stack([np.asarray(jvb.bow_from_descriptors(
        jv, jnp.asarray(_near_copies(d, 512, 40, s)), jnp.ones(512, bool)))
        for s in range(4)])
    s_t = tvb.l1_scores(torch.from_numpy(db), v_t).numpy()
    s_j = np.asarray(jvb.l1_scores(jnp.asarray(db), v_j))
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_docs", [False, True])
def test_train_vocabulary_bit_equal(with_docs):
    """The numpy k-medians is the reference's own code: with the same seed
    the same centroids; with document ids the same idf (it descends the
    trained tree, so the descent is exercised too)."""
    d = _bits(600, 20)
    docs = np.arange(600) // 100 if with_docs else None
    tv = tvb.train_vocabulary(d, k=4, depth=3, n_iter=4, seed=7, doc_ids=docs)
    jv = jvb.train_vocabulary(d, k=4, depth=3, n_iter=4, seed=7, doc_ids=docs)
    for c_t, c_j in zip(tv.centroids, jv.centroids):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


def test_save_vocabulary_round_trip(tmp_path):
    """A vocabulary the port saves loads unchanged in both packages."""
    tv = tvb.train_vocabulary(_bits(300, 21), k=4, depth=2, n_iter=2, seed=3,
                              doc_ids=np.arange(300) // 50)
    path = str(tmp_path / "voc.npz")
    tvb.save_vocabulary(tv, path)
    for loaded in (tvb.load_vocabulary(path), jvb.load_vocabulary(path)):
        assert (loaded.k, loaded.depth) == (4, 2)
        for c, c0 in zip(loaded.centroids, tv.centroids):
            np.testing.assert_array_equal(np.asarray(c), c0.numpy())
        np.testing.assert_array_equal(np.asarray(loaded.idf), tv.idf.numpy())


def test_place_recognition_query(vocs):
    """Add six keyframes to both databases and query near copies of three
    of them, with and without excluding keyframes: the same ids."""
    jv, tv = vocs
    rng = np.random.default_rng(30)
    kfs = [_bits(400, 40 + i) for i in range(6)]
    valid = rng.random(400) < 0.9
    jp = jrl.make_place_recognition(jv, 16, prefer_native=False)
    tp = trl.make_place_recognition(tv, 16)
    for i, d in enumerate(kfs):
        jp.add(i * 2, jnp.asarray(d), jnp.asarray(valid))
        tp.add(i * 2, torch.from_numpy(d), torch.from_numpy(valid))
    np.testing.assert_allclose(tp.bow_db.numpy(), np.asarray(jp.bow_db), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.active.numpy(), np.asarray(jp.active))
    exclude = np.zeros(16, bool)
    exclude[4] = True
    for src in (0, 2, 4):
        q = _near_copies(kfs[src], 400, 30, 50 + src)
        for ex in (None, exclude):
            ids_j, s_j = jp.query(jnp.asarray(q), jnp.asarray(valid),
                                  None if ex is None else jnp.asarray(ex))
            ids_t, s_t = tp.query(torch.from_numpy(q), torch.from_numpy(valid),
                                  None if ex is None else torch.from_numpy(ex))
            np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)
            if ex is None:
                assert int(ids_t[0]) == 2 * src
            else:
                assert 4 not in ids_t.tolist()
