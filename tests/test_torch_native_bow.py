"""The port's native C++ BoW runtime (`native/`: the packed tree descent
and the inverted-file keyframe database), its factory
(`tracking/reloc.make_place_recognition`) and the loop probe's native
branch (`LoopCloser.dispatch_probe`), against the JAX reference's dense
oracle (`models/vocabulary.py`, `reloc.PlaceRecognition`), the port's dense
database, and the reference's `LoopCloser._probe`, on the cases of the
reference's tests/test_native_bow.py.

Tolerances: word ids, candidate ids, covisibility weights equal; L1
scores within 1e-5 (the inverted file sums min(v, w) in float over the
shared words, the dense databases over all words; the reference's own
test's tolerance), the probe's scores and floor within 1e-5.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms, vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking.reloc import PlaceRecognition as JPR  # noqa: E402
from orbslam3lib_tpu_torch import native  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms, vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking import reloc as treloc  # noqa: E402

from torch_parity import ring_world  # noqa: E402

RNG = np.random.default_rng(11)
DESCS = RNG.integers(0, 2, size=(4000, 256)).astype(np.int8)
# the reference's training on the same descriptors, in the port's types
_JVOC = jvb.train_vocabulary(DESCS[:1500], k=6, depth=3)
VOC = tvb.Vocabulary(tuple(torch.from_numpy(np.array(c)) for c in _JVOC.centroids),
                     torch.from_numpy(np.array(_JVOC.idf)), _JVOC.k, _JVOC.depth)


def test_library_builds_under_build_not_beside_the_source():
    native.library()
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.parent.parts[-2:] == ("build", "orbslam3lib_tpu_torch")
    assert not list(native.SRC.parent.glob("*.so"))


def test_descend_matches_reference_and_dense():
    got = native.NativeVocabulary(VOC).word_ids(DESCS)
    np.testing.assert_array_equal(got, np.asarray(jvb.word_ids(_JVOC, jnp.asarray(DESCS))))
    np.testing.assert_array_equal(got, tvb.word_ids(VOC, torch.from_numpy(DESCS)).numpy())


def test_pack_descriptors_popcount():
    a = native.pack_descriptors(DESCS[:10])
    assert a.shape == (10, 4) and a.dtype == np.uint64
    pc = np.array([bin(int(x)).count("1") for row in a for x in row]).reshape(10, 4).sum(1)
    np.testing.assert_array_equal(pc, DESCS[:10].sum(1))
    np.testing.assert_array_equal(native.pack_descriptors(torch.from_numpy(DESCS[:10])), a)


def test_database_matches_reference_and_dense():
    K, F = 30, 120
    rng = np.random.default_rng(5)
    jpr, tpr, nb = JPR(_JVOC, K), treloc.PlaceRecognition(VOC, K), native.NativeBowDatabase(VOC, K)
    for k in range(K):
        d, v = DESCS[k * F:(k + 1) * F], rng.random(F) < 0.9
        jpr.add(k, jnp.asarray(d), jnp.asarray(v))
        tpr.add(k, torch.from_numpy(d), torch.from_numpy(v))
        nb.add(k, d, v)
    assert nb.n_active == K
    for q in [3, 17, 29]:
        d, v = DESCS[q * F:(q + 1) * F], np.ones(F, bool)
        ids_j, s_j = jpr.query(jnp.asarray(d), jnp.asarray(v), n_best=5)
        ids_t, s_t = tpr.query(torch.from_numpy(d), torch.from_numpy(v), n_best=5)
        ids_n, s_n = nb.query(torch.from_numpy(d), torch.from_numpy(v), n_best=5)
        np.testing.assert_array_equal(ids_n, np.asarray(ids_j))
        np.testing.assert_array_equal(ids_n, ids_t.numpy())
        np.testing.assert_allclose(s_n, np.asarray(s_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(s_n, s_t.numpy(), rtol=0, atol=1e-5)
        dense = tpr.query(torch.from_numpy(d), torch.from_numpy(v), n_best=K)
        scores = nb.query_scores(d, v)
        np.testing.assert_allclose(scores[dense[0].numpy()], dense[1].numpy(), rtol=0, atol=1e-5)


def test_database_readd_and_exclude():
    K, F = 8, 100
    nb = native.NativeBowDatabase(VOC, K)
    for k in range(K):
        nb.add(k, DESCS[k * F:(k + 1) * F], np.ones(F, bool))
    assert nb.n_active == K
    nb.add(3, DESCS[3 * F:4 * F], np.ones(F, bool))          # replaces its postings
    assert nb.n_active == K
    s = nb.query_scores(DESCS[3 * F:4 * F], np.ones(F, bool))
    assert abs(s[3] - 1.0) < 1e-5
    ids, _ = nb.query(DESCS[3 * F:4 * F], np.ones(F, bool),
                      exclude_mask=torch.arange(K) == 3, n_best=2)
    assert 3 not in ids
    empty = native.NativeBowDatabase(VOC, 4)
    assert (empty.query_scores(DESCS[:F], np.ones(F, bool)) == -1.0).all()


def test_factory_prefers_native(monkeypatch, caplog):
    db = treloc.make_place_recognition(VOC, 16)
    assert isinstance(db, native.NativeBowDatabase) and db.voc is VOC
    assert isinstance(treloc.make_place_recognition(VOC, 16, prefer_native=False),
                      treloc.PlaceRecognition)
    monkeypatch.setenv("ORBSLAM3_TPU_NATIVE_BOW", "0")
    assert isinstance(treloc.make_place_recognition(VOC, 16), treloc.PlaceRecognition)
    monkeypatch.delenv("ORBSLAM3_TPU_NATIVE_BOW")
    # a library that does not build: the dense database, and the reason logged
    monkeypatch.setattr(native, "load_library", lambda: None)
    monkeypatch.setattr(native, "LOAD_ERROR", "RuntimeError: g++ failed")
    with caplog.at_level(logging.WARNING, logger=treloc.__name__):
        db = treloc.make_place_recognition(VOC, 16)
    assert isinstance(db, treloc.PlaceRecognition)
    assert "g++ failed" in caplog.text


class _ReferenceView:
    """The port's native database behind the calls the reference's
    `_probe` makes on its own (jax arrays in, numpy out)."""

    def __init__(self, db):
        self.db = db

    def query_scores(self, desc, valid):
        return self.db.query_scores(np.asarray(desc), np.asarray(valid))

    def query(self, desc, valid, exclude_mask=None, n_best=3):
        return self.db.query(np.asarray(desc), np.asarray(valid),
                             exclude_mask=np.asarray(exclude_mask), n_best=n_best)


@pytest.fixture(scope="module")
def ring():
    arrays, _, _ = ring_world()
    voc = tvb.load_vocabulary(tvb.DEFAULT_VOCAB_PATH)
    db = native.NativeBowDatabase(voc, arrays["kf_R"].shape[0])
    for i in range(int(arrays["n_kf"])):
        db.add(i, arrays["kf_desc"][i], arrays["kf_feat_valid"][i])
    return arrays, db


@pytest.mark.parametrize("kid,prev", [(12, -1), (12, 0), (12, 3), (9, -1), (9, 1)])
def test_native_probe_matches_reference(ring, kid, prev):
    """`dispatch_probe` on the native database against the reference's
    `_probe` native branch (its exclusions: covisible, the 8 nearest ids,
    within 2 s, culled; its floor; the weights against the previous
    candidate); the revisiting keyframe 12 finds keyframe 0."""
    arrays, db = ring
    arrays = dict(arrays)
    arrays["kf_valid"] = arrays["kf_valid"].copy()
    arrays["kf_valid"][2] = False                       # a culled keyframe
    jl = jlc.LoopCloser(JCfg(), _ReferenceView(db))
    tl = tlc.LoopCloser(TCfg(), db)
    jl.consistent_candidate = tl.consistent_candidate = prev
    want = jl._probe(jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}), kid)
    got = tl.dispatch_probe(tms.from_numpy(arrays), kid, int(arrays["n_kf"]))
    n = tl.PROBE_N
    assert got.shape == (3 * n + 1,)
    np.testing.assert_array_equal(got[:n], np.asarray(want[0]))
    np.testing.assert_allclose(got[n:2 * n], np.asarray(want[1]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2 * n:3 * n], np.asarray(want[2]))
    np.testing.assert_allclose(got[3 * n], want[3], rtol=0, atol=1e-5)
    if kid == 12:
        assert got[0] == 0
    assert all(s == -1.0 for i, s in zip(got[:n], got[n:2 * n]) if i == 2)   # excluded


def test_native_probe_pack_is_consumed(ring):
    """The native pack through `on_probe_result`: the consistency state
    machine counts the candidate (no BoW-match count in the pack, as in the
    reference's native branch)."""
    arrays, db = ring
    tl = tlc.LoopCloser(TCfg(), db)
    m = tms.from_numpy(arrays)
    pack = tl.dispatch_probe(m, 12, int(arrays["n_kf"]))
    tl.on_probe_result(m, 12, pack, torch.tensor([300.0, 300.0, 320.0, 200.0]))
    assert tl.consistent_candidate == int(pack[0]) == 0 and tl.consistency_count == 1
    assert tl.dispatch_probe(m, 3, 4) is None               # the probe gates
