"""Reference-compatible import-surface tests.

Code written against the reference's module layout (``dewi.backends``,
``dewi.robust``, ``dewi.local_weights`` — SURVEY.md §1) must keep working
against this package with only the top-level name changed.
"""

import numpy as np
import pytest


class TestBackendsShim:
    def test_reference_imports(self):
        from dewi.backends import (
            _HAS_FAISS,
            _HAS_HNSW,
            BaseIndex,
            ExactIndex,
            FAISSIndex,
            HNSWIndex,
            IndexBackend,
        )

        assert _HAS_FAISS is True and _HAS_HNSW is True
        assert issubclass(HNSWIndex, BaseIndex)
        assert issubclass(FAISSIndex, BaseIndex)

    def test_hnsw_alias_searches(self, rng, dummy_embeddings, dummy_payloads):
        from dewi.backends import HNSWIndex
        from dewi.types import payloads_to_matrix

        idx = HNSWIndex(dim=32)
        idx.add_batch([str(i) for i in range(64)], dummy_embeddings,
                      payloads_to_matrix(dummy_payloads))
        idx.build()
        res = idx.search(rng.normal(size=32).astype(np.float32), k=3)
        assert len(res) == 3

    def test_faiss_alias_is_ivf(self):
        from dewi.backends import FAISSIndex
        from dewi.index.ivf import IVFIndex

        assert FAISSIndex is IVFIndex

    def test_backend_enum_from_str(self):
        from dewi.backends import IndexBackend

        assert IndexBackend.from_str("auto") is IndexBackend.EXACT
        assert IndexBackend.from_str("faiss_ivfflat") is IndexBackend.FAISS_IVFFLAT


class TestRobustShim:
    def test_payload_fit_surface(self, dummy_payloads):
        from dewi.robust import PAYLOAD_STAT_FIELDS, RobustStats

        stats = RobustStats.from_payloads(dummy_payloads)
        assert set(stats.keys) == set(PAYLOAD_STAT_FIELDS)
        z = stats.z("ht_mean", 5.0)
        assert np.isfinite(z)

    def test_robust_standardize_helper(self):
        from dewi.robust import _robust_standardize

        # Additive-epsilon variant (reference robust.py:8-10).
        z = _robust_standardize(2.0, 1.0, 0.5)
        assert z == pytest.approx((2.0 - 1.0) / (1.4826 * (0.5 + 1e-8)),
                                  rel=1e-9)


class TestLocalWeightsShim:
    def test_import_and_shape(self, rng):
        from dewi.local_weights import local_weights_from_surprisal

        s = rng.gamma(2.0, 1.0, size=50).astype(np.float32)
        w = local_weights_from_surprisal(s)
        assert w.shape == (50,)
        assert np.all(w > 0)
