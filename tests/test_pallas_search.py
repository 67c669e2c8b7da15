"""Fused stage-1 + sub-block max kernel (Pallas, Triton route).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
compiled for the card, the same checks run in ``chip_smoke.py`` (phase 5)
and in the ``gpu``-marked case below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dewi.ops.pallas_search import (
    SUB,
    kernel_fits,
    kernel_runs_here,
    pallas_bmax,
)
from dewi.ops.quantized import (
    quantize_rows,
    quantize_rows_int4,
    quantized_search,
    stage1_mode,
    unpack_int4,
)
from dewi.ops.similarity import EXACT_PRECISION, fused_search, l2_normalize


def _corpus(cap=2048, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(cap, d)).astype(np.float32))
    mult = jnp.asarray(rng.uniform(0.5, 1.0, cap).astype(np.float32))
    add = jnp.asarray(rng.uniform(0.0, 0.1, cap).astype(np.float32))
    return x, mult, add


def _oracle(e_int, q, q_scale, mult, add):
    """numpy float64 ``max over 128-row blocks of (q.e)*qs*mult + add``."""
    acc = np.asarray(q, np.float64) @ np.asarray(e_int, np.float64).T
    adj = acc * np.asarray(q_scale, np.float64)[:, None] * np.asarray(mult) \
        + np.asarray(add)
    return adj.reshape(q.shape[0], -1, SUB).max(-1)


def _kernel_inputs(mode, x, nq, seed=1):
    rng = np.random.default_rng(seed)
    q = l2_normalize(jnp.asarray(rng.normal(size=(nq, x.shape[1]))
                                 .astype(np.float32)))
    if mode == "bf16":
        e, _ = quantize_rows(x)
        qk = q.astype(jnp.bfloat16).astype(jnp.float32)
        return e, e, q, qk, jnp.ones((nq,), jnp.float32)
    qi, qs = quantize_rows(q)
    if mode == "s8":
        e, _ = quantize_rows(x)
        return e, e, qi, qi, qs
    p4, _ = quantize_rows_int4(x)
    return p4, unpack_int4(p4), qi, qi, qs


class TestBmaxKernel:
    @pytest.mark.parametrize("mode", ["bf16", "s8", "s4"])
    @pytest.mark.parametrize("nq", [1, 20, 70])
    def test_matches_oracle(self, mode, nq):
        """Each mode at a query count below, inside and above one tile."""
        x, mult, add = _corpus()
        e_kernel, e_int, q_in, q_oracle, qs = _kernel_inputs(mode, x, nq)
        got = np.asarray(pallas_bmax(e_kernel, mult, add, q_in, qs,
                                     mode=mode, interpret=True))
        want = _oracle(e_int, q_oracle, qs, mult, add)
        assert got.shape == (nq, x.shape[0] // SUB)
        tol = 1e-4 if mode == "bf16" else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)

    @pytest.mark.parametrize("cap", [128 * 3, 128 * 10])
    def test_misaligned_capacity(self, cap):
        """Capacities that are whole sub-blocks but not whole programs: the
        program walks fewer sub-blocks so the grid still tiles exactly."""
        x, mult, add = _corpus(cap=cap, d=32, seed=cap)
        e, e_int, q_in, q_or, qs = _kernel_inputs("s8", x, 3)
        got = np.asarray(pallas_bmax(e, mult, add, q_in, qs, mode="s8",
                                     interpret=True))
        np.testing.assert_allclose(got, _oracle(e_int, q_or, qs, mult, add),
                                   rtol=1e-5, atol=1e-5)

    def test_masked_rows_are_neg_inf(self):
        """A -inf addend (padding rows past n_valid) wins no block max."""
        x, mult, add = _corpus(cap=1024, d=32)
        add = add.at[512:].set(-jnp.inf)
        e, _, q_in, _, qs = _kernel_inputs("s8", x, 2)
        got = np.asarray(pallas_bmax(e, mult, add, q_in, qs, mode="s8",
                                     interpret=True))
        assert np.isfinite(got[:, :4]).all()
        assert np.isneginf(got[:, 4:]).all()

    def test_kernel_fits_shape_rules(self):
        assert kernel_fits(1 << 20, 256, "bf16")
        assert kernel_fits(1 << 20, 256, "s4")           # packed width 128
        assert not kernel_fits(1000, 256, "s8")          # not whole blocks
        assert not kernel_fits(1024, 384, "s8")          # width not 2^k
        assert not kernel_fits(1024, 16, "s4")           # packed width 8
        assert not kernel_fits(1024, 64, "fp8")

    def test_stage1_mode(self):
        assert stage1_mode(False, False) == "bf16"
        assert stage1_mode(True, False) == "s8"
        assert stage1_mode(True, True) == "s4"


def _search_inputs(cap=4096, d=32, nq=3, n_valid=3900, seed=7):
    rng = np.random.default_rng(seed)
    emb = l2_normalize(jnp.asarray(rng.normal(size=(cap, d))
                                   .astype(np.float32)))
    pay = jnp.asarray(np.abs(rng.normal(size=(cap, 8))).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    sqn = jnp.sum(emb * emb, axis=1)
    return emb, sqn, pay, q, jnp.int32(n_valid)


def _qsearch(emb, sqn, pay, q, n, *, int4=False, kernel=False, **kw):
    if int4:
        packed, sc = quantize_rows_int4(emb)
        e = packed if kernel else unpack_int4(packed)
        kw.update(int8_queries=True, int4_packed=kernel,
                  int4_values=not kernel)
    else:
        e, sc = quantize_rows(emb)
    return quantized_search(
        e, sc, emb, sqn, pay, q, n, jnp.float32(0.3), jnp.float32(0.1),
        k=10, m=80, blockmax_select=True, bmax_kernel=kernel,
        interpret=kernel, **kw)


class TestQuantizedSearchKernelPath:
    @pytest.mark.parametrize("queries", ["bf16", "int8", "int4"])
    @pytest.mark.parametrize("normalize", [True, False])
    def test_fused_matches_two_pass(self, queries, normalize):
        """The kernel path selects the same blocks as XLA's two-pass path
        (identical stage-1 math), so results agree exactly."""
        emb, sqn, pay, q, n = _search_inputs()
        kw = dict(normalize=normalize, int4=queries == "int4",
                  int8_queries=queries == "int8")
        s0, i0 = _qsearch(emb, sqn, pay, q, n, **kw)
        s1, i1 = _qsearch(emb, sqn, pay, q, n, kernel=True, **kw)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        np.testing.assert_allclose(np.asarray(s0), np.asarray(s1),
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("int4", [False, True])
    def test_large_batch_rescores_winning_blocks(self, int4):
        """Q > 32: no [Q, cap] scores exist on the kernel path, so the
        winning blocks are re-scored from the quantized rows; results must
        equal the two-pass path's score gather."""
        emb, sqn, pay, q, n = _search_inputs(nq=40, seed=9)
        s0, i0 = _qsearch(emb, sqn, pay, q, n, int4=int4, int8_queries=int4)
        s1, i1 = _qsearch(emb, sqn, pay, q, n, int4=int4, int8_queries=int4,
                          kernel=True)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        np.testing.assert_allclose(np.asarray(s0), np.asarray(s1),
                                   rtol=1e-6, atol=1e-6)

    def test_misfit_shape_takes_xla_path(self):
        """A capacity the kernel cannot tile silently stays on XLA — no
        kernel is traced, so this runs without interpret mode."""
        emb, sqn, pay, q, n = _search_inputs(cap=1000, n_valid=990)
        e, sc = quantize_rows(emb)
        s, i = quantized_search(
            e, sc, emb, sqn, pay, q, n, jnp.float32(0.3), jnp.float32(0.1),
            k=10, m=80, blockmax_select=True, bmax_kernel=True)
        assert int(np.asarray(i).max()) < 990
        assert np.isfinite(np.asarray(s)).all()

    def test_refine_runs_at_exact_precision(self):
        """Stage 2 re-scores candidates at EXACT_PRECISION: with full refine
        the scores equal a float32 HIGHEST-precision oracle."""
        emb, sqn, pay, q, n = _search_inputs(cap=1024, n_valid=1024)
        e, sc = quantize_rows(emb)
        s, i = quantized_search(
            e, sc, emb, sqn, pay, q, n, jnp.float32(0.3), jnp.float32(0.1),
            k=10, m=1024, blockmax_select=False, approx_select=False)
        qn = l2_normalize(q)
        sim = jnp.dot(qn, emb.T, precision=EXACT_PRECISION)
        adj = 0.7 * sim + 0.3 * pay[:, 0] + 0.1 * 0.5 * (pay[:, 1] + pay[:, 3])
        want_s, want_i = jax.lax.top_k(adj, 10)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(want_i))
        np.testing.assert_allclose(np.asarray(s), np.asarray(want_s),
                                   rtol=1e-6, atol=1e-6)


class TestKernelChoice:
    def test_cpu_takes_xla_path(self):
        from dewi.index import QuantizedIndex

        assert not kernel_runs_here()
        rng = np.random.default_rng(0)
        idx = QuantizedIndex(dim=32, int4_storage=True)
        idx.add_batch([str(i) for i in range(600)],
                      rng.normal(size=(600, 32)).astype(np.float32),
                      np.abs(rng.normal(size=(600, 8))).astype(np.float32))
        idx.build()
        assert idx._kernel is False
        assert idx._q_emb.shape[1] == 32        # unpacked once at build

    def test_gpu_build_keeps_int4_packed(self, monkeypatch):
        import dewi.index.quantized as qmod

        monkeypatch.setattr(qmod, "kernel_runs_here", lambda: True)
        rng = np.random.default_rng(1)
        idx = qmod.QuantizedIndex(dim=32, int4_storage=True)
        idx.add_batch([str(i) for i in range(600)],
                      rng.normal(size=(600, 32)).astype(np.float32),
                      np.abs(rng.normal(size=(600, 8))).astype(np.float32))
        idx.build()
        assert idx._kernel is True
        assert idx._q_emb.shape[1] == 16        # packed nibbles stay packed
        # blockmax off: no kernel, whatever the platform.
        idx2 = qmod.QuantizedIndex(dim=32, blockmax_select=False)
        idx2.add_batch(["a"] * 0, np.zeros((0, 32), np.float32),
                       np.zeros((0, 8), np.float32))
        assert idx2._kernel_ok() is False


class TestExactTierXLA:
    """The exact tier's XLA path (no kernel on this tier)."""

    def _arrays(self, cap=2048, d=32, nq=5, seed=2):
        rng = np.random.default_rng(seed)
        emb = np.asarray(l2_normalize(
            jnp.asarray(rng.normal(size=(cap, d)).astype(np.float32))))
        pay = np.abs(rng.normal(size=(cap, 8))).astype(np.float32)
        q = rng.normal(size=(nq, d)).astype(np.float32)
        sqn = jnp.sum(jnp.asarray(emb) ** 2, axis=1)
        return jnp.asarray(emb), sqn, jnp.asarray(pay), jnp.asarray(q)

    def test_two_pass_blockmax_is_bit_identical(self):
        """Selection over the SAME materialized scores: values must be the
        flat top-k's values exactly, for both spaces and across k."""
        emb, sqn, pay, q = self._arrays()
        for normalize in (True, False):
            for k in (1, 10, 100):
                s0, i0 = fused_search(
                    emb, sqn, pay, q, jnp.int32(1900), jnp.float32(0.3),
                    jnp.float32(0.1), k=k, normalize=normalize)
                s1, i1 = fused_search(
                    emb, sqn, pay, q, jnp.int32(1900), jnp.float32(0.3),
                    jnp.float32(0.1), k=k, normalize=normalize,
                    blockmax_select=True)
                np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
                np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))

    def test_bf16_store_runs_bf16_dot(self):
        """A bf16 corpus is scored bf16 x bf16 with f32 accumulation: the
        values equal an oracle on bf16-rounded operands."""
        emb, sqn, pay, q = self._arrays()
        e16 = emb.astype(jnp.bfloat16)
        s, i = fused_search(e16, sqn, pay, q, jnp.int32(2048),
                            jnp.float32(0.3), jnp.float32(0.1), k=10)
        qb = np.asarray(l2_normalize(q).astype(jnp.bfloat16), np.float64)
        sim = qb @ np.asarray(e16.astype(jnp.float32),
                                          np.float64).T
        p = np.asarray(pay, np.float64)
        adj = 0.7 * sim + 0.3 * p[:, 0] + 0.05 * (p[:, 1] + p[:, 3])
        np.testing.assert_allclose(np.asarray(s), -np.sort(-adj, 1)[:, :10],
                                   rtol=1e-5, atol=1e-5)

    def test_blockmax_validity_mask(self):
        """Padded rows (>= n_valid) must never surface through blockmax."""
        emb, sqn, pay, q = self._arrays()
        for dtype in (jnp.float32, jnp.bfloat16):
            s, i = fused_search(
                emb.astype(dtype), sqn, pay, q, jnp.int32(300),
                jnp.float32(0.3), jnp.float32(0.1), k=10, normalize=True,
                blockmax_select=True)
            assert int(np.asarray(i).max()) < 300
            assert np.isfinite(np.asarray(s)).all()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu():
    """The compiled (not interpreted) kernel at 1M x 256 against the numpy
    oracle (a host reference: XLA may narrow an f32 dot of bf16/int8
    operands on the GPU)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: the compiled Triton kernel has no CPU "
                    "lowering (its arithmetic is checked in interpret mode "
                    "above, and on the card by chip_smoke.py phase 5)")
    x, mult, add = _corpus(cap=1 << 20, d=256)
    for mode in ("bf16", "s8", "s4"):
        e, e_int, q_in, q_or, qs = _kernel_inputs(mode, x, 32)
        got = pallas_bmax(e, mult, add, q_in, qs, mode=mode)
        want = _oracle(e_int, q_or, qs, mult, add)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4)
