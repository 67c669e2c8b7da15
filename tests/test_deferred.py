"""DeferredFetcher: deferred device→host fetch accumulator."""

import numpy as np
import jax.numpy as jnp

from dewi.utils.deferred import DeferredFetcher


class TestDeferredFetcher:
    def test_offsets_and_result_order(self):
        f = DeferredFetcher()
        a = jnp.arange(6, dtype=jnp.float32)
        b = jnp.arange(6, 12, dtype=jnp.float32)
        assert f.append(a) == 0
        assert f.append(b) == 6
        out = f.result()
        np.testing.assert_array_equal(out, np.arange(12, dtype=np.float32))

    def test_keep_strips_pad_rows(self):
        f = DeferredFetcher()
        part = jnp.stack([jnp.full(3, i, jnp.float32) for i in range(4)])
        off = f.append(part, keep=2)  # rows 2..3 are batch padding
        assert off == 0
        # Offsets count KEPT rows only.
        assert f.append(jnp.zeros((1, 3), jnp.float32)) == 2
        out = f.result()
        assert out.shape == (3, 3)
        np.testing.assert_array_equal(out[0], np.zeros(3))
        np.testing.assert_array_equal(out[1], np.ones(3))

    def test_budget_flush_preserves_global_order(self):
        # A 1-byte budget forces a flush on every append; result order and
        # offsets must match the unbounded case exactly.
        f = DeferredFetcher(budget_mb=0)
        f.budget = 1
        offs = [f.append(jnp.full((2,), i, jnp.float32)) for i in range(5)]
        assert offs == [0, 2, 4, 6, 8]
        out = f.result()
        np.testing.assert_array_equal(
            out, np.repeat(np.arange(5, dtype=np.float32), 2)
        )

    def test_cost_charges_budget(self):
        f = DeferredFetcher(budget_mb=1)
        f.append(jnp.zeros(4, jnp.float32), cost=2 << 20)  # over budget
        assert not f._parts  # flushed immediately
        assert f.result().shape == (4,)

    def test_empty(self):
        f = DeferredFetcher()
        assert f.result().shape == (0,)

    def test_single_pad_stripped_part_does_not_retain_buffer(self):
        # A lone pad-stripped part is a leading view of the flush buffer;
        # result() must return memory independent of the padded buffer
        # (round-3 review: ascontiguousarray passed the view through).
        f = DeferredFetcher()
        f.append(jnp.ones((8, 4), jnp.float32), keep=2)
        out = f.result()
        assert out.shape == (2, 4)
        assert out.base is None or out.base.size == out.size
