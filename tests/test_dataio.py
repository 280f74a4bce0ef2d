"""Packed datasets + streaming minibatch loader (native C++ and fallback).

The native/fallback bit-identical-stream contract is the loader's version
of this repo's standing native-equivalence invariant (csv parser:
tests/test_native.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gogp.utils import dataio


def _make(tmp_path, n=64, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5, size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    path = tmp_path / "data.ggpd"
    dataio.pack_dataset(path, x, y)
    return path, x, y


class TestPackedFormat:
    def test_roundtrip(self, tmp_path):
        path, x, y = _make(tmp_path)
        assert dataio.read_header(path) == (64, 3)
        x2, y2 = dataio.load_dataset(path)
        np.testing.assert_array_equal(x2, x)
        np.testing.assert_array_equal(y2, y)

    def test_1d_x_and_length_mismatch(self, tmp_path):
        dataio.pack_dataset(tmp_path / "a.ggpd", np.arange(5.0), np.arange(5.0))
        assert dataio.read_header(tmp_path / "a.ggpd") == (5, 2)
        with pytest.raises(ValueError):
            dataio.pack_dataset(tmp_path / "b.ggpd", np.zeros((3, 1)), np.zeros(4))

    def test_bad_magic(self, tmp_path):
        p = tmp_path / "junk.bin"
        p.write_bytes(b"\x00" * 64)
        with pytest.raises(ValueError):
            dataio.read_header(p)


class TestStream:
    def test_fallback_batches_are_in_range_and_from_data(self, tmp_path):
        path, x, y = _make(tmp_path, n=32)
        rows = {tuple(np.concatenate([xi, [yi]])) for xi, yi in zip(x, y)}
        with dataio.MinibatchStream(path, batch=8, seed=7, native=False) as st:
            for _ in range(5):
                xb, yb = next(st)
                assert xb.shape == (8, 2) and yb.shape == (8,)
                for xi, yi in zip(xb, yb):
                    assert tuple(np.concatenate([xi, [yi]])) in rows

    def test_stream_is_deterministic_in_seed(self, tmp_path):
        path, _, _ = _make(tmp_path)
        with dataio.MinibatchStream(path, batch=4, seed=3, native=False) as a, \
             dataio.MinibatchStream(path, batch=4, seed=3, native=False) as b, \
             dataio.MinibatchStream(path, batch=4, seed=4, native=False) as c:
            xa, ya = next(a)
            xb, yb = next(b)
            xc, _ = next(c)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert not np.array_equal(xa, xc)

    @pytest.mark.skipif(not dataio._native_available(), reason="native lib not built")
    def test_native_matches_fallback_bitwise(self, tmp_path):
        path, _, _ = _make(tmp_path, n=100, d=3)
        with dataio.MinibatchStream(path, batch=16, seed=42, native=True) as nat, \
             dataio.MinibatchStream(path, batch=16, seed=42, native=False) as py:
            for _ in range(20):
                xn, yn = next(nat)
                xp, yp = next(py)
                np.testing.assert_array_equal(xn, xp)
                np.testing.assert_array_equal(yn, yp)

    @pytest.mark.skipif(not dataio._native_available(), reason="native lib not built")
    def test_native_prefetch_survives_many_batches(self, tmp_path):
        path, _, _ = _make(tmp_path, n=17)  # odd size exercises modulo
        with dataio.MinibatchStream(path, batch=5, seed=1, capacity=2, native=True) as st:
            total = 0.0
            for _ in range(200):
                xb, yb = next(st)
                total += float(yb.sum())
            assert np.isfinite(total)


class TestSVGPStream:
    def test_stream_training_matches_in_memory_estimator(self, tmp_path):
        from gogp.gp import core, sparse
        from gogp.kernels import normal as rbf, uniform_noise

        rng = np.random.default_rng(5)
        n = 256
        x = np.sort(rng.uniform(0, 6, size=(n, 1)), axis=0)
        y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
        path = tmp_path / "train.ggpd"
        dataio.pack_dataset(path, x, y)

        gp = core.GP(1, rbf.scaled(), noise=uniform_noise)
        m = 24
        z0 = x[:: n // m][:m]
        with dataio.MinibatchStream(path, batch=64, seed=11, native=None) as st:
            params, trace = sparse.svgp_fit_stream(
                gp, st, n_total=n, m=m, z0=z0, iters=300, rate=0.05
            )
        assert float(trace[-1]) > float(trace[0])
        theta = jnp.exp(params.log_theta)
        mu, var = sparse.svgp_predict(
            gp, theta[: gp.n_theta_simil], params.state, jnp.asarray(x[:50])
        )
        rmse = float(jnp.sqrt(jnp.mean((mu - jnp.asarray(np.sin(x[:50, 0]))) ** 2)))
        assert rmse < 0.15
