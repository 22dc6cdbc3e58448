"""The port's entropy models and host coders against the JAX package's:
integer-identical CDF tables, equal scale indexes, byte-identical rANS
streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import stf_tpu.ans as jans
from stf_tpu.entropy import EntropyBottleneck as JaxEntropyBottleneck
from stf_tpu.entropy import build_eb_tables as jax_build_eb_tables
from stf_tpu.entropy import build_gc_tables as jax_build_gc_tables
from stf_tpu.entropy import gaussian_build_indexes as jax_build_indexes
from stf_tpu.entropy import gaussian_likelihood as jax_gaussian_likelihood
from stf_tpu_torch import ans
from stf_tpu_torch.zoo import state_dict_from_jax
from stf_tpu_torch.entropy import (
    EntropyBottleneck,
    build_eb_tables,
    build_gc_tables,
    gaussian_build_indexes,
    gaussian_likelihood,
    get_scale_table,
)


def _assert_tables_equal(got, want):
    for a, b in zip(got.astuple(), want.astuple()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eb_tables_match_jax():
    C = 24
    params = jax.tree_util.tree_map(np.asarray, JaxEntropyBottleneck(C).init(
        jax.random.key(5), jnp.zeros((1, 4, 4, C)), training=False
    )["params"])
    # spread the quantiles so the rows have different widths and centers
    q = params["quantiles"].copy()
    rng = np.random.default_rng(0)
    q[:, 0, 0] -= rng.uniform(0, 20, C).astype(np.float32)
    q[:, 0, 1] += rng.uniform(-2, 2, C).astype(np.float32)
    params["quantiles"] = q
    port = EntropyBottleneck(C)
    port.load_state_dict({
        k.split(".", 1)[1]: v
        for k, v in state_dict_from_jax({"entropy_bottleneck": params}).items()
    })
    _assert_tables_equal(build_eb_tables(port), jax_build_eb_tables(params))


def test_gc_tables_match_jax():
    table = get_scale_table()
    _assert_tables_equal(build_gc_tables(table), jax_build_gc_tables(table))


def test_build_indexes_match_jax():
    table = get_scale_table()
    rng = np.random.default_rng(2)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(400.0), 20000))
    scales = scales.astype(np.float32)
    # keep off exact table ties, where f32 compares are fragile by design
    near = np.min(np.abs(scales[:, None] / table[None, :] - 1), axis=1)
    scales = scales[near > 1e-6]
    got = gaussian_build_indexes(torch.from_numpy(scales), torch.from_numpy(table))
    want = np.asarray(jax_build_indexes(jnp.asarray(scales), table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == table.size - 1


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(0, 3, 4000).astype(np.float32)
    s = np.exp(rng.uniform(-3, 4, 4000)).astype(np.float32)
    mu = rng.normal(0, 1, 4000).astype(np.float32)
    got = gaussian_likelihood(
        torch.from_numpy(v), torch.from_numpy(s), torch.from_numpy(mu)
    ).numpy()
    want = np.asarray(jax_gaussian_likelihood(v, s, mu))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["rans", "rangecoder"])
def test_host_streams_byte_identical(backend):
    tables = build_gc_tables(get_scale_table())
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 64, 6000).astype(np.int32)
    sym = np.rint(rng.normal(0, get_scale_table()[idx])).astype(np.int32)
    sym[:20] = 100000  # bypass-coded outliers
    args = (sym, idx, *tables.astuple())
    enc, _, dec = ans.host_coder_classes(backend)
    jenc, _, _ = jans.host_coder_classes(backend)
    a, b = enc(), jenc()
    for part in (slice(0, 2500), slice(2500, None)):  # buffered across calls
        a.encode_with_indexes(sym[part], idx[part], *tables.astuple())
        b.encode_with_indexes(sym[part], idx[part], *tables.astuple())
    stream = a.flush()
    assert stream == b.flush()
    np.testing.assert_array_equal(
        dec().decode_with_indexes(stream, *args[1:]), sym
    )
