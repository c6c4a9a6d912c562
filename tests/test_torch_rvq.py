"""The port's RVQ (and the plain version of kernel K2) vs the JAX package.

Same features (numpy seed) through JAX `quantize(method="fast")`, the JAX
Pallas RvqEncodeKernel (interpret mode) and the port's "fast", "kernel"
(K2's plain version on CPU) and "exact" methods.  Indices must be equal;
a row may differ only where the reference's top two scores are a near-tie
(< 1e-5 relative), which the test then asserts.  Decode within 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyra_tpu.models.rvq import ResidualVectorQuantizer as JaxRvq
from lyra_tpu.models.rvq import extract_codebooks as jax_extract_codebooks
from lyra_tpu.ops.rvq_kernel import RvqEncodeKernel
from lyra_tpu_torch.models.rvq import ResidualVectorQuantizer, extract_codebooks
from lyra_tpu_torch.ops import rvq_kernel

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
QUANT = os.path.join(SMALL, "quantizer.tflite")


@pytest.fixture(scope="module")
def codebooks():
    return extract_codebooks(QUANT)


def _features(seed, b=8):
    return np.random.default_rng(seed).normal(0.0, 1.0, (b, 64)).astype(
        np.float32)


def _assert_indices_equal_or_near_tie(got, ref, feats, cbs):
    """Equal indices, or the first differing stage is a near-tie of the
    reference's scores (then later stages legitimately diverge)."""
    for b in np.flatnonzero((got != ref).any(axis=1)):
        s = int(np.flatnonzero(got[b] != ref[b])[0])
        r = feats[b].astype(np.float64)
        for j in range(s):
            r = r - cbs[j, ref[b, j]]
        scores = np.sum(cbs[s] ** 2, -1) - 2.0 * cbs[s] @ r
        top = np.sort(scores)[:2]
        assert abs(top[1] - top[0]) < 1e-5 * max(abs(top[0]), 1.0), (b, s)


def test_codebooks_match_jax(codebooks):
    np.testing.assert_array_equal(codebooks, jax_extract_codebooks(QUANT))
    assert codebooks.shape == (46, 16, 64)


@pytest.mark.parametrize("method", ["fast", "kernel", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_matches_jax_fast_and_pallas(codebooks, method, seed):
    feats = _features(seed)
    jrvq = JaxRvq(codebooks)
    ref = np.asarray(jrvq.quantize(jnp.asarray(feats), 46, method="fast"))
    pallas = np.asarray(RvqEncodeKernel(codebooks, block_streams=8,
                                        interpret=True)(jnp.asarray(feats)))
    got = ResidualVectorQuantizer(codebooks, "cpu").quantize(
        torch.from_numpy(feats), 46, method=method).numpy()
    assert got.dtype == np.int32 and got.shape == (8, 46)
    _assert_indices_equal_or_near_tie(got, ref, feats, codebooks)
    _assert_indices_equal_or_near_tie(got, pallas, feats, codebooks)


def test_quantize_masks_bitrate_and_caps_stages(codebooks):
    feats = torch.from_numpy(_features(2, b=3))
    rvq = ResidualVectorQuantizer(codebooks, "cpu")
    jrvq = JaxRvq(codebooks)
    nq = np.array([16, 30, 46], np.int32)
    idx = rvq.quantize(feats, torch.from_numpy(nq)).numpy()
    ref = np.asarray(jrvq.quantize(jnp.asarray(feats.numpy()), nq,
                                   method="fast"))
    np.testing.assert_array_equal(idx, ref)
    for b, n in enumerate(nq):
        assert (idx[b, :n] >= 0).all() and (idx[b, n:] == -1).all()
    capped = rvq.quantize(feats, 16, max_stages=16).numpy()
    np.testing.assert_array_equal(capped[:, :16], idx[:, :16])
    assert (capped[:, 16:] == -1).all()
    ref_capped = np.asarray(jrvq.quantize(jnp.asarray(feats.numpy()), 16,
                                          method="fast", max_stages=16))
    np.testing.assert_array_equal(capped, ref_capped)


def test_kernel_plain_version_is_the_fast_search(codebooks):
    feats = torch.from_numpy(_features(4))
    rvq = ResidualVectorQuantizer(codebooks, "cpu")
    before = rvq_kernel.RVQ.launches
    a = rvq_kernel.rvq_encode(feats, rvq.codebooks, rvq.c2, 20)
    b = rvq_kernel.rvq_encode_plain(feats, rvq.codebooks, rvq.c2, 20)
    assert a.shape == (8, 20) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert rvq_kernel.RVQ.launches == before  # no launch on CPU
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode(feats, rvq.codebooks, rvq.c2, 47)


@pytest.mark.parametrize("max_stages", [None, 16])
def test_decode_matches_jax(codebooks, max_stages):
    rng = np.random.default_rng(6)
    idx = rng.integers(-1, 16, (8, 46)).astype(np.int32)
    idx[:, 30:] = -1
    ref = np.asarray(JaxRvq(codebooks).decode(jnp.asarray(idx),
                                              max_stages=max_stages))
    got = ResidualVectorQuantizer(codebooks, "cpu").decode(
        torch.from_numpy(idx), max_stages=max_stages).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
