"""The port's RVQ (and the plain version of kernel K2) vs the JAX package.

Same features (numpy seed) through JAX `quantize(method="fast")`, the JAX
Pallas RvqEncodeKernel (interpret mode) and the port's "fast", "kernel"
(K2's plain version on CPU) and "exact" methods.  Indices must be equal;
a row may differ only where the reference's top two scores are a near-tie
(< 1e-5 relative), which the test then asserts.  Decode within 1e-6.

A numpy model of the CUDA kernel's arithmetic (ops/csrc/rvq_encode.cu),
which cannot run here, is held to the same references: its lane map, the
swizzled shared-memory layout, the partial-sum order, the join of the two
halves, the argmin by ordered keys, and its launch plan.
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


# --- kernel K2's arithmetic, modelled in numpy (ops/csrc/rvq_encode.cu) ---
# Lane 2k + h owns codeword k and feature half h.  Shared memory holds each
# stage's codewords as in global memory, so row 2k + h (128 bytes, 8 chunks
# of 4 floats) is codeword k's half h.  Register slot t of a lane holds
# chunk t ^ m, m = lane & 7, of its row and of the residual's half; the 32
# products are summed per float of a chunk (i = 0..3) by a balanced tree
# over the slots, then (A0 + A1) + (A2 + A3), then the halves are joined.
LANES, CHUNKS = 32, 8


def _lane_slots(lane):
    """(code k, half h, [(slot t, float i, feature)]) of one lane."""
    k, h, m = lane >> 1, lane & 1, lane & 7
    return k, h, [(t, i, 32 * h + 4 * (t ^ m) + i) for t in range(CHUNKS)
                  for i in range(4)]


def _tree(p):
    """The kernel's sum over the slot axis (last) of 8 f32 values."""
    return (((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3]))
            + ((p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7])))


def _order_key(score):
    """The kernel's unsigned key of an f32 score, −0 taken as +0."""
    u = (score + np.float32(0.0)).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _argmin_by_keys(scores):
    """[..., 16] scores → the kernel's pick: the least key over the warp
    (__reduce_min_sync), then the lowest code holding it (__ffs of the
    ballot of the even lanes)."""
    keys = _order_key(scores)
    return np.argmax(keys == keys.min(axis=-1, keepdims=True), axis=-1)


def _kernel_model(feats, cbs, c2, run_stages):
    """The kernel's search, bit for bit, vectorised over streams and codes;
    sums in chunk order, which equals every lane's slot order
    (test_kernel_slot_order_gives_the_same_bits_in_every_lane)."""
    r = feats.astype(np.float32).reshape(-1, 1, 2, CHUNKS, 4)  # [B,1,h,c,i]
    out = []
    for s in range(run_stages):
        cw = cbs[s].astype(np.float32).reshape(1, 16, 2, CHUNKS, 4)
        a = _tree(np.moveaxis(r * cw, 3, -1))  # [B, k, h, i]
        d = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
        d = d[..., 0] + d[..., 1]  # __shfl_xor_sync(1), commutative
        score = c2[s].astype(np.float32) - np.float32(2.0) * d  # one fmaf
        idx = _argmin_by_keys(score)
        out.append(idx.astype(np.int32))
        r = r - cbs[s][idx].astype(np.float32).reshape(r.shape)
    return np.stack(out, axis=1)


def test_kernel_lanes_form_each_score_from_every_element_once():
    terms = {k: [] for k in range(16)}
    for lane in range(LANES):
        k, h, slots = _lane_slots(lane)
        assert lane == 2 * k + h
        terms[k] += [f for _, _, f in slots]
        assert sorted((t, i) for t, i, _ in slots) == \
            [(t, i) for t in range(CHUNKS) for i in range(4)]
        assert all(f % 4 == i for _, i, f in slots)
    for k in range(16):
        assert sorted(terms[k]) == list(range(64)), k


def test_kernel_slot_order_gives_the_same_bits_in_every_lane():
    """Slot t holding chunk t ^ m: the tree pairs the same chunks for every
    m, so with commutative adds every lane's sum has the chunk order's bits
    (equal codewords then tie exactly)."""
    rng = np.random.default_rng(3)
    p = (rng.normal(size=(4096, CHUNKS)) *
         10.0 ** rng.integers(-4, 4, (4096, CHUNKS))).astype(np.float32)
    want = _tree(p)
    for m in range(8):
        got = _tree(p[:, [t ^ m for t in range(CHUNKS)]])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    rotated = _tree(p[:, [(t + 1) % CHUNKS for t in range(CHUNKS)]])
    assert (rotated != want).any()  # an order the kernel must not use


def test_kernel_smem_reads_are_free_of_bank_conflicts():
    """An LDS.128 serves a quarter-warp (8 lanes) per wavefront; a 128-byte
    row's chunk c sits in bank group c."""
    for t in range(CHUNKS):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            # the dot: lane reads chunk t ^ m of its own row
            assert len({t ^ (ln & 7) for ln in lanes}) == 8
            for idx in range(16):  # the update: row 2·idx + h, chunk t ^ m
                reads = {(2 * idx + (ln & 1), t ^ (ln & 7)) for ln in lanes}
                assert len({c for _, c in reads}) == len(reads) == 8


def test_kernel_argmin_takes_the_lowest_k_on_exact_ties():
    rng = np.random.default_rng(7)
    scores = rng.normal(size=(64, 16)).astype(np.float32)
    for row in scores:
        dup = rng.choice(16, 3, replace=False)
        row[dup] = row.min() - 1.0  # three equal least scores
    np.testing.assert_array_equal(_argmin_by_keys(scores),
                                  np.argmin(scores, axis=-1))
    signed = np.array([[3.0, -0.0, 0.0, 1.0] + [5.0] * 12,
                       [3.0, 0.0, -0.0, 1.0] + [5.0] * 12,
                       [-1.0, -2.0, -2.0, 1.0] + [5.0] * 12], np.float32)
    np.testing.assert_array_equal(_argmin_by_keys(signed), [1, 1, 1])
    # equal codewords give equal scores, the first copy wins
    cbs = rng.normal(0.0, 0.5, (4, 16, 64)).astype(np.float32)
    cbs[:, 8:] = cbs[:, :8]
    idx = _kernel_model(_features(8, b=64), cbs, np.sum(cbs * cbs, -1), 4)
    assert idx.max() <= 7


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_model_matches_jax_fast_and_pallas(codebooks, seed):
    feats = _features(seed, b=64)
    c2 = ResidualVectorQuantizer(codebooks, "cpu").c2.numpy()
    got = _kernel_model(feats, codebooks, c2, 46)
    ref = np.asarray(JaxRvq(codebooks).quantize(jnp.asarray(feats), 46,
                                                method="fast"))
    pallas = np.asarray(RvqEncodeKernel(codebooks, block_streams=64,
                                        interpret=True)(jnp.asarray(feats)))
    _assert_indices_equal_or_near_tie(got, ref, feats, codebooks)
    _assert_indices_equal_or_near_tie(got, pallas, feats, codebooks)
    np.testing.assert_array_equal(_kernel_model(feats, codebooks, c2, 16),
                                  got[:, :16])


@pytest.mark.parametrize("batch", [1, 3, 777, 1024, 16384])
@pytest.mark.parametrize("sms", [132, 7])
def test_rvq_plan_covers_every_stream_once(batch, sms):
    plan = rvq_kernel.rvq_plan(batch, 46, sms)
    assert 1 <= plan.warps <= rvq_kernel.RVQ_MAX_WARPS
    assert 1 <= plan.blocks <= sms
    assert plan.smem == 46 * rvq_kernel.RVQ_STAGE_BYTES <= 232448
    seen = np.zeros(batch, np.int64)
    for g in range(plan.blocks):
        for w in range(plan.warps):
            seen[g * plan.warps + w:batch:plan.blocks * plan.warps] += 1
    assert (seen == 1).all()
    if batch >= sms * rvq_kernel.RVQ_MAX_WARPS:
        assert plan.blocks == sms  # a larger batch loops in the warps


def test_rvq_plan_at_the_main_path_batch():
    assert rvq_kernel.rvq_plan(1024, 46, 132) == (8, 128, 191728)
    assert rvq_kernel.rvq_plan(70000, 46, 132) == (16, 132, 191728)
