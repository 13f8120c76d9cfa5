"""The XLA scans against plain NumPy references: the int8 and int4 scans
in both modes, the packed Hamming scan, and the grouped (cell-major) IVF
and IVF-PQ cell scores.  Dims include ones that fill no whole word or
vector register, so padding is exercised."""

import jax.numpy as jnp
import numpy as np
import pytest

from fastpyvectordb_jax.core.types import DistanceMetric
from fastpyvectordb_jax.quant.binary import BinaryQuantizer, _hamming
from fastpyvectordb_jax.quant.int4 import Int4Quantizer
from fastpyvectordb_jax.quant.scalar import ScalarQuantizer


def _np_scores(q, v, metric):
    """float64 metric scores, lower = closer (L2 squared, as the scans)."""
    q = q.astype(np.float64)
    v = v.astype(np.float64)
    if metric == DistanceMetric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        return 1.0 - qn @ vn.T
    if metric == DistanceMetric.L2:
        return ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    return -(q @ v.T)


def _data(d, n=257, b=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("d", [40, 70])
@pytest.mark.parametrize("mode", ["int8mm", "chunked"])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_int8_scan_matches_numpy(metric, mode, d):
    """Both int8 scan modes score the DEQUANTIZED corpus: against the
    float64 metric over ``decode(codes)`` the chunked mode is exact to
    float32 and the folded matmul to its int8 query quantization."""
    v, q = _data(d)
    sq = ScalarQuantizer().train(v)
    codes = sq.encode(v)
    want = _np_scores(q, sq.decode(codes), metric)
    got = np.asarray(sq.distances(q, codes, metric, mode=mode))
    assert got.shape == (q.shape[0], v.shape[0])
    scale = max(np.abs(want).max(), 1.0)
    tol = (2e-2 if mode == "int8mm" else 1e-4) * scale
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("d", [41, 64])
@pytest.mark.parametrize("mode", ["int4mm", "chunked"])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_int4_scan_matches_numpy(metric, mode, d):
    """Same contract for the packed 4-bit codec, odd dims included (one
    phantom pad dim that must contribute nothing)."""
    v, q = _data(d, seed=1)
    qz = Int4Quantizer().train(v)
    codes = qz.encode(v)
    want = _np_scores(q, qz.decode(codes), metric)
    got = np.asarray(qz.distances(q, codes, metric, mode=mode))
    assert got.shape == (q.shape[0], v.shape[0])
    scale = max(np.abs(want).max(), 1.0)
    tol = (2e-2 if mode == "int4mm" else 1e-4) * scale
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("d", [32, 40, 70, 96])
def test_hamming_scan_matches_numpy(d):
    """Packed XOR + popcount equals the bitwise count of differing signs
    against the trained thresholds, for whole and partial words."""
    v, q = _data(d, seed=2)
    bq = BinaryQuantizer().train(v)
    thr = np.asarray(bq.thresholds)
    want = ((q[:, None, :] > thr) != (v[None, :, :] > thr)).sum(-1)
    got = np.asarray(bq.hamming_distances(q, bq.encode(v)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(_hamming(bq.encode(q), bq.encode(v), chunk=64)), want)


def _grouped_setup(d, int8_cells, seed=3):
    """A small IVF cell table: every probed slot's true row is known."""
    rng = np.random.default_rng(seed)
    nlist, cmax, b = 6, 16, 5
    vecs = rng.standard_normal((nlist * cmax, d)).astype(np.float32)
    table = np.arange(nlist * cmax, dtype=np.int32).reshape(nlist, cmax)
    table[:, -3:] = -1                      # padding slots
    cells = vecs.reshape(nlist, cmax, d)
    sq = None
    if int8_cells:
        sq = ScalarQuantizer().train(vecs)
        codes = np.asarray(sq.encode(vecs))
        deq = sq.decode(codes)
        cells = codes.reshape(nlist, cmax, d)
        norms = (deq.astype(np.float64) ** 2).sum(-1).reshape(nlist, cmax)
        vecs_eff = deq
    else:
        norms = (vecs.astype(np.float64) ** 2).sum(-1).reshape(nlist, cmax)
        vecs_eff = vecs
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q, cells, table, norms, vecs_eff, sq


@pytest.mark.parametrize("int8_cells", [False, True])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_grouped_cell_scores_match_brute_force(metric, int8_cells):
    """grouped_cell_candidates' batched cell matmul scores every probed
    live slot as the brute-force metric over that slot's row (L2 in the
    squared domain); padding slots come back masked."""
    from fastpyvectordb_jax.ann.ivf_grouped import grouped_cell_candidates
    from fastpyvectordb_jax.kernels.distances import MASKED
    d = 40
    q, cells, table, norms, vecs_eff, sq = _grouped_setup(d, int8_cells)
    nlist, cmax = table.shape
    nprobe = 3
    rng = np.random.default_rng(4)
    croute = rng.standard_normal((q.shape[0], nlist)).astype(np.float32)
    vmin = sq.vmin if sq else jnp.zeros((d,), jnp.float32)
    scale = sq.scale if sq else jnp.ones((d,), jnp.float32)
    vals, rows, dropped = grouped_cell_candidates(
        jnp.asarray(q), jnp.asarray(croute), jnp.asarray(cells),
        jnp.asarray(table), jnp.asarray(table >= 0), vmin, scale,
        jnp.asarray(norms, jnp.float32), metric=metric, nprobe=nprobe,
        qcap=8, compute_dtype="float32")
    vals, rows = np.asarray(vals), np.asarray(rows)
    assert int(dropped) == 0
    probe = np.argsort(croute, axis=1)[:, :nprobe]   # lowest = nearest
    ref = _np_scores(q, vecs_eff, metric)
    tol = (2e-2 if int8_cells else 1e-4) * max(np.abs(ref).max(), 1.0)
    for i in range(q.shape[0]):
        assert set(rows[i][rows[i] >= 0]) == set(
            table[probe[i]].ravel()[table[probe[i]].ravel() >= 0])
        live = rows[i] >= 0
        assert (vals[i][~live] >= MASKED * 0.5).all()
        np.testing.assert_allclose(vals[i][live], ref[i, rows[i][live]],
                                   atol=tol)


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE, DistanceMetric.L2,
                                    DistanceMetric.DOT])
def test_grouped_pq_scores_match_adc_formula(metric):
    """_grouped_pq_candidates scores each probed slot by the ADC
    definition: q . (centroid + sum_m codebook[m, code_m]) with the
    precomputed reconstruction norm (L2 in the squared domain)."""
    from fastpyvectordb_jax.ann.ivfpq import _grouped_pq_candidates
    rng = np.random.default_rng(6)
    nlist, cmax, m, kk, d, b, nprobe = 5, 8, 4, 16, 16, 6, 2
    ds = d // m
    codes_t = rng.integers(0, kk, (nlist, m, cmax)).astype(np.uint8)
    codebooks = rng.standard_normal((m, kk, ds)).astype(np.float32)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    table = np.arange(nlist * cmax, dtype=np.int32).reshape(nlist, cmax)
    q = rng.standard_normal((b, d)).astype(np.float32)
    # reconstructions and their norms
    recon = np.zeros((nlist, cmax, d), np.float64)
    for c in range(nlist):
        for s in range(cmax):
            recon[c, s] = cents[c] + np.concatenate(
                [codebooks[mi, codes_t[c, mi, s]] for mi in range(m)])
    norms = (recon ** 2).sum(-1).astype(np.float32)
    qc = q @ cents.T
    probe = np.argsort(-qc, axis=1)[:, :nprobe].astype(np.int32)
    vals, rows, dropped = _grouped_pq_candidates(
        jnp.asarray(q), jnp.asarray(qc), jnp.asarray(probe),
        jnp.asarray(codes_t), jnp.asarray(codebooks), jnp.asarray(norms),
        jnp.asarray(table), jnp.asarray(np.ones_like(table, bool)),
        metric=metric, qcap=8)
    vals, rows = np.asarray(vals), np.asarray(rows)
    assert int(dropped) == 0
    flat = recon.reshape(-1, d)
    cross = q.astype(np.float64) @ flat.T
    if metric == DistanceMetric.COSINE:
        ref = 1.0 - cross / (np.linalg.norm(q, axis=1)[:, None]
                             * np.sqrt(norms.reshape(-1))[None, :])
    elif metric == DistanceMetric.L2:
        ref = (q.astype(np.float64) ** 2).sum(1)[:, None] \
            + norms.reshape(-1)[None, :] - 2.0 * cross
    else:
        ref = -cross
    # the ADC table is summed in bf16 (one-hot matmul)
    tol = 3e-2 * max(np.abs(ref).max(), 1.0)
    for i in range(b):
        np.testing.assert_allclose(vals[i], ref[i, rows[i]], atol=tol)
        assert set(rows[i]) == set(table[probe[i]].ravel())
