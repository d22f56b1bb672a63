"""``final_select="approx"`` in the port (knn_tpu_torch.ops.coarse_knn.
local_select_rescore) against the JAX package (knn_tpu.ops.pallas_knn,
interpret mode on CPU; knn_tpu.parallel.sharded) and the float64 oracle.

The reference's approx branch selects m+1 candidates with ApproxTopK and
restores the exclusion value as the masked min of the rest; with an exact
top-(m+1) that min is the exact branch's exclusion value, so the port runs
its exact select (ROADMAP divergence 19) and its certificate, and its
answer, are the exact branch's.  On the
CPU the reference's approx_max_k is exact too, so the candidate sets agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import _data

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (24, 16384)])
def test_approx_local_certified_candidates_match_pallas(dim, tile_n):
    rng = np.random.default_rng(dim + 7)
    q, db = _data(rng, 9, 7 * 128 + 33, dim)
    db[100:120] = db[:20]  # duplicate rows: exact ties in the candidates
    m = 21
    jd, ji, jlb = jpk.local_certified_candidates(
        jnp.asarray(q), jnp.asarray(db), m, tile_n=tile_n, block_q=8,
        precision="bf16x3", interpret=True, final_select="approx",
        final_recall_target=0.99)
    jd, ji, jlb = np.asarray(jd), np.asarray(ji), np.asarray(jlb)
    pd, pi, plb = (a.numpy() for a in ck.local_certified_candidates(
        torch.from_numpy(q), torch.from_numpy(db), m, tile_n=tile_n,
        final_select="approx", final_recall_target=0.99))
    np.testing.assert_allclose(pd, jd, rtol=ck.RANK_SLACK)
    gap_ok = np.ones_like(pd, dtype=bool)
    close = np.abs(np.diff(jd, axis=1)) <= 2 * ck.RANK_SLACK * jd[:, 1:]
    gap_ok[:, 1:] &= ~close
    gap_ok[:, :-1] &= ~close
    np.testing.assert_array_equal(pi[gap_ok], ji[gap_ok])
    assert (np.abs(plb - jlb) <= ck.kernel_tolerance(q, db)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_approx_select_is_the_exact_branch_on_the_same_candidates(seed):
    # the stand-in: top-(m+1) in stable order, the exclusion value the
    # masked min of the rest -- the exact branch's indices and bound
    rng = np.random.default_rng(seed)
    q, db = _data(rng, 6, 600, 16)
    qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
    cd, ci, bounds = ck.local_coarse_candidates(qt, dbt, 30, tile_n=256)
    cd[:, 7] = cd[:, 3]                       # a tie inside the selection
    exact = ck.local_select_rescore(qt, dbt, cd, ci, bounds, 30)
    approx = ck.local_select_rescore(qt, dbt, cd, ci, bounds, 30,
                                     final_select="approx",
                                     final_recall_target=0.5)
    for a, b in zip(exact, approx):
        assert torch.equal(a, b)


def _blobs(seed, n=1500, dim=24):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(20, dim)) * 8
    db = (c[rng.integers(0, 20, n)] + rng.normal(size=(n, dim))).astype(
        np.float32)
    db[50:60] = db[:10]
    q = (c[rng.integers(0, 20, 11)] + rng.normal(size=(11, dim))).astype(
        np.float32)
    return db, q


@pytest.mark.parametrize("knobs", [
    {}, {"kernel": "streaming"}, {"precision": "int8"},
    {"survivors": 4}, {"final_recall_target": 0.9}],
    ids=["tiled", "streaming", "int8", "s4", "recall0.9"])
def test_approx_search_certified_matches_jax_and_oracle(knobs):
    db, q = _blobs(3)
    k = 7
    pd, pi, st = ShardedKNN(db, k=k, device="cpu").search_certified(
        q, tile_n=512, final_select="approx", **knobs)
    jd, ji, _ = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=k).search_certified(
        q, selector="pallas", tile_n=512, block_q=8, final_select="approx",
        **knobs)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    d = oracles.sq_l2(q, db)
    ref = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    np.testing.assert_array_equal(pi, ref)
    np.testing.assert_allclose(pd, np.asarray(jd), rtol=2 * ck.RANK_SLACK)
    assert st["pallas_knobs"]["final_select"] == "approx"
    assert st["pallas_knobs"]["final_recall_target"] == \
        knobs.get("final_recall_target")


def test_fused_with_approx_stays_refused():
    db, q = _blobs(4)
    with pytest.raises(ValueError, match="final_select='exact'"):
        ShardedKNN(db, k=5, device="cpu").search_certified(
            q, kernel="fused", final_select="approx")
    with pytest.raises(ValueError, match="final_select='exact'"):
        ck.check_knobs(kernel="fused", final_select="approx")
    with pytest.raises(ValueError, match="final_select"):
        ck.check_knobs(final_select="nearest")
