"""Shared inputs and checks of the tier-on-a-mesh tests
(``tests/test_torch_tiers_mesh*.py``): each tier with ``mesh=`` against
the JAX package's tier on a mesh of the same shape over its 8 virtual
CPU devices, the port's (1, 1) placement and the float64 oracle
(``tests/oracles.py``).  The port's meshes are logical:
``make_mesh(q, d, devices=["cpu"] * q*d)``.

Tolerances.  Certified outputs: indices bitwise, float64 distances
bitwise the JAX package's and within 1e-12 relative of the oracle's (its
sums run in another order).  Exact ``search``-family
outputs: indices equal wherever the oracle's k-th and (k+1)-th distances
are separated by more than twice the f32 tolerance ``64 eps_f32 (||q||^2 +
max ||t||^2)``; distances within ``rtol=1e-5, atol=1e-4``.  A mesh tier
against the same tier on the (1, 1) placement: certified indices
bitwise.  Against the port's own programs (the looped mesh search of the
same padded block, the eager mesh program behind a served batch) results
are bitwise.  The tests are split by tier so that pytest-xdist's
``--dist loadfile`` spreads them over its workers.
"""

import numpy as np

from knn_tpu.parallel.mesh import make_host_mesh as jax_host_mesh
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu_torch.parallel import mesh as pmesh

import oracles

SHAPES = [(2, 4), (4, 2), (8, 1)]
EPS32 = float(np.finfo(np.float32).eps)
DIM = 16
K = 5


def port_mesh(shape):
    cpus = ["cpu"] * int(np.prod(shape))
    if len(shape) == 2:
        return pmesh.make_mesh(*shape, devices=cpus)
    return pmesh.make_host_mesh(*shape, devices=cpus)


def jax_mesh_of(shape):
    return jax_mesh(*shape) if len(shape) == 2 else jax_host_mesh(*shape)


def one_device():
    return pmesh.make_mesh(1, 1, devices=["cpu"])


def _tol(q, db):
    q64, t64 = q.astype(np.float64), db.astype(np.float64)
    return 64 * EPS32 * ((q64 ** 2).sum(-1)[:, None]
                         + (t64 ** 2).sum(-1).max())


def assert_exact(d, i, ref_d, ref_i, q, rows, k):
    """Exact-search parity: indices where the oracle separates rank k
    from k+1, distances within rtol 1e-5, atol 1e-4."""
    d, i = np.asarray(d), np.asarray(i)
    od = np.sort(oracles.sq_l2(q, rows), axis=-1)[:, : k + 1]
    sep = (np.diff(od, axis=-1) > 2 * _tol(q, rows)).all(-1)
    assert sep.mean() > 0.7
    np.testing.assert_array_equal(i[sep], np.asarray(ref_i)[sep])
    np.testing.assert_allclose(d, np.asarray(ref_d), rtol=1e-5, atol=1e-4)


def assert_oracle_d(d, od):
    np.testing.assert_allclose(d, od, rtol=1e-12, atol=0)


def oracle_ids(rows, ids, q, k=K):
    """The float64 oracle over ``rows`` (external ``ids``): ``(d, ids)``,
    ties to the lower position."""
    d = oracles.sq_l2(q, rows)
    pos = np.broadcast_to(np.arange(rows.shape[0]), d.shape)
    o = np.lexsort((pos, d), axis=-1)[:, :k]
    return np.take_along_axis(d, o, -1), ids[o]


# -- MutableIndex ---------------------------------------------------------------
def mutable_data():
    rng = np.random.default_rng(7)
    db = rng.normal(size=(600, DIM)).astype(np.float32) * 20
    q = rng.normal(size=(9, DIM)).astype(np.float32) * 20
    new = rng.normal(size=(6, DIM)).astype(np.float32) * 20
    return db, q, new


def mutate(idx, new):
    """test_index.py:60-75's scenario: two inserts, three deletes."""
    idx.insert(new[:4], np.arange(9000, 9004))
    idx.insert(new[4:], np.arange(9004, 9006))
    idx.delete([3, 250, 599])
    return idx


def survivors(db, new):
    surv = np.ones(db.shape[0], bool)
    surv[[3, 250, 599]] = False
    return (np.concatenate([db[surv], new]),
            np.concatenate([np.arange(db.shape[0])[surv],
                            np.arange(9000, 9006)]))


def clustered(seed=1, n=480, dim=DIM, centres=12):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, dim)) * 40
    rows = c[rng.integers(0, centres, n)] + rng.normal(size=(n, dim))
    q = c[rng.integers(0, centres, 24)] + rng.normal(size=(24, dim))
    return rows.astype(np.float32), q.astype(np.float32)



IVF_KW = dict(k=K, ncentroids=12, nprobe=3, train_iters=2, seed=0)


def join_data(seed=9, n=400, n_a=70):
    rng = np.random.default_rng(seed)
    db = (rng.random((n, DIM)) * 10).astype(np.float32)
    qa = (rng.random((n_a, DIM)) * 10).astype(np.float32)
    return db, qa

