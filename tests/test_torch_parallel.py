"""Graph-parallel plumbing: the port's plan, halo exchange and distributed SpMM
against the JAX package's, on gloo ranks.

JAX runs its ``shard_map`` program on the 8-device CPU mesh of
``tests/conftest.py``; the port runs one process per rank. One group of 8
gloo ranks, started once for the file, serves every SpMM case: a mesh of 2
or 4 is its first ranks (``make_mesh`` makes the subgroup), the others sit
the job out. The jobs live in ``tests/torch_dist_ranks.py``, which imports
no JAX. Plans and stacked ELL arrays must equal JAX's bit for bit; the SpMM,
its parts and its gradient agree with JAX's (and the dense product) within
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch_dist_ranks as ranks_mod

from pygcn_tpu.graph import Graph as JGraph
from pygcn_tpu.graph import sym_normalize, symmetrize_max
from pygcn_tpu.ops.ell import build_ell_stacked as j_build_ell_stacked
from pygcn_tpu.parallel import build_dist_plan as j_build_dist_plan
from pygcn_tpu.parallel import make_dist_spmm as j_make_dist_spmm
from pygcn_tpu.parallel import make_mesh as j_make_mesh
from pygcn_tpu.parallel.dist_spmm import shard_features as j_shard_features

from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.ops.ell import build_ell_stacked, ell_apply_arrays
from pygcn_tpu_torch.parallel import build_dist_plan, make_dist_spmm, make_mesh
from pygcn_tpu_torch.parallel.dist_spmm import pad_node_features, shard_features
from pygcn_tpu_torch.parallel.launcher import LocalRanks, initialize_multihost
from pygcn_tpu_torch.parallel.mesh import require_devices

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_FIELDS = ("loc_s", "loc_r", "loc_w", "rem_h", "rem_r", "rem_w", "send_idx")
JOB_TIMEOUT_S = 120


def make_case(n=500, e=4000, seed=0):
    """``tests/test_parallel.py``'s graph in both packages, and its dense matrix."""
    rng = np.random.default_rng(seed)
    m = sp.coo_matrix(
        (rng.uniform(0.1, 1.0, e), (rng.integers(0, n, e), rng.integers(0, n, e))),
        shape=(n, n))
    a = sym_normalize(symmetrize_max(m))
    kw = dict(is_symmetric=True, build_dense=False, build_bcsr=False)
    return JGraph.from_scipy(a, **kw), TGraph.from_scipy(a, **kw), a.toarray()


_CASE = {}


def case():
    if not _CASE:
        _CASE["graphs"] = make_case()
    return _CASE["graphs"]


@pytest.fixture(scope="module")
def ranks8():
    with LocalRanks(8, timeout_s=JOB_TIMEOUT_S) as ranks:
        yield ranks


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def test_build_ell_stacked_matches_jax():
    rng = np.random.default_rng(3)
    mats = []
    for p in range(3):  # uneven degrees, one row past the largest bucket, one empty shard
        density = 0.0 if p == 2 else 0.02 * (p + 1)
        m = sp.random(120, 300, density=density, random_state=rng, format="lil",
                      dtype=np.float32)
        if p == 0:
            m[5, :] = rng.uniform(0.1, 1.0, 300)
        mats.append(m.tocsr())
    got, want = build_ell_stacked(mats), j_build_ell_stacked(mats)
    assert got[3] == want[3] == 120
    for kind, g, w in zip(("cols", "vals", "rows"), got[:3], want[:3]):
        assert len(g) == len(w)
        for j, (gb, wb) in enumerate(zip(g, w)):
            _same_bits(gb, wb, f"{kind} bucket {j}")
    # one shard's flat arrays apply as its matrix
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = ell_apply_arrays(*(tuple(torch.from_numpy(b[0]) for b in arrays) for arrays in got[:3]),
                         120, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), mats[0] @ x, **TOL)


@pytest.mark.parametrize("build_ell", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_plan_matches_jax(n_shards, build_ell):
    jg, tg, _ = case()
    got = build_dist_plan(tg, n_shards, build_ell=build_ell)
    want = j_build_dist_plan(jg, n_shards, build_ell=build_ell)
    for f in ("n_shards", "shard_size", "halo", "n_nodes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in PLAN_FIELDS:
        _same_bits(getattr(got, f), getattr(want, f), f)
    if build_ell:
        for layout in ("loc_ell", "rem_ell"):
            for kind, g, w in zip(("cols", "vals", "rows"), getattr(got, layout),
                                  getattr(want, layout)):
                for j, (gb, wb) in enumerate(zip(g, w)):
                    _same_bits(gb, wb, f"{layout} {kind} bucket {j}")
    else:
        assert got.loc_ell is None and got.rem_ell is None
    # the boundary rows, counted: what each shard's remote edges reference
    for i in range(n_shards):
        used = np.unique(got.rem_h[i][got.rem_w[i] != 0])
        assert used.size == got.halo_counts[i].sum()
    assert np.all(np.diag(got.halo_counts) == 0)


def test_plan_halo_only_boundary_nodes():
    """The halo ships each needed boundary row once, not once per edge
    (JAX's ``test_plan_halo_only_boundary_nodes``)."""
    jg, tg, _ = make_case(n=400, e=6000)
    plan = build_dist_plan(tg, 4)
    assert int(plan.send_idx.max()) < plan.shard_size
    assert int(plan.rem_h.max()) < 4 * plan.halo
    assert plan.halo <= plan.shard_size + 8
    remote_edges = int((plan.rem_w != 0).sum())
    assert plan.halo_rows < remote_edges
    # one shard: the whole graph is local and no row crosses
    one = build_dist_plan(tg, 1)
    assert one.halo_rows == 0 and not one.rem_w.any()


_JAX = {}


def jax_spmm(n_shards, build_ell, x, ct):
    """JAX's distributed SpMM of ``x`` and the gradient of ``<ct, A x>``."""
    key = (n_shards, build_ell)
    if key not in _JAX:
        jg, _, _ = case()
        mesh = j_make_mesh([n_shards], ["graph"])
        plan = j_build_dist_plan(jg, n_shards, build_ell=build_ell)
        f = j_make_dist_spmm(mesh, plan)
        xp = j_shard_features(jnp.asarray(x), mesh)
        y = jax.jit(f)(xp)
        dx = jax.jit(jax.grad(lambda v: jnp.vdot(jnp.asarray(ct), f(v))))(xp)
        _JAX[key] = np.asarray(y), np.asarray(dx)
    return _JAX[key]


@pytest.mark.parametrize("build_ell", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_dist_spmm_matches_jax(ranks8, n_shards, build_ell):
    """Values, the padded rows, ``local`` + ``halo`` == ``full``, and the
    gradient (JAX's ``test_dist_spmm_gradient``: the reverse exchange)."""
    _, tg, a = case()
    plan = build_dist_plan(tg, n_shards, build_ell=build_ell)
    rng = np.random.default_rng(1)
    x = pad_node_features(rng.normal(size=(tg.n_nodes, 16)).astype(np.float32), plan).numpy()
    ct = rng.normal(size=x.shape).astype(np.float32)
    ct[tg.n_nodes:] = 0
    out = ranks8.run(ranks_mod.spmm_job, plan, x, ct)
    assert all(r is None for r in out[n_shards:])
    y, y_local, y_halo, grad = (np.concatenate([r[k] for r in out[:n_shards]])
                                for k in ("full", "local", "halo", "grad"))
    want_y, want_grad = jax_spmm(n_shards, build_ell, x, ct)
    np.testing.assert_allclose(y, want_y, **TOL)
    np.testing.assert_allclose(y[: tg.n_nodes], a @ x[: tg.n_nodes], **TOL)
    assert not y[tg.n_nodes:].any()
    np.testing.assert_allclose(y_local + y_halo, y, **TOL)
    np.testing.assert_allclose(grad, want_grad, **TOL)
    np.testing.assert_allclose(grad[: tg.n_nodes], a.T @ ct[: tg.n_nodes], **TOL)


def test_dist_spmm_one_rank_without_a_group():
    """A mesh of one rank needs no process group: the exchange is a copy of
    an empty halo, and the value and gradient are the dense product's."""
    _, tg, a = case()
    plan = build_dist_plan(tg, 1)
    mesh = make_mesh([1])
    assert mesh.rank == 0 and mesh.coords == (0,) and mesh.device == torch.device("cpu")
    x = np.random.default_rng(2).normal(size=(tg.n_nodes, 8)).astype(np.float32)
    xs = shard_features(pad_node_features(x, plan), mesh).requires_grad_()
    y = make_dist_spmm(mesh, plan)(xs)
    np.testing.assert_allclose(y.detach().numpy()[: tg.n_nodes], a @ x, **TOL)
    y[: tg.n_nodes].sum().backward()
    np.testing.assert_allclose(xs.grad.numpy()[: tg.n_nodes], a.T @ np.ones_like(x), **TOL)


def test_dist_spmm_refuses_bogus_parts_and_a_mismatched_plan():
    _, tg, _ = case()
    mesh = make_mesh([1])
    with pytest.raises(ValueError, match="unknown parts"):
        make_dist_spmm(mesh, build_dist_plan(tg, 1), parts="bogus")
    with pytest.raises(ValueError, match="plan of 2 shards"):
        make_dist_spmm(mesh, build_dist_plan(tg, 2))


def test_mesh_refuses_more_devices_than_ranks():
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        make_mesh([2], ["graph"])
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        make_mesh([2, 2], ["graph", "data"])
    with pytest.raises(ValueError, match="mesh needs 3 devices, have 0"):
        require_devices(3, 0)
    require_devices(2, 2)


def test_initialize_multihost_without_a_launcher_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    info = initialize_multihost()
    assert (info.process_index, info.process_count, info.distributed) == (0, 1, False)
    assert not torch.distributed.is_initialized()


def test_local_ranks_report_a_failing_rank_and_a_hang():
    """A rank that raises fails the call with its traceback; a job that
    outlasts its limit (rank 0 waits in a barrier rank 1 never reaches)
    fails it with ``TimeoutError``; either closes the group, whose
    processes are gone."""
    with LocalRanks(2, timeout_s=JOB_TIMEOUT_S) as ranks:
        assert len(set(ranks.run(ranks_mod.pid_job))) == 2
        with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*ZeroDivisionError"):
            ranks.run(ranks_mod.fail_on_rank_1)
        assert ranks._procs is None
    with LocalRanks(2, timeout_s=JOB_TIMEOUT_S) as ranks:
        procs = list(ranks._procs)
        with pytest.raises(TimeoutError, match=r"ranks \[0\] gave no result"):
            ranks.run(ranks_mod.hang_on_rank_0, timeout_s=5)
        assert not any(p.is_alive() for p in procs)
