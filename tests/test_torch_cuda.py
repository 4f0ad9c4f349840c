"""Kernel B1 on a CUDA card against its plain version (skipped without a card).

Run on a machine with an H100 from the repo root (``--noconftest`` because
``tests/conftest.py`` configures JAX, which that machine does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import Graph, _build_bcsr
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_kernel_matches_plain(dev, dtype, h):
    rng = np.random.default_rng(h)
    m = sp.random(300, 270, density=0.05, random_state=rng, format="coo",
                  data_rvs=rng.standard_normal, dtype=np.float32)
    keep = m.row // 128 != 1  # an empty block row
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    b = dataclasses.replace(b, data=b.data.to(dtype)).to(dev)
    x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
    before = b1.launches
    got = b1.bcsr_spmm(b, x, n_rows=300)
    torch.cuda.synchronize()
    assert b1.launches == before + 1
    torch.testing.assert_close(got, b1.bcsr_spmm_plain(b, x, n_rows=300), rtol=1e-4, atol=1e-4)
    assert not got[128:256].any()


def test_b1_gradient_on_asymmetric_graph(dev):
    from pygcn_tpu_torch.ops.spmm import spmm

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 300, 3000), rng.integers(0, 300, 3000)
    g = Graph.from_coo(src, dst, rng.standard_normal(3000).astype(np.float32), n_nodes=300,
                       build_dense=False, build_bcsr=True, build_ell=False,
                       build_hybrid=False).to(dev)
    x = torch.randn(300, 40, device=dev, requires_grad=True)
    cot = torch.randn(300, 40, device=dev)
    (dx,) = torch.autograd.grad(spmm(g, x, impl="bcsr"), x, cot)
    torch.testing.assert_close(dx, b1.bcsr_spmm_plain(g.bcsr_t, cot, n_rows=300),
                               rtol=1e-4, atol=1e-4)
