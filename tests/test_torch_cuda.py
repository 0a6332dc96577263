"""The port's CUDA kernels on the card: each against its plain version at
small and ragged shapes (M, N and K not multiples of the tiles), and the
wrappers' refusals — a CUDA tensor reaching a wrapper launches the kernel or
raises, it never falls back to the plain version.

Needs a card and nvcc; skips elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels import nm_spmm as nms  # noqa: E402
from repro_torch.models.sparse_serving import (sparse_apply,  # noqa: E402
                                               to_sparse_weight)

pytestmark = pytest.mark.cuda

# bf16 inputs, exact products, f32 sums in another order, one final rounding:
# at most one bf16 ulp of the largest output, 2**-7 of its magnitude
TOL_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _sparse(N, K, weight_pattern, outlier_pattern, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn((N, K), generator=g, device=device)
         / math.sqrt(K)).to(torch.bfloat16)
    cfg = SparsifyConfig(weight_pattern=weight_pattern,
                         outlier_pattern=outlier_pattern)
    return to_sparse_weight(w, cfg), g


def _close(y, y_plain):
    err = float((y.float() - y_plain.float()).abs().max())
    assert err <= TOL_REL * float(y_plain.float().abs().max()), err


@pytest.mark.parametrize("weight_pattern", ["8:16", "4:8", "2:4"])
@pytest.mark.parametrize("N,K", [(96, 128), (200, 512), (64, 768)])
@pytest.mark.parametrize("M", [1, 3, 17, 64, 130])
def test_nm_spmm_matches_plain(cuda, M, N, K, weight_pattern):
    sw, g = _sparse(N, K, weight_pattern, None, M, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = nms.launches
    y = nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m)
    assert nms.launches == before + 1
    torch.cuda.synchronize()
    _close(y, nms.plain(x, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m))


@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("N,K", [(96, 256), (200, 768)])
@pytest.mark.parametrize("M", [1, 5, 37, 130])
def test_fused_matches_plain(cuda, M, N, K, o_n):
    sw, g = _sparse(N, K, "8:16", f"{o_n}:256", M, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args = (x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta)
    kw = dict(n=sw.n, m=sw.m, o_n=sw.o_n)
    before = fsl.launches
    y = fsl.fused_sparse_linear(*args, **kw)
    assert fsl.launches == before + 1
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


def test_sparse_apply_routes_to_the_kernels(cuda):
    with_o, g = _sparse(128, 512, "8:16", "16:256", 0, cuda)
    without, _ = _sparse(128, 512, "8:16", None, 1, cuda)
    x = torch.randn((2, 3, 512), generator=g, device=cuda).to(torch.bfloat16)
    counts = (nms.launches, fsl.launches)
    assert sparse_apply(with_o, x).shape == (2, 3, 128)
    assert sparse_apply(without, x).shape == (2, 3, 128)
    assert (nms.launches, fsl.launches) == (counts[0] + 1, counts[1] + 1)


def test_wrappers_raise_instead_of_falling_back(cuda):
    sw, g = _sparse(64, 256, "8:16", "16:256", 2, cuda)
    x = torch.randn((4, 256), generator=g, device=cuda)
    counts = (nms.launches, fsl.launches)
    with pytest.raises(TypeError):                      # f32 x on CUDA
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16)
    with pytest.raises(TypeError):
        sparse_apply(sw, x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):                     # not contiguous
        nms.nm_spmm(xb.t().contiguous().t(), sw.nm_values, sw.nm_meta,
                    n=8, m=16)
    flat = torch.empty(4 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                     # not 16-byte aligned
        nms.nm_spmm(flat[1:].view(4, 256), sw.nm_values, sw.nm_meta,
                    n=8, m=16)
    with pytest.raises(ValueError):                     # buffers on the CPU
        nms.nm_spmm(xb, sw.nm_values.cpu(), sw.nm_meta.cpu(), n=8, m=16)
    with pytest.raises(ValueError):                     # wrong outlier shape
        fsl.fused_sparse_linear(xb, sw.nm_values, sw.nm_meta,
                                sw.o_values[:, :, :8].contiguous(),
                                sw.o_meta, n=8, m=16, o_n=16)
    assert (nms.launches, fsl.launches) == counts
