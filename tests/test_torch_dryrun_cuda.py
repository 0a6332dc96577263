"""The dry run on fake CUDA tensors: the card's path, whose weight-kernel
wrappers record their launches instead of launching.  A CPU-only PyTorch
cannot index a fake CUDA tensor (its Python bindings take a CUDA device
guard), so these run where CUDA is present:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_cuda.py

Every family's smoke twin x train, prefill and decode (and long_500k for
ssm and hybrid) on a fake 2x2 world, dense and (serving cells)
8:16 + 16:256: ``status == "ok"``, and a compressed serving cell records
its kernels' launches by plan.  The CPU side of the same cells, and the
comparisons with the JAX package, are ``tests/test_torch_dryrun.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

pytestmark = pytest.mark.cuda

TWINS = ("llama-paper", "mixtral-8x7b", "qwen2-vl-72b", "xlstm-350m",
         "zamba2-2.7b", "whisper-medium")
SHAPES = {"train_4k": ("train", 4, 8), "prefill_32k": ("prefill", 4, 16),
          "decode_32k": ("decode", 4, 32), "long_500k": ("decode", 1, 32)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: fake CUDA tensors need CUDA's device "
                    "guard")


def _cells():
    for arch in TWINS:
        fam = configs.get_smoke(arch).family
        for name, (kind, _, _) in SHAPES.items():
            if name == "long_500k" and fam not in ("ssm", "hybrid"):
                continue
            for sparse in ((False, True) if kind != "train" else (False,)):
                yield arch, name, sparse


@pytest.mark.parametrize("arch,shape_name,sparse", list(_cells()))
def test_smoke_cell_on_fake_cuda(cuda, arch, shape_name, sparse):
    kind, B, S = SHAPES[shape_name]
    rec = dryrun.run_cell(arch, shape_name, False, probe=False,
                          verbose=False, sparse=sparse, device="cuda",
                          cfg=configs.get_smoke(arch),
                          shape=configs.ShapeConfig(shape_name, S, B, kind),
                          mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["device"] == "cuda"
    launches = rec["full"]["kernel_launches"]
    if sparse:
        assert launches and all(k.split("_")[-1] in ("decode", "prefill")
                                or k.endswith("_int8") for k in launches)
    else:
        assert launches == {}
