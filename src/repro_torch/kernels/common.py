"""What the kernels' wrappers (``nm_spmm``, ``fused_sparse_linear``,
``outlier_spmm``) share on the card: the operand checks of the N:M stream,
the prefill bodies' split rule, the split kernels' workspace and counters,
the SM count their plans are sized for, and what they do on a fake CUDA
tensor (a dry run, ``launch/dryrun.py``): build and launch nothing, record
the launch (``recording_fake_launches``) and return an empty output of the
kernel's shape and dtype."""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

H100_SM_COUNT = 132
"""SMs of an H100 SXM: the count a plan is sized for on a fake CUDA tensor,
which has no card to ask (``chip_smoke.py`` checks it against
``sm_count`` on the card)."""


@dataclasses.dataclass(frozen=True)
class FakeLaunch:
    """One launch a wrapper would have made on the card: the kernel's name
    as its launch counters name it (``fused_sparse_linear_int8`` for int8
    values), the plan, and the work of the kernel's bound: the multiply-adds
    of the stored entries (x2) and every input byte read once and the
    output written once."""
    kernel: str
    plan: object
    M: int
    K: int
    N: int
    flops: int
    bytes: int


_fake_recorders: list[list[FakeLaunch]] = []


@contextlib.contextmanager
def recording_fake_launches():
    """Within the block, every launch a wrapper takes on a fake CUDA
    tensor is appended to the yielded list."""
    launches: list[FakeLaunch] = []
    _fake_recorders.append(launches)
    try:
        yield launches
    finally:
        _fake_recorders.remove(launches)


def fake_launch(kernel: str, x: torch.Tensor, operands, N: int, make_plan,
                stored_per_row: int) -> torch.Tensor:
    """A wrapper's call on fake tensors: nothing built or launched; unless
    x has no rows (the card launches nothing then either), the launch of
    ``make_plan()``'s plan recorded with its FLOPs (2 M N
    ``stored_per_row``) and bytes (x, every weight buffer in ``operands``
    and y once); returns the empty [M, N] output in x's dtype, a fake
    tensor of x's mode."""
    if x.ndim != 2:
        raise ValueError(f"x must be [M, in], got shape {tuple(x.shape)}")
    M, K = x.shape
    if M:
        nbytes = (x.numel() * x.element_size() + M * N * x.element_size()
                  + sum(t.numel() * t.element_size() for t in operands
                        if t is not None))
        rec = FakeLaunch(kernel, make_plan(), M, K, N,
                         2 * M * N * stored_per_row, nbytes)
        for launches in _fake_recorders:
            launches.append(rec)
    return x.new_empty((M, N))


def check_cuda_operands(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor, n: int, m: int,
                        scale: torch.Tensor | None = None) -> tuple:
    """Validate what the CUDA kernels take: bf16 ``values`` with no
    ``scale``, or int8 ``values`` (8-byte aligned) with an f32 ``scale``
    [out]; returns (M, K, N)."""
    if x.ndim != 2:
        raise ValueError(f"x must be [M, in], got shape {tuple(x.shape)}")
    M, K = x.shape
    N = values.shape[0]
    if n > 8 or m > 16 or 256 % m:
        raise ValueError(f"the kernel takes n<=8 and m in (4, 8, 16); "
                         f"got {n}:{m}")
    if K % m or K % 8:
        raise ValueError(f"in dim {K} must be a multiple of m={m} and of 8")
    if values.shape != (N, K // m * n) or meta.shape != (N, K // m):
        raise ValueError(f"values {tuple(values.shape)} / meta "
                         f"{tuple(meta.shape)} do not match in={K}, {n}:{m}")
    operands = [("x", x, torch.bfloat16), ("meta", meta, torch.int32)]
    if scale is None:
        operands.append(("values", values, torch.bfloat16))
    else:
        if tuple(scale.shape) != (N,):
            raise ValueError(f"scale must be [{N}], got {tuple(scale.shape)}")
        operands += [("values", values, torch.int8),
                     ("scale", scale, torch.float32)]
        if values.data_ptr() % 8:
            raise ValueError("int8 values must be 8-byte aligned")
    for name, t, dtype in operands:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return M, K, N


def prefill_splits(tiles: int, groups: int, wave: int) -> int:
    """No split when the output tiles fill a wave of ``wave`` blocks;
    otherwise, of the equal splits (slices of whole groups) that keep the
    grid within two waves (each split adds S x M x N f32 of workspace),
    the one with the fewest waves x groups per slice, the time of the
    longest block's walk over K; ties to fewer splits."""
    if tiles >= wave:
        return 1
    best = (None, 1)
    for splits in range(1, min(groups, 2 * wave // tiles) + 1):
        per = -(-groups // splits)
        if -(-groups // per) != splits:
            continue                      # not an equal split
        cost = -(-tiles * splits // wave) * per
        if best[0] is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def scratch_for(device: torch.device, p):
    """The workspace and counters of plan ``p`` on ``device``: cached and
    grown when a plan needs more, so a call allocates nothing and launches
    no memset (the counters are zeroed once, when allocated, and each launch
    leaves them 0).  Launches on one device share them, so they must be
    ordered, as on one stream."""
    ws, cnt = _scratch.get(device.index, (None, None))
    if ws is None or ws.numel() * 4 < p.workspace_bytes:
        ws = torch.empty(max(p.workspace_bytes // 4, 1), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < p.counters:
        cnt = torch.zeros(max(p.counters, 1), dtype=torch.int32,
                          device=device)
    _scratch[device.index] = (ws, cnt)
    return ws, cnt


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
