"""Host side of zklisp_tpu_torch.field.digit_dot on the CPU: how the
wrapper lays out the operands for the TMA kernel, and the plain version
against the numpy int64 product at the edges of the kernel's tiling.

The kernel itself (csrc/digit_dot.cu: TMA loads into 128-byte boxes,
wgmma on 128 x 256, 128 x 128 or 128 x 32 tiles, picked by `launch_tc`)
runs only on the card; chip_smoke.py holds it against `digit_dot_plain`
there, exactly, at these same shapes.
Every comparison here is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from zklisp_tpu_torch.field import digit_dot as TD

# every (M, K, N) the default configuration launches on a rollup-bench
# segment (columns stacked as field_matmul stacks them)
MAIN_PATH = [(10752, 2048, 8192), (4096, 2048, 8192), (1024, 2048, 8192),
             (131072, 1760, 32), (256, 2048, 8192), (2688, 512, 2048),
             (512, 1024, 4096), (256, 512, 2048)]

# the edges of the tiling: K = 32 and K not a multiple of the 128-byte
# box; M and N not multiples of 64, 128 or 256; N = 8 ... 40; K not a
# multiple of 32 (the wrapper pads it); grids large enough for the
# 128 x 256 tiles, ragged, with N a multiple of 4 and not
EDGES = [(200, 32, 136), (129, 1760, 40), (257, 2080, 264),
         (65, 512, 129), (129, 640, 257), (257, 96, 65), (300, 256, 8),
         (129, 160, 16), (65, 2080, 24), (257, 1760, 40), (1, 32, 8),
         (1, 100, 16), (77, 45, 19), (300, 1000, 130), (4225, 64, 2051),
         (4161, 96, 2056)]


@pytest.mark.parametrize("M,K,N", MAIN_PATH)
def test_operands_pass_main_path_shapes_through(M, K, N):
    """At the main path's shapes the wrapper hands the kernel the tensors
    it was given: K is already a multiple of 32 (so every row starts on a
    16-byte boundary, as the TMA unit needs) and nothing is copied."""
    a = torch.empty((M, K), dtype=torch.uint8)
    wt = torch.empty((N, K), dtype=torch.uint8)
    a2, wt2, k = TD.operands(a, wt)
    assert k == K and k % TD.K_ALIGN == 0 and k % 16 == 0
    assert a2.data_ptr() == a.data_ptr() and wt2.data_ptr() == wt.data_ptr()
    assert a2.shape == (M, K) and wt2.shape == (N, K)


def _misaligned(x):
    """x copied into a view that starts one byte into its storage."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _strided(x):
    """x as a non-contiguous (transposed twice) view."""
    return x.t().contiguous().t()


@pytest.mark.parametrize("M,K,N", EDGES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_operands_at_the_edges(M, K, N, dtype):
    """K is zero-padded to a multiple of 32, rows are contiguous, bases
    are 16-byte aligned even when the caller's view is not, and the
    padded product equals the caller's.  One operand comes misaligned,
    the other strided (the roles swap with the dtype)."""
    rng = np.random.default_rng(M * 7 + K * 3 + N)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, size=(M, K))).to(dtype)
    wt = torch.from_numpy(rng.integers(lo, hi, size=(N, K))).to(dtype)
    if dtype == torch.uint8:
        a, wt = _misaligned(a), _strided(wt)
    else:
        a, wt = _strided(a), _misaligned(wt)

    a2, wt2, k = TD.operands(a, wt)
    assert k == -(-K // TD.K_ALIGN) * TD.K_ALIGN and k % 16 == 0
    for t, rows in ((a2, M), (wt2, N)):
        assert t.dtype == dtype and t.shape == (rows, k)
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert not t[:, K:].any()                   # the padding is zeros
    assert torch.equal(a2[:, :K], a) and torch.equal(wt2[:, :K], wt)
    assert torch.equal(TD.digit_dot_plain(a2, wt2),
                       TD.digit_dot_plain(a, wt))


@pytest.mark.parametrize("M,K,N", EDGES + [(3, 32768, 2)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_plain_equals_numpy_at_the_edges(M, K, N, dtype):
    """digit_dot_plain (what the kernel is held against) equals the numpy
    int64 product, with the extreme digit in the first row of each
    operand."""
    rng = np.random.default_rng(K * 11 + N)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    a = rng.integers(lo, hi, size=(M, K)).astype(np.int64)
    wt = rng.integers(lo, hi, size=(N, K)).astype(np.int64)
    a[0] = wt[0] = lo if dtype == torch.int8 else hi - 1
    want = a @ wt.T
    assert np.abs(want).max() < 1 << 31
    got = TD.digit_dot(torch.from_numpy(a).to(dtype),
                       torch.from_numpy(wt).to(dtype))
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_plain_at_max_k():
    """K = MAX_K with every digit 255: the largest sum the callers can
    produce, 33,025 * 255^2, still fits int32 and is exact."""
    a = torch.full((2, TD.MAX_K), 255, dtype=torch.uint8)
    got = TD.digit_dot_plain(a, a)
    assert int(got[0, 0]) == TD.MAX_K * 255 * 255 < 1 << 31
    assert torch.equal(got, torch.full((2, 2), TD.MAX_K * 255 * 255,
                                       dtype=torch.int32))


def test_launch_error_names_the_failing_step():
    assert TD.launch_error(-1) == "cuTensorMapEncodeTiled failed: CUresult 1"
    assert TD.launch_error(1) == "CUDA error 1"
    assert TD.launch_error(700) == "CUDA error 700"
