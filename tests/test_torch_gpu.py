"""Kernels B1-B3 against their plain versions on a CUDA card.

Marked `gpu`: every test needs a CUDA device and `nvcc`, and skips where
`torch.cuda.is_available()` is False (decided inside the `cuda` fixture).
The file imports no JAX, so on a card without JAX run it without the
JAX test harness:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The cases are the kernels' edges (sizes around their tiles, one-element
and empty sides, duplicates, sentinels, negative keys) and the slice on
CUDA against the slice on the CPU.  Inputs come from
numpy.random.default_rng; every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, LAUNCHES
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import merge, necklace, scan

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("W", [2, 14, 26, 50, 54, 60])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_necklace_kernel_matches_plain(cuda, W, n):
    rng = np.random.default_rng(W * 1000 + n)
    x = rng.integers(0, 1 << W, size=n)
    x[: min(n, 3)] = [0, (1 << W) - 1, 1][: min(n, 3)]
    x = torch.from_numpy(x).to(cuda)
    neck, pos = necklace.necklace_pos(x, W)
    want_neck, want_pos = necklace.necklace_pos_plain(x, W)
    torch.cuda.synchronize()
    assert torch.equal(neck, want_neck) and torch.equal(pos, want_pos)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, (1 << 20) + 3])
def test_blank_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    starts = rng.integers(0, n, size=50)
    ends = np.minimum(starts + rng.integers(0, max(n // 20, 2), size=50), n)
    delta = np.zeros(n + 1, dtype=np.int32)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    for d in (delta[:n], np.zeros(n, dtype=np.int32)):
        t = torch.from_numpy(np.ascontiguousarray(d)).to(cuda)
        mask, n_valid = scan.blank_mask(t)
        want_mask, want_valid = scan.blank_mask_plain(t)
        torch.cuda.synchronize()
        assert torch.equal(mask, want_mask)
        assert int(n_valid) == int(want_valid)


@pytest.mark.parametrize("na,nb", [
    (0, 1), (1, 0), (1, 1), (2047, 1), (2048, 2048), (5000, 3), (3, 5000),
    (100_000, 77_777),
])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_merge_kernel_matches_plain(cuda, na, nb, hi):
    rng = np.random.default_rng(na * 7 + nb + hi % 1000)

    def side(n):
        v = rng.integers(-hi, hi, size=n)
        v[rng.random(n) < 0.05] = SENTINEL
        return torch.sort(torch.from_numpy(v).to(cuda)).values

    a, b = side(na), side(nb)
    got = merge.merge_sorted(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, merge.merge_sorted_plain(a, b))


def test_merge_rejects_mixed_devices(cuda):
    a = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        merge.merge_sorted(a, torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("slab", [None, 4096])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 25])
def test_slice_on_cuda_matches_cpu(cuda, monkeypatch, k, canonical, slab):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    off = np.array([0, 1_000, 1_010, 5_000, 11_990, 12_000], dtype=np.int64)
    q = np.concatenate([codes[2_000:4_500],
                        rng.integers(0, 4, size=3_000, dtype=np.uint8)])
    qoff = np.array([0, 2_500, 2_520, 5_500], dtype=np.int64)
    results = []
    for device in ("cpu", cuda):
        for name in LAUNCHES:
            monkeypatch.setitem(LAUNCHES, name, 0)
        idx = CBL(k=k, canonical=canonical, device=device)
        ps = idx.pack_stream(codes, off, slab=slab)
        idx.insert_codes_stream(ps)
        results.append((idx.count(), idx.query_codes_stream(ps),
                        idx.query_codes_stream(q, qoff)))
        launched = dict(LAUNCHES)
    assert results[0] == results[1]
    assert all(n >= 1 for n in launched.values()), launched
