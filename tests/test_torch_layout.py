"""The swizzled weight images that K1 and K2 stream (ops/fused_vg.py
`swizzle128`, `weight_images`): exact layout and round trip on the CPU.
The kernels' 1-D bulk copies land these bytes in shared memory as they
are, so each element has to sit where wgmma's 128-byte-swizzle
descriptor reads it (csrc/hopper_mlp.cuh `sw_off`)."""

import numpy as np
import pytest
import torch

from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
from pointnerf_slam_torch.ops import fused_vg as F
from tests.torch_threads import share_cores

share_cores()


def unswizzle128(img: torch.Tensor) -> torch.Tensor:
    """(S, R, 64) -> (R, 64 S): swizzle128 is its own inverse per slice."""
    S, R, _ = img.shape
    return F.swizzle128(img.permute(1, 0, 2).reshape(R, S * 64)).permute(
        1, 0, 2).reshape(R, S * 64)


def _rand_bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(
        torch.bfloat16)


@pytest.mark.parametrize("R,K", [(8, 64), (64, 64), (128, 256), (256, 128),
                                 (256, 256)])
def test_swizzle128_round_trip_and_positions(R, K):
    m = _rand_bf16((R, K), R + K)
    img = F.swizzle128(m)
    assert img.shape == (K // 64, R, 64)
    assert torch.equal(unswizzle128(img), m)
    # element (r, c): slice c // 64, row r, 16-byte group ((c % 64) // 8)
    # XOR (r % 8), position c % 8 inside the group
    r = torch.arange(R)[:, None].expand(R, K)
    c = torch.arange(K)[None, :].expand(R, K)
    g = ((c % 64) // 8) ^ (r % 8)
    assert torch.equal(img[c // 64, r, g * 8 + c % 8], m)


def test_swizzle128_rejects_ragged_columns():
    with pytest.raises(ValueError):
        F.swizzle128(torch.zeros(8, 70, dtype=torch.bfloat16))


def test_weight_images_hold_the_kernels_operands():
    """wf: the forward's B operands (W_l^T, 256 rows, K-slices of 64);
    wc: the chain's (W3, W2, W1 as 256-row slices, then W0p as 128-row
    slices): one 32 KB (or 16 KB) slice after another, in stream order."""
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(4))
    pw = F.pack_weights(F.params_of(dec)).with_images(chain=True)
    W0p, W1, W2, W3 = pw.Ws[:4]
    assert pw.wf.shape == (14, 256, 64) and pw.wf.dtype == torch.bfloat16
    assert pw.wc.shape == (12 * 256 * 64 + 4 * 128 * 64,)
    starts = [0, 2, 6, 10, 14]
    for l, W in enumerate((W0p, W1, W2, W3)):
        got = unswizzle128(pw.wf[starts[l]:starts[l + 1]])
        assert torch.equal(got, W.t()), l
    off = 0
    for W in (W3, W2, W1, W0p):
        n = W.numel()
        img = pw.wc[off:off + n].reshape(W.shape[1] // 64, W.shape[0], 64)
        assert torch.equal(unswizzle128(img), W)
        off += n
    assert off == pw.wc.numel()
    # the gather through the cached index equals swizzling directly
    assert torch.equal(pw.wf, torch.cat([F.swizzle128(W.t())
                                         for W in (W0p, W1, W2, W3)]))


def test_pointers_carry_the_images_last():
    """The kernels read the pointer array as Bp, W0p..Wo, b0..bo, then wf
    and wc: null until built, wf alone for K2 (and K3, K5), both for K1
    (and K4, K6), each built once."""
    dec = IMAPDecoder(MLPConfig(), torch.Generator().manual_seed(5))
    pw = F.pack_weights(F.params_of(dec))
    ptrs = list(pw.pointers())
    assert len(ptrs) == 13
    assert ptrs[0] == pw.Bp.data_ptr() and ptrs[5] == pw.Ws[4].data_ptr()
    assert ptrs[11] is None and ptrs[12] is None
    ptrs = list(pw.with_images(chain=False).pointers())
    assert ptrs[11] == pw.wf.data_ptr() and ptrs[12] is None
    wf = pw.wf
    ptrs = list(pw.with_images(chain=True).pointers())
    assert pw.wf is wf
    assert ptrs[11] == pw.wf.data_ptr() and ptrs[12] == pw.wc.data_ptr()
    assert torch.equal(pw.wc, F.weight_images(pw.Ws)[1])
