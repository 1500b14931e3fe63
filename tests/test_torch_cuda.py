"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (``cuda`` marker) and skips without one;
the file imports no JAX, so it runs on a machine that has none:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5, bf16 2e-2 (the JAX package's kernel tolerances;
the grouped GEMM's atol grows with its depth d as sqrt(d); the backward
kernels' gradients, sums over many keys or rows, relative to each
gradient's largest magnitude); the WKV6
recurrence 5e-4 fp32, 5e-2 bf16 (the JAX package's WKV tolerances), plus
one bf16 step (2**-7 relative) on a bf16 y: both sides round the same fp32
sum once, and a sum on a rounding boundary lands one step apart, which
exceeds 5e-2 where |y| >= 8.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.kernel import (moe_gemm_dgrad,
                                                 moe_gemm_fwd,
                                                 moe_gemm_wgrad)
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd, rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
CASES = {
    "causal": dict(causal=True),
    "window32": dict(causal=True, window=32),
    "noncausal": dict(causal=False),
    "mask": dict(causal=False, mask=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _close(a, b, tol, atol=None):
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(),
                               atol=tol if atol is None else atol, rtol=tol)


def _path(fn, call):
    """call() and the one path of ``fn`` it launched (launches_by_path)."""
    before = dict(fn.launches_by_path)
    out = call()
    moved = {k: n - before[k] for k, n in fn.launches_by_path.items()
             if n != before[k]}
    assert len(moved) == 1 and list(moved.values()) == [1], moved
    return out, next(iter(moved))


# chip_smoke.py's row-by-row limit for the windowed kernels at S 8192: bf16
# rounding stays near 2**-8 of a row, a window edge a tile off moves a row
# whose window binds by ~0.1
WINDOW_ROW_TOL = 2e-2


def _row_err(a, b):
    """The largest over rows (the last axis) of |a - b| over the larger of
    |b| and the RMS of b's row norms (chip_smoke.row_err)."""
    torch.cuda.synchronize()
    a, b = a.float(), b.float()
    norms = b.norm(dim=-1)
    floor = float(norms.square().mean().sqrt())
    return float(((a - b).norm(dim=-1) / norms.clamp_min(floor)).max())


def _flash_case(cuda, B, Sq, Sk, H, kvH, D, seed=0, **kw):
    """bf16 inputs; the kernel (asserting the wgmma path) and the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Sk, kvH, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    mask = kw.pop("mask", None)
    out, path = _path(flash_attention_fwd,
                      lambda: flash_attention_fwd(q, k, v, mask, **kw))
    assert path == "wgmma"
    _close(out, flash_attention_ref(q, k, v, mask, **kw), TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 512, 777])
def test_flash_wgmma_sequence_edges(cuda, S, D, causal):
    """Lengths around the 64-row warpgroup, the 128-query block and the
    64-key tile: TMA zero-fills past S inside each (b, h), the -inf of keys
    past Sk, the store clipped at Sq."""
    _flash_case(cuda, 2, S, S, 4, 2, D, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq, Sk, window", [(1, 129, 0), (65, 193, 0),
                                            (64, 512, 0), (130, 777, 32),
                                            (63, 100, 16)])
def test_flash_wgmma_query_offset(cuda, Sq, Sk, window, D):
    """Queries at the end of a longer key range (q_offset = Sk - Sq), causal,
    with and without a window."""
    _flash_case(cuda, 2, Sq, Sk, 8, 2, D, causal=True, window=window,
                q_offset=Sk - Sq)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_wgmma_window(cuda, causal, D):
    _flash_case(cuda, 2, 300, 300, 4, 2, D, causal=causal, window=32)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_mask_with_fully_masked_rows(cuda, D):
    """Rows with no valid key average V uniformly (-1e30, not -inf), as the
    reference does; keys past Sk still weigh 0."""
    g = torch.Generator(device=cuda).manual_seed(3)
    mask = torch.rand(150, 150, generator=g, device=cuda) < 0.5
    mask[[0, 7, 64, 149]] = False
    _flash_case(cuda, 2, 150, 150, 4, 4, D, causal=False, mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("kvH", [8, 4, 2, 1])
def test_flash_wgmma_gqa_groups(cuda, kvH):
    """GQA groups 1, 2, 4 and 8: the kv head is h / group, never repeated."""
    _flash_case(cuda, 2, 200, 200, 8, kvH, 128, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [512, 4096])
def test_flash_window_at_mistral_training_length(cuda, window):
    """mistral-7b's training shape, B 1, S 8192, 32/8 heads, D 128, bf16,
    causal with a window of 512 or 4096 (which binds at S 8192): the
    forward and the backward kernels (wgmma) against their plain versions,
    also row by row (WINDOW_ROW_TOL), where the same kernels with the
    window a 64-key tile narrower or wider must fail."""
    kw = dict(causal=True, window=window)
    _flash_case(cuda, 1, 8192, 8192, 32, 8, 128, seed=window, **kw)
    q, k, v, o, lse, do = _bwd_inputs(cuda, 1, 8192, 8192, 32, 8, 128,
                                      window, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    assert _row_err(o, ref) <= WINDOW_ROW_TOL
    for shift in (-64, 64):
        moved = flash_attention_fwd(q, k, v, causal=True,
                                    window=window + shift)
        assert _row_err(moved, ref) > WINDOW_ROW_TOL, shift
    del ref
    grads, path = _path(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    assert path == "wgmma"
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, b in zip("qkv", grads, plain):
        _rel(a, b, TOL[torch.bfloat16], f"d{name} vs plain backward")
        assert _row_err(a, b) <= WINDOW_ROW_TOL, f"d{name} by rows"
    for shift in (-64, 64):
        moved = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                    window=window + shift)
        assert max(_row_err(a, b) for a, b in zip(moved, plain)) \
            > WINDOW_ROW_TOL, shift


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("H", [40, 48])
def test_flash_groups_of_5_and_6(cuda, H, window):
    """qwen2.5-32b's 40/8 heads (group 5) and nemotron-4-15b's 48/8 (group
    6) at D 128, bf16: forward and backward (wgmma) against the plain
    versions."""
    kw = dict(causal=True, window=window)
    _flash_case(cuda, 2, 300, 300, H, 8, 128, seed=H, **kw)
    q, k, v, o, lse, do = _bwd_inputs(cuda, 2, 300, 300, H, 8, 128, H, **kw)
    grads, path = _path(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    assert path == "wgmma"
    for name, a, b in zip("qkv", grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        _rel(a, b, TOL[torch.bfloat16], f"d{name} vs plain backward")


@pytest.mark.cuda
def test_flash_wgmma_reads_fused_projection_and_transposed_views(cuda):
    """q, k, v as views of one (B, S, (H + 2 kvH) D) projection, and as
    (B, H, S, D) tensors transposed: read in place through their strides."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, S, H, kvH, D = 2, 200, 8, 2, 128
    f = torch.randn(B, S, (H + 2 * kvH) * D, generator=g,
                    device=cuda).bfloat16()
    q = f[..., :H * D].view(B, S, H, D)
    k = f[..., H * D:(H + kvH) * D].view(B, S, kvH, D)
    v = f[..., (H + kvH) * D:].view(B, S, kvH, D)
    for args in ((q, k, v), tuple(t.transpose(1, 2).contiguous()
                                  .transpose(1, 2) for t in (q, k, v))):
        out, path = _path(flash_attention_fwd,
                          lambda: flash_attention_fwd(*args, causal=True))
        assert path == "wgmma"
        _close(out, flash_attention_ref(*args, causal=True),
               TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_wgmma_raises_on_strides_tma_refuses(cuda):
    """A sequence stride 8 bytes past a multiple of 16: raise, launch
    nothing."""
    f = torch.zeros(2, 64, 6 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    q = f[..., :4 * 64].view(2, 64, 4, 64)
    k = f[..., 4 * 64:5 * 64].view(2, 64, 1, 64)
    n = dict(flash_attention_fwd.launches_by_path)
    with pytest.raises(ValueError, match="cannot be read by TMA"):
        flash_attention_fwd(q, k, k, causal=True)
    assert flash_attention_fwd.launches_by_path == n


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["up", "down"])
@pytest.mark.parametrize("E", [1, 64])
@pytest.mark.parametrize("C", [1, 8, 9, 63, 64, 65, 128, 240])
def test_moe_gemm_wgmma_edges(cuda, C, E, form):
    """Capacities around wgmma's N of 8 (decode, A and B swapped) and the
    128- and 256-row C-tiles (prefill); d and h multiples of 8 but not of
    64, zero-filled by TMA past d and C inside each expert; both forms of
    the block's contractions (wg / wu: d -> h, wd: h -> d)."""
    d, h = (72, 136) if form == "up" else (136, 72)
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn(E, C, d, generator=g, device=cuda).bfloat16()
    w = torch.randn(E, d, h, generator=g, device=cuda).bfloat16()
    y, path = _path(moe_gemm_fwd, lambda: moe_gemm_fwd(x, w))
    assert path == "wgmma" and y.shape == (E, C, h)
    _close(y, moe_gemm_ref(x, w), TOL[torch.bfloat16],
           atol=TOL[torch.bfloat16] * d ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("xdw", [((3, 37, 100), (3, 100, 48), "wmma"),
                                 ((3, 37, 96), (3, 96, 45), "wmma"),
                                 ((3, 37, 96), (3, 96, 48), "simt")])
def test_moe_gemm_keeps_old_kernels_for_what_tma_cannot_read(cuda, xdw):
    """d or h not a multiple of 8 (bf16) take the element-wise wmma kernel;
    fp32 the CUDA-core kernel."""
    xs, ws, want = xdw
    dt = torch.float32 if want == "simt" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(xs, generator=g, device=cuda).to(dt)
    w = torch.randn(ws, generator=g, device=cuda).to(dt)
    y, path = _path(moe_gemm_fwd, lambda: moe_gemm_fwd(x, w))
    assert path == want
    _close(y, moe_gemm_ref(x, w), TOL[dt], atol=TOL[dt] * xs[2] ** 0.5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 64, 200])
def test_flash_kernel_matches_plain(cuda, S, dtype, case, D):
    kw = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, S, h, D, generator=g, device=cuda).to(dtype)
               for h in (4, 2, 2))
    mask = None
    if kw.get("mask"):
        mask = torch.rand(S, S, generator=g, device=cuda) < 0.7
        mask |= torch.eye(S, dtype=torch.bool, device=cuda)
    args = dict(causal=kw["causal"], window=kw.get("window", 0))
    _close(flash_attention_fwd(q, k, v, mask, **args),
           flash_attention_ref(q, k, v, mask, **args), TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs_and_offsets(cuda):
    """q/k/v as views of one packed projection, queries at an offset."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 96, 8 + 2 + 2, 64, generator=g, device=cuda)
    q, k, v = qkv[:, 32:, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    args = dict(causal=True, window=24, q_offset=32)
    _close(flash_attention_fwd(q, k, v, **args),
           flash_attention_ref(q, k, v, **args), TOL[torch.float32])


def _offset_randn(shape, dtype, elems, g, device):
    """randn of ``shape`` in a contiguous view ``elems`` elements into its
    storage (a base off the 16-byte grid for elems 1)."""
    n = int(np.prod(shape))
    t = torch.randn(n + elems, generator=g, device=device).to(dtype)
    return t[elems:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(4, 128), (2, 100, 256), (3, 4096),
                                   (5, 2560), (2, 3, 1500), (1, 4096),
                                   (2048, 4096)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, wdtype, shape, offset):
    """Plain and residual forms; rows wider than 1024 of whole 16-byte words
    on aligned bases take the vector kernel, the rest (narrow rows, d 1500
    bf16, a view one element into its storage) the scalar one."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, r = (_offset_randn(shape, dtype, offset, g, cuda) for _ in range(2))
    w = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype)
    row = shape[-1] * x.element_size()
    want = "vector" if shape[-1] > 1024 and row % 16 == 0 and not offset \
        else "simt"
    y, path = _path(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w))
    assert path == want
    _close(y, rmsnorm_ref(x, w), TOL[dtype])
    (y, res), path = _path(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w, r))
    assert path == want
    y_ref, res_ref = rmsnorm_ref(x, w, r)
    _close(y, y_ref, TOL[dtype])
    _close(res, res_ref, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("ECdh", [(4, 64, 96, 200), (2, 100, 48, 64),
                                  (8, 8, 16, 16), (3, 37, 100, 45),
                                  (2, 130, 72, 136), (1, 8, 2048, 1408),
                                  (64, 8, 1408, 2048), (1, 1, 7, 3),
                                  (2, 240, 40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel_matches_plain(cuda, dtype, ECdh):
    """Ragged C, d and h (element-wise loads where d or h is not a multiple
    of 8), E = 1, the decode capacity C = 8 and the prefill tile C = 240."""
    E, C, d, h = ECdh
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(E, C, d, generator=g, device=cuda).to(dtype)
    w = torch.randn(E, d, h, generator=g, device=cuda).to(dtype)
    y = moe_gemm_fwd(x, w)
    assert y.dtype == dtype and y.shape == (E, C, h)
    _close(y, moe_gemm_ref(x, w), TOL[dtype], atol=TOL[dtype] * d ** 0.5)


@pytest.mark.cuda
def test_moe_gemm_kernel_counts_and_rejects(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    n = moe_gemm_fwd.launches
    moe_gemm_fwd(x, torch.zeros(2, 16, 4, device=cuda))
    assert moe_gemm_fwd.launches == n + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_gemm_fwd(x, torch.zeros(2, 16, 4, device=cuda,
                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_fwd(x, torch.zeros(2, 4, 16, device=cuda).transpose(1, 2))


def _wkv_inputs(device, B, S, H, D, dtype, state, seed=0):
    """r, k, v ~ 0.5 N(0,1) in dtype, w_log = -exp(N(0,1)) fp32, u ~ N(0,1)
    fp32, state ~ 0.5 N(0,1) fp32 or None (as tests/test_kernels.py)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (0.5 * torch.randn(B, S, H, D, generator=g, device=device)
               for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, D, generator=g, device=device))
    u = torch.randn(H, D, generator=g, device=device)
    s0 = (0.5 * torch.randn(B, H, D, D, generator=g, device=device)
          if state else None)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("BH", [(2, 3), (3, 5)])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 130, 512])
def test_wkv6_kernel_matches_plain(cuda, S, dtype, D, state, BH):
    """One token (decode), ragged S (a partial last chunk), the serving
    prompt; from zero or from a given state; H 3 and 5 with B 2 and 3.
    Aligned inputs take the split kernel; y and the final state match the
    plain version."""
    args = _wkv_inputs(cuda, BH[0], S, BH[1], D, dtype, state)
    s_in = None if args[5] is None else args[5].clone()
    (y, st), path = _path(wkv6_fwd, lambda: wkv6_fwd(*args))
    assert path == "split"
    y_ref, st_ref = wkv6_ref(*args)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol, rtol = (5e-4, 0) if dtype == torch.float32 else (5e-2, 2 ** -7)
    _close(y, y_ref, rtol, atol=tol)
    _close(st, st_ref, 0, atol=tol)
    if s_in is not None:                     # the given state is not written
        assert torch.equal(args[5], s_in)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 77])
def test_wkv6_unaligned_input_takes_the_column_kernel(cuda, S):
    """r one element into its storage: the one-column-a-thread kernel, the
    same y and state."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, S, 5, 64, torch.bfloat16, True)
    r = torch.cat([r.new_zeros(1), r.flatten()])[1:].view(r.shape)
    (y, st), path = _path(wkv6_fwd, lambda: wkv6_fwd(r, k, v, w, u, s0))
    assert path == "simt"
    y_ref, st_ref = wkv6_ref(r, k, v, w, u, s0)
    _close(y, y_ref, 2 ** -7, atol=5e-2)
    _close(st, st_ref, 0, atol=5e-2)


@pytest.mark.cuda
def test_wkv6_kernel_counts_and_rejects(cuda):
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 1, 4, 2, 16, torch.float32, True)
    n = wkv6_fwd.launches
    wkv6_fwd(r, k, v, w, u, s0)
    assert wkv6_fwd.launches == n + 1
    with pytest.raises(TypeError, match="all float32 or all"):
        wkv6_fwd(r, k.to(torch.bfloat16), v, w, u)
    with pytest.raises(TypeError, match="w_log, u and state in float32"):
        wkv6_fwd(r, k, v, w, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_fwd(r, k, v, w.transpose(1, 2).contiguous().transpose(1, 2), u)
    r48, k48, v48, w48, u48, _ = _wkv_inputs(cuda, 1, 4, 2, 48,
                                             torch.float32, False)
    with pytest.raises(ValueError, match="no instance for head size 48"):
        wkv6_fwd(r48, k48, v48, w48, u48)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_fwd(r, k, v, w, u.cpu())
    assert wkv6_fwd.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen3-4b",
                                  "deepseek-v3-16b", "rwkv6-3b"])
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    """fp32 prefill + decode logits through the kernels equal the CPU's
    plain path on the same parameters (2e-4: fp32 sums in another order
    through 4 layers, and bf16 cache values that may round apart)."""
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg, max_cache_len=40)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        lc, cc = model.prefill(params, {"tokens": tokens})
        lg, cg = model.prefill(on_card, {"tokens": tokens.to(cuda)})
        _close(lg, lc, 2e-4)
        tok = tokens[:, -1:]
        for _ in range(4):
            lc, cc = model.decode_step(params, tok, cc)
            lg, cg = model.decode_step(on_card, tok.to(cuda), cg)
            _close(lg, lc, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-7b", "deepseek-7b", "qwen2.5-32b",
                                  "nemotron-4-15b"])
def test_reduced_model_float32_cache_on_card_matches_cpu(cuda, arch):
    """As above with a float32 cache on both sides (mistral's a ring of its
    32-position window, which the decode steps wrap), so that no bf16
    rounding of the cache can land apart: prefill and decode logits within
    2e-4 (fp32 sums in another order through 4 layers)."""
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg, max_cache_len=40)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        lc, cc = model.prefill(params, {"tokens": tokens},
                               model.init_cache(2, "cpu", torch.float32))
        lg, cg = model.prefill(on_card, {"tokens": tokens.to(cuda)},
                               model.init_cache(2, cuda, torch.float32))
        _close(lg, lc, 2e-4)
        tok = tokens[:, -1:]
        for _ in range(4):
            lc, cc = model.decode_step(params, tok, cc)
            lg, cg = model.decode_step(on_card, tok.to(cuda), cg)
            _close(lg, lc, 2e-4)



@pytest.mark.cuda
def test_ring_decode_past_the_window_on_card_equals_plain_path(cuda):
    """Reduced fp32 mistral-7b with a window of 8 and a cache of 48 asked
    for (a ring of 8 slots): a prompt of 32 and 24 greedy tokens, past the
    window and past the 48, through the kernels and through the plain
    versions on the card: the same tokens, the prefill through the flash
    kernel."""
    from unittest import mock
    from repro_torch.serve.decode import ServeConfig, ServingLoop
    cfg = get_reduced_config("mistral-7b").replace(compute_dtype="float32",
                                                   window=8)
    model = build_model(cfg, max_cache_len=48)
    assert model.ring and model.cache_window == 8
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    loop = ServingLoop(model, params, 2, 32, ServeConfig(max_new_tokens=24),
                       device=cuda)
    _build.reset_counts(flash_attention_fwd)
    got = loop.serve(prompts)
    assert flash_attention_fwd.launches == cfg.n_layers
    with mock.patch.object(fa_ops, "flash_attention", flash_attention_ref), \
            mock.patch.object(rms_ops, "rmsnorm", rmsnorm_ref):
        want = loop.serve(prompts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_init_params_peak_is_the_leaf_and_one_float32_layer(cuda):
    """A stacked bf16 leaf is made a layer at a time: the peak while it is
    made is the leaf plus one layer's float32 draw, and each layer is
    drawn at 1/sqrt(fan_in)."""
    from repro_torch.models.common import ParamSpec, init_params
    L, d, f = 8, 1024, 2048
    spec = {"w": ParamSpec((L, d, f), ("layers", "embed", "mlp"))}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p = init_params(spec, torch.Generator(device=cuda).manual_seed(0),
                    dtype=torch.bfloat16, device=cuda)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert p["w"].dtype == torch.bfloat16 and p["w"].shape == (L, d, f)
    assert peak <= L * d * f * 2 + d * f * 4, peak
    std = p["w"].float().flatten(1).std(1) * d ** 0.5
    assert bool(((std - 1).abs() < 0.01).all()), std


# ------------------------------------------------------------- backwards
def _rel(a, b, tol, what=""):
    """max |a - b| within tol of max |b|, or of 1 where the gradient is
    smaller: one that is zero by construction (dq where each query sees a
    single key, so dS = P (dP - delta) = 0) holds only rounding noise."""
    torch.cuda.synchronize()
    err = float((a.float() - b.float()).abs().max())
    scale = max(float(b.float().abs().max()), 1.0)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


BWD_CASES = {  # (causal, window, q_offset, Sk - Sq)
    "causal": (True, 0, 0, 0),
    "window32": (True, 32, 0, 0),
    "noncausal": (False, 0, 0, 0),
    "offset": (True, 16, 40, 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 65, 200])
def test_flash_backward_matches_plain_and_autograd(cuda, S, D, dtype, case,
                                                   G):
    """The forward's log-sum-exp against the plain one; dq, dk, dv of the
    backward kernels (bf16 D 64/128: the wgmma kernels, the rest the simt
    ones) against the plain backward from the same (o, lse), and against
    autograd of the plain forward in fp32 (bf16: P rounds to bf16 before dV
    in both, the inputs are the same bf16 values)."""
    causal, window, off, extra = BWD_CASES[case]
    kvH = 2
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, do = (torch.randn(2, S, kvH * G, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, S + extra, kvH, D, generator=g,
                        device=cuda).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
    o_ref, lse_ref = flash_attention_ref(q, k, v, **kw, return_lse=True)
    _close(lse, lse_ref, 1e-5, atol=1e-4)
    grads, path = _path(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    assert path == ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
                    else "simt")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip("qkv", grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert a.dtype == dtype and a.shape == b.shape
        _rel(a, b, tol, f"d{name} vs plain backward")
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, **kw)
    out.backward(do.float())
    for name, a, t in zip("qkv", grads, leaves):
        _rel(a, t.grad, tol, f"d{name} vs autograd")


def _bwd_inputs(cuda, B, Sq, Sk, H, kvH, D, seed, **kw):
    """bf16 q, k, v, dO from a seed and the forward kernel's o and lse."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Sk, kvH, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("S", [1000, 2100])
def test_flash_backward_wgmma_long_grouped_and_deterministic(cuda, S, G, D):
    """Several wraps of the three-stage rings (16 and 33 query tiles of 64
    for each of G heads) and a ragged tail, causal, GQA groups 4 and 8:
    against the plain backward and autograd of the plain forward, and the
    same bits on a second run (each gradient is summed by one block in a
    fixed order)."""
    kw = dict(causal=True)
    q, k, v, o, lse, do = _bwd_inputs(cuda, 1, S, S, 2 * G, 2, D, S + G, **kw)
    grads, path = _path(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    assert path == "wgmma"
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, **kw).backward(do.float())
    for name, a, b, t in zip("qkv", grads, flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), leaves):
        _rel(a, b, 2e-2, f"d{name} vs plain backward")
        _rel(a, t.grad, 2e-2, f"d{name} vs autograd")
    for a, b in zip(grads, flash_attention_bwd(q, k, v, o, lse, do, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True, window=0, q_offset=0),
                                dict(causal=True, window=48, q_offset=100)])
def test_flash_backward_kept_simt_kernel_matches_plain(cuda, kw):
    """The CUDA-core kernels kept beside the wgmma ones, reached on bf16 D
    128 through ``_launch_bwd``: the same gradients as the plain backward."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 2, 200, 300, 8, 2, 128, 5, **kw)
    grads, path = _path(flash_attention_bwd, lambda: fa_kernel._launch_bwd(
        "simt", q, k, v, o, lse, do, **kw))
    assert path == "simt"
    for name, a, b in zip("qkv", grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        _rel(a, b, 2e-2, f"d{name} vs plain backward")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True, q_offset=-70),
                                dict(causal=False, window=16, q_offset=100)])
def test_flash_backward_wgmma_rows_that_see_no_key(cuda, kw, D):
    """Rows before position 0 (causal) or whose window starts past the last
    key: lse -1e30, P 1 for every key, as the plain backward computes them
    (the autograd function refuses such inputs)."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 2, 200, 130, 4, 2, D, 6, **kw)
    assert bool((lse == -1e30).any())
    grads, path = _path(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    assert path == "wgmma"
    for name, a, b in zip("qkv", grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        _rel(a, b, 2e-2, f"d{name} vs plain backward")


@pytest.mark.cuda
def test_flash_autograd_function_runs_the_kernels(cuda):
    """With a gradient needed, the op runs the forward kernel with its lse
    and the backward kernel once; a mask, or a query that sees no key,
    is refused."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 96, 8, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 96, 2, 64, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = fa_ops.flash_attention(*leaves, causal=True, window=24)
    do = torch.randn_like(out)
    out.backward(do)
    assert flash_attention_fwd.launches == n_f + 1
    assert flash_attention_bwd.launches == n_b + 1
    o, lse = flash_attention_fwd(q, k, v, causal=True, window=24,
                                 return_lse=True)
    for t, want in zip(leaves, flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal=True, window=24)):
        assert torch.equal(t.grad, want)
    with pytest.raises(NotImplementedError, match="mask"):
        fa_ops.flash_attention(*leaves, torch.ones(96, 96, dtype=torch.bool,
                                                   device=cuda))
    with pytest.raises(ValueError, match="every query to see a key"):
        fa_ops.flash_attention(*leaves, causal=True, q_offset=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 4096), (5, 2560), (300, 128),
                                   (2, 3, 100), (33, 16), (7, 5000),
                                   (3, 8192)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_plain(cuda, dtype, wdtype, shape):
    """dx and dw against the plain backward (and autograd of the plain
    forward for fp32); dw the same bits in two runs."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x, dy = (torch.randn(*shape, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    w = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype)
    n = rmsnorm_bwd.launches
    dx, dw = rmsnorm_bwd(x, w, dy)
    assert rmsnorm_bwd.launches == n + 1
    assert dx.dtype == dtype and dw.dtype == wdtype
    rx, rw = rmsnorm_bwd_ref(x, w, dy)
    _rel(dx, rx, 2e-5 if dtype == torch.float32 else 2e-2, "dx")
    _rel(dw, rw, 2e-5 if wdtype == torch.float32 else 2e-2, "dw")
    assert torch.equal(rmsnorm_bwd(x, w, dy)[1], dw)
    if dtype == wdtype == torch.float32:
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        rmsnorm_ref(xl, wl).backward(dy)
        _rel(dx, xl.grad, 2e-5, "dx vs autograd")
        _rel(dw, wl.grad, 2e-5, "dw vs autograd")


@pytest.mark.cuda
def test_rmsnorm_autograd_function_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(64, 4096, generator=g, device=cuda).bfloat16()
    w = torch.randn(4096, generator=g, device=cuda)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    n_f, n_b = rmsnorm_fwd.launches, rmsnorm_bwd.launches
    y = rms_ops.rmsnorm(xl, wl)
    dy = torch.randn_like(y)
    y.backward(dy)
    assert (rmsnorm_fwd.launches, rmsnorm_bwd.launches) == (n_f + 1, n_b + 1)
    dx, dw = rmsnorm_bwd(x, w, dy)
    assert torch.equal(xl.grad, dx) and torch.equal(wl.grad, dw)
    with pytest.raises(NotImplementedError, match="residual"):
        rms_ops.rmsnorm(xl, wl, xl)


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_gradients(cuda):
    """The WKV6 kernel has no backward: with a gradient needed it raises
    instead of returning a detached output; without one (inference) it
    runs."""
    r, k, v, wl, u, s0 = _wkv_inputs(cuda, 1, 4, 2, 16, torch.float32, True)
    u.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        wkv_ops.wkv6(r, k, v, wl, u, s0)
    with torch.inference_mode():
        assert wkv_ops.wkv6(r, k, v, wl, u, s0)[0].shape == r.shape


@pytest.mark.cuda
@pytest.mark.parametrize("ECdh,path", [
    ((3, 37, 100, 45), "simt"), ((2, 40, 96, 100), "simt"),
    ((2, 1, 64, 64), "wgmma"), ((3, 8, 72, 136), "wgmma"),
    ((3, 64, 136, 72), "wgmma"), ((2, 65, 72, 136), "wgmma"),
    ((2, 130, 136, 72), "wgmma"), ((2, 300, 264, 200), "wgmma"),
    ((4, 129, 1408, 2048), "wgmma")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_backward_matches_plain(cuda, dtype, ECdh, path):
    """dgrad and wgrad against the plain backward, relative to each
    gradient's largest magnitude: C around wgmma's 64- and 128-row tiles
    (dgrad's rows) and 64-deep stages (wgrad's contraction), d and h
    multiples of 8 but not of 64, both orientations; fp32 and bf16 that
    TMA cannot read on the CUDA-core kernel."""
    E, C, d, h = ECdh
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn(E, C, d, generator=g, device=cuda).to(dtype)
    w = torch.randn(E, d, h, generator=g, device=cuda).to(dtype)
    dy = torch.randn(E, C, h, generator=g, device=cuda).to(dtype)
    dx, pd = _path(moe_gemm_dgrad, lambda: moe_gemm_dgrad(dy, w))
    dw, pw = _path(moe_gemm_wgrad, lambda: moe_gemm_wgrad(x, dy))
    assert (pd, pw) == ((path, path) if dtype == torch.bfloat16
                        else ("simt", "simt"))
    want = moe_gemm_bwd_ref(x, w, dy)
    for got, ref in zip((dx, dw), want):
        assert got.dtype == dtype and got.shape == ref.shape
        _rel(got, ref, TOL[dtype])


@pytest.mark.cuda
def test_moe_gemm_backward_edges_and_rejects(cuda):
    """C 0 gives a zero weight gradient and an empty dx; h 0 a zero dx; the
    wrappers refuse mixed dtypes and non-contiguous operands, and count one
    launch a call."""
    x = torch.zeros(2, 0, 16, device=cuda)
    dy = torch.zeros(2, 0, 8, device=cuda)
    w = torch.ones(2, 16, 8, device=cuda)
    assert moe_gemm_dgrad(dy, w).shape == (2, 0, 16)
    assert torch.equal(moe_gemm_wgrad(x, dy), torch.zeros(2, 16, 8,
                                                          device=cuda))
    assert torch.equal(moe_gemm_dgrad(torch.ones(2, 3, 0, device=cuda),
                                      torch.ones(2, 16, 0, device=cuda)),
                       torch.zeros(2, 3, 16, device=cuda))
    x, dy = torch.ones(2, 8, 16, device=cuda), torch.ones(2, 8, 8,
                                                          device=cuda)
    n = moe_gemm_wgrad.launches
    moe_gemm_wgrad(x, dy)
    assert moe_gemm_wgrad.launches == n + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_gemm_wgrad(x, dy.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_dgrad(dy, torch.ones(2, 8, 16, device=cuda).transpose(1, 2))


@pytest.mark.cuda
def test_moe_gemm_autograd_function_runs_the_kernels(cuda):
    """With a gradient needed the op runs the forward kernel and, in the
    backward, one dgrad and one wgrad, whose outputs are the gradients;
    without one it launches the forward alone."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 96, 72, generator=g, device=cuda).bfloat16()
    w = torch.randn(4, 72, 136, generator=g, device=cuda).bfloat16()
    dy = torch.randn(4, 96, 136, generator=g, device=cuda).bfloat16()
    fns = (moe_gemm_fwd, moe_gemm_dgrad, moe_gemm_wgrad)
    before = [fn.launches for fn in fns]
    with torch.no_grad():
        moe_ops.moe_gemm(x.requires_grad_(), w.requires_grad_())
    assert [fn.launches for fn in fns] == [before[0] + 1] + before[1:]
    y = moe_ops.moe_gemm(x, w)
    y.backward(dy)
    assert [fn.launches for fn in fns] == [b + 2 if i == 0 else b + 1
                                           for i, b in enumerate(before)]
    assert torch.equal(y, moe_gemm_fwd(x.detach(), w.detach()))
    assert torch.equal(x.grad, moe_gemm_dgrad(dy, w.detach()))
    assert torch.equal(w.grad, moe_gemm_wgrad(x.detach(), dy))


FRESH_THREAD = """
import torch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
torch.manual_seed(0)
kind = {kind!r}
if kind == "moe_gemm":
    x = torch.randn(2, 96, 72, device="cuda").bfloat16().requires_grad_()
    w = torch.randn(2, 72, 136, device="cuda").bfloat16().requires_grad_()
    moe_ops.moe_gemm(x, w).float().sum().backward()
    grads = (x.grad, w.grad)
else:
    q, k, v = (torch.randn(1, 128, 2, 64, device="cuda").bfloat16()
               .requires_grad_() for _ in range(3))
    fa_ops.flash_attention(q, k, v, causal=True).float().sum().backward()
    grads = (q.grad, k.grad, v.grad)
torch.cuda.synchronize()
assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
print("ok")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["moe_gemm", "flash_attention"])
def test_backward_kernels_launch_as_the_first_work_of_autograds_thread(
        cuda, kind):
    """A fresh process whose first CUDA backward is a TMA kernel's: the
    tensor maps are encoded on autograd's device thread, which has made no
    runtime call yet (no current context, so the encoder refused the base
    until hopper.cuh's make_map made the primary context current)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", FRESH_THREAD.format(kind=kind)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _to_leaves(tree, device):
    """A copy of a parameter tree on ``device``, each leaf a new autograd
    leaf."""
    if isinstance(tree, dict):
        return {k: _to_leaves(v, device) for k, v in tree.items()}
    return tree.detach().to(device).requires_grad_()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen3-4b", "mistral-7b",
                                  "deepseek-7b", "qwen2.5-32b",
                                  "nemotron-4-15b"])
def test_reduced_training_step_on_card_matches_cpu(cuda, arch):
    """fp32 loss and every gradient leaf through the forward and backward
    kernels equal the CPU's plain path on the same parameters and batch
    (fp32 sums in another order through 4 layers: 1e-4 of each leaf's
    largest magnitude), with each kernel launched as often as the layers
    and the per-layer checkpoint's recompute imply."""
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_train_params(torch.Generator().manual_seed(0), "cpu")
    on_card = _to_leaves(params, cuda)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -100
    lc, _ = model.loss(params, {"tokens": toks, "labels": labels})
    lc.backward()
    kernels = (flash_attention_fwd, flash_attention_bwd, rmsnorm_fwd,
               rmsnorm_bwd)
    for fn in kernels:
        _build.reset_counts(fn)
    lg, _ = model.loss(on_card, {"tokens": toks.to(cuda),
                                 "labels": labels.to(cuda)})
    lg.backward()
    torch.cuda.synchronize()
    # RMSNorms a layer (ln1, ln2, q and k), and the final one; LayerNorm
    # models launch no RMSNorm kernel
    L, norms = cfg.n_layers, 4 if cfg.qk_norm else 2
    final = 1
    if cfg.norm == "layernorm":
        norms, final = 0, 0
    assert [fn.launches for fn in kernels] == \
        [2 * L, L, 2 * norms * L + final, norms * L + final]
    assert abs(float(lg.detach()) - float(lc.detach())) <= 1e-5 * float(lc.detach())
    for a, b in zip(tree_leaves(on_card), tree_leaves(params)):
        _rel(a.grad.cpu(), b.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-16b", "deepseek-moe-16b"])
def test_reduced_moe_training_step_on_card_matches_cpu(cuda, arch):
    """Reduced fp32 MoE models: the loss and every gradient leaf through the
    kernels (the grouped GEMM's forward, dgrad and wgrad on CUDA cores)
    equal the CPU's plain path within 1e-4 of each leaf's largest, with
    3 forward GEMMs a MoE layer twice (the recompute) and one dgrad and one
    wgrad each."""
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_train_params(torch.Generator().manual_seed(0), "cpu")
    on_card = _to_leaves(params, cuda)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -100
    lc, _ = model.loss(params, {"tokens": toks, "labels": labels})
    lc.backward()
    kernels = (moe_gemm_fwd, moe_gemm_dgrad, moe_gemm_wgrad)
    for fn in kernels:
        _build.reset_counts(fn)
    lg, _ = model.loss(on_card, {"tokens": toks.to(cuda),
                                 "labels": labels.to(cuda)})
    lg.backward()
    torch.cuda.synchronize()
    n = 3 * (cfg.n_layers - cfg.moe.first_k_dense)
    assert [fn.launches for fn in kernels] == [2 * n, n, n]
    assert abs(float(lg.detach()) - float(lc.detach())) <= 1e-5 * float(lc.detach())
    for a, b in zip(tree_leaves(on_card), tree_leaves(params)):
        _rel(a.grad.cpu(), b.grad, 1e-4)


def _moe_step(tc, mesh=None):
    """One training step of ``tc``: (its metrics, the state by key)."""
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.train_loop import Trainer
    tr = Trainer(tc, device="cuda", mesh=mesh)
    log = tr.run(1)
    state = dict(flatten_with_paths(tr.state))
    grads = {k: t.grad for k, t in state.items() if t.grad is not None}
    del tr
    torch.cuda.empty_cache()
    return log[0], state, grads


def _moe_config(tmp_path):
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import TrainerConfig
    return TrainerConfig(
        model=get_config("deepseek-v3-16b").replace(n_layers=2),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                          checkpoint_every=0, checkpoint_dir=str(tmp_path)),
        data=DataConfig(global_batch=2, seq_len=1024))


@pytest.mark.cuda
def test_moe_training_step_gives_the_same_bits_twice(cuda, tmp_path):
    """Full-width deepseek-v3-16b cut to 2 layers (the dense one and a MoE
    one), bf16 compute: two runs of a step from the same seed give the same
    loss, gradients and updated state, bit for bit (no atomics on the
    path: the dispatch's backward gathers, the GEMMs split nothing)."""
    tc = _moe_config(tmp_path)
    a, state_a, grads_a = _moe_step(tc)
    b, state_b, grads_b = _moe_step(tc)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert grads_a.keys() == grads_b.keys() == \
        {k for k in state_a if k.startswith("params/")}
    for key in state_a:
        assert torch.equal(state_a[key], state_b[key]), key
        if key in grads_a:
            assert torch.equal(grads_a[key], grads_b[key]), key


@pytest.mark.cuda
def test_fsdp_world1_moe_step_equals_unsharded_step(cuda, monkeypatch,
                                                    tmp_path):
    """The MoE step of ``test_moe_training_step_gives_the_same_bits_twice``
    through the FSDP path over an NCCL group of one: at world 1 the MoE
    layers route as one device and the collectives copy, so loss, norm and
    state equal the unsharded step's bit for bit."""
    import socket

    from repro_torch.parallel.mesh import make_host_mesh
    tc = _moe_config(tmp_path)
    want, plain, _ = _moe_step(tc)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        got, sharded, _ = _moe_step(tc, make_host_mesh())
    finally:
        torch.distributed.destroy_process_group()
    for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
        assert got[k] == want[k], k
    assert sharded.keys() == plain.keys()
    for key, b in plain.items():
        assert torch.equal(sharded[key], b), key


@pytest.mark.cuda
def test_fsdp_world1_step_equals_unsharded_step(cuda, monkeypatch, tmp_path):
    """One training step of full-width llama3.1-8b cut to 2 layers (bf16
    compute), through the FSDP path over an NCCL group of one and through
    the unsharded trainer, from the same seed and batch: the same loss,
    gradient norm and updated state.  At world 1 the gathers and
    reduce-scatters copy, and the loss, the norm and AdamW take the same
    sums in the same order, so the two agree to 1e-6 of each value (of
    each leaf's largest magnitude)."""
    import socket

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    tc = TrainerConfig(
        model=get_config("llama3.1-8b").replace(n_layers=2),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                          checkpoint_every=0, checkpoint_dir=str(tmp_path)),
        data=DataConfig(global_batch=2, seq_len=1024))

    def one_step(mesh):
        tr = Trainer(tc, device="cuda", mesh=mesh)
        log = tr.run(1)
        state = dict(flatten_with_paths(tr.state))
        for t in state.values():
            t.grad = None
        del tr
        torch.cuda.empty_cache()
        return log[0], state

    want, plain = one_step(None)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        got, sharded = one_step(make_host_mesh())
    finally:
        torch.distributed.destroy_process_group()
    for k in ("loss", "ce_loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    assert sharded.keys() == plain.keys()
    with torch.no_grad():
        for key, b in plain.items():
            err = float((sharded[key].float() - b.float()).abs().max())
            assert err <= 1e-6 * max(float(b.float().abs().max()), 1.0), key


# --------------------------------------------------------------------------- #
# Tensor, sequence and expert parallelism over "model" (NCCL)
# --------------------------------------------------------------------------- #
# fp32 compute on the card: the model group's sums run in another order
# than one device's, as on the CPU (tests/test_torch_tensor_parallel.py),
# so each step's loss and norm within the JAX package's fp32 tolerance
TP_TOL = 2e-5


def _tp_config(tmp_path, arch):
    import dataclasses

    from repro_torch.configs import TrainConfig
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import TrainerConfig
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    if cfg.moe is not None:                       # tokens dropped
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    return TrainerConfig(
        model=cfg,
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=1e9, checkpoint_every=0,
                          checkpoint_dir=str(tmp_path)),
        data=DataConfig(global_batch=4, seq_len=64))


def _tp_worker(rank, world, port, configs, out):
    """One rank over NCCL: each config's 3 steps on the (1, world) mesh."""
    import os

    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.train.train_loop import Trainer
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    mesh = make_host_mesh(model_parallel=world)
    logs = {}
    try:
        for name, tc in configs.items():
            logs[name] = Trainer(tc, device="cuda", mesh=mesh).run(3)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(logs, out)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_tp_world2_matches_single_process(cuda, tmp_path):
    """Reduced fp32 llama3.1-8b and deepseek-v3-16b (expert parallel,
    tokens dropped) on the (1, 2) mesh over two cards (NCCL, sequence
    parallel): each step's loss, CE, aux and gradient norm equal the
    single-process trainer's within TP_TOL."""
    import torch.multiprocessing as mp

    from repro_torch.train.train_loop import Trainer
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL puts no two ranks of one "
                    "communicator on one card")
    configs = {arch: _tp_config(tmp_path / arch, arch)
               for arch in ("llama3.1-8b", "deepseek-v3-16b")}
    mp.start_processes(_tp_worker, args=(2, _free_port(), configs,
                                         str(tmp_path / "tp.pt")),
                       nprocs=2, start_method="spawn")
    got = torch.load(tmp_path / "tp.pt")
    for arch, tc in configs.items():
        want = Trainer(tc, device="cuda").run(3)
        for i, (g, w) in enumerate(zip(got[arch], want)):
            for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= TP_TOL * max(1.0, abs(w[k])), \
                    f"{arch} step {i} {k}: {g[k]} vs {w[k]}"


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [True, False])
def test_tp_world1_mesh_runs_no_model_collective(cuda, monkeypatch,
                                                 tmp_path, sp):
    """At world 1 the 2-D code on the (1, 1) mesh (make_host_mesh with
    model_parallel=1, sequence parallelism on or off) makes no
    ``TensorParallel``, splits no leaf over ``model``, and its step equals
    the unsharded trainer's to 1e-6 (as the FSDP world-1 step above)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.train.train_loop import Trainer
    tc = _tp_config(tmp_path, "llama3.1-8b")
    tc.parallel = ParallelConfig(sequence_parallel=sp)
    want = Trainer(tc, device="cuda").run(2)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        tr = Trainer(tc, device="cuda",
                     mesh=make_host_mesh(model_parallel=1))
        got = tr.run(2)
        assert tr.fsdp.tp is None and tr.fsdp.model_size == 1
        assert all(p.mdim < 0 for p in tree_leaves(tr.fsdp.placements))
    finally:
        torch.distributed.destroy_process_group()
    for g, w in zip(got, want):
        for k in ("loss", "ce_loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), k


@pytest.mark.cuda
def test_tp_mesh_without_a_card_per_rank_raises(cuda, monkeypatch):
    """A rank with no card of its own, and a world the model axis does not
    divide, raise before any group is made: no fallback to gloo."""
    from repro_torch.parallel.mesh import make_host_mesh
    n = torch.cuda.device_count()
    for k, v in dict(RANK=str(n), WORLD_SIZE=str(n + 1), LOCAL_RANK=str(n),
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=f"local rank {n} needs card {n}"):
        make_host_mesh(model_parallel=n + 1)
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide the world of 3"):
        make_host_mesh(model_parallel=2)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------- #
# FSDP's overlap over an NCCL group of one
# --------------------------------------------------------------------------- #
def _world1_arms(monkeypatch, tc, arms, steps=2):
    """``tc`` through FSDP over an NCCL group of one, once per arm (gather
    ahead or in place): [(metrics, state by key, gathers-ahead counts)],
    the states kept on the card."""
    from repro_torch.parallel.fsdp import FSDP
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.train_loop import Trainer
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    out = []
    try:
        mesh = make_host_mesh()
        for prefetch in arms:
            tr = Trainer(tc, device="cuda", mesh=mesh)
            tr.fsdp = FSDP(tr.model, mesh, tc.parallel, "cuda",
                           prefetch=prefetch)
            log = tr.run(steps)
            state = {k: v.detach() for k, v in flatten_with_paths(tr.state)}
            out.append((log, state, dict(tr.fsdp.prefetch_stats)))
            del tr
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    return out


def _assert_same_arms(ahead, in_place, layers):
    (log_a, state_a, stats_a), (log_b, state_b, stats_b) = ahead, in_place
    assert log_a == log_b
    assert state_a.keys() == state_b.keys()
    for key, a in state_a.items():
        assert torch.equal(a, state_b[key]), key
    assert stats_a == {"layers": 2 * (layers - 1), "most_ahead": 1}
    assert stats_b == {"layers": 0, "most_ahead": 0}


def _full_width(arch, layers, tmp_path):
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import TrainerConfig
    return TrainerConfig(
        model=get_config(arch).replace(n_layers=layers),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                          checkpoint_every=0, checkpoint_dir=str(tmp_path)),
        data=DataConfig(global_batch=2, seq_len=1024))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.1-8b", "deepseek-v3-16b"])
def test_fsdp_world1_prefetch_equals_gathering_in_place(cuda, monkeypatch,
                                                       tmp_path, arch):
    """Full width cut to 2 layers (deepseek: the dense one and a MoE one),
    bf16 compute, 2 steps over an NCCL group of one: with each layer's
    gathers issued a layer ahead and its reduce-scatters left in flight
    (on the parameter group's stream, a copy at world 1), the metrics and
    the whole state equal gathering in place bit for bit."""
    tc = _full_width(arch, 2, tmp_path)
    _assert_same_arms(*_world1_arms(monkeypatch, tc, (True, False)), 2)


@pytest.mark.cuda
def test_fsdp_world1_prefetch_survives_memory_churn(cuda, monkeypatch,
                                                    tmp_path):
    """The prefetch path under late collectives and memory churn: every
    gather and reduce-scatter is issued from a side stream that first
    spins ~1 ms (NCCL's stream waits for the stream it is issued from, so
    the collective lands late while the compute stream runs on), and right
    after each, blocks of every gathered leaf's and reduced gradient's size
    are allocated on the compute stream and filled with NaN.  A result
    read before its wait, or a buffer handed back to the allocator before
    its collective is done, meets NaN or unwritten memory; held and waited
    for as they must be, the step equals gathering in place (no churn) bit
    for bit."""
    from repro_torch.parallel import fsdp as fsdp_mod
    spin = 2_000_000                  # GPU clock cycles, ~1 ms
    side = torch.cuda.Stream()

    def late(collective, big):
        def issue(x, dim, group, async_op=False):
            here = torch.cuda.current_stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                torch.cuda._sleep(spin)
                out = collective(x, dim, group, async_op=async_op)
            if not async_op:          # the caller waits for nothing else
                here.wait_stream(side)
            junk = [torch.full_like(x, float("nan")) for _ in range(big)]
            del junk
            return out
        return issue
    tc = _full_width("llama3.1-8b", 3, tmp_path)
    in_place = _world1_arms(monkeypatch, tc, (False,))[0]
    monkeypatch.setattr(fsdp_mod, "all_gather_dim",
                        late(fsdp_mod.all_gather_dim, 2))
    monkeypatch.setattr(fsdp_mod, "reduce_scatter_dim",
                        late(fsdp_mod.reduce_scatter_dim, 1))
    ahead = _world1_arms(monkeypatch, tc, (True,))[0]
    _assert_same_arms(ahead, in_place, 3)
