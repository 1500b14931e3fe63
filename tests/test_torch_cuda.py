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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
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
    backward kernels against the plain backward from the same (o, lse), and
    against autograd of the plain forward in fp32 (bf16: P rounds to bf16
    before dV in both, the inputs are the same bf16 values)."""
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
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
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
    """The grouped GEMM and WKV6 kernels have no backward: with a gradient
    needed they raise instead of returning a detached output; without one
    (inference) they run."""
    x = torch.randn(2, 8, 16, device=cuda)
    w = torch.randn(2, 16, 4, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        moe_ops.moe_gemm(x, w)
    with torch.no_grad():
        assert moe_ops.moe_gemm(x, w).shape == (2, 8, 4)
    r, k, v, wl, u, s0 = _wkv_inputs(cuda, 1, 4, 2, 16, torch.float32, True)
    u.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        wkv_ops.wkv6(r, k, v, wl, u, s0)
    with torch.inference_mode():
        assert wkv_ops.wkv6(r, k, v, wl, u, s0)[0].shape == r.shape


def _to_leaves(tree, device):
    """A copy of a parameter tree on ``device``, each leaf a new autograd
    leaf."""
    if isinstance(tree, dict):
        return {k: _to_leaves(v, device) for k, v in tree.items()}
    return tree.detach().to(device).requires_grad_()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen3-4b"])
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
    L, norms = cfg.n_layers, 4 if cfg.qk_norm else 2
    assert [fn.launches for fn in kernels] == \
        [2 * L, L, 2 * norms * L + 1, norms * L + 1]
    assert abs(float(lg.detach()) - float(lc.detach())) <= 1e-5 * float(lc.detach())
    for a, b in zip(tree_leaves(on_card), tree_leaves(params)):
        _rel(a.grad.cpu(), b.grad, 1e-4)
