"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (``cuda`` marker) and skips without one;
the file imports no JAX, so it runs on a machine that has none:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5, bf16 2e-2 (the JAX package's kernel tolerances;
the grouped GEMM's atol grows with its depth d as sqrt(d)); the WKV6
recurrence 5e-4 fp32, 5e-2 bf16 (the JAX package's WKV tolerances), plus
one bf16 step (2**-7 relative) on a bf16 y: both sides round the same fp32
sum once, and a sum on a rounding boundary lands one step apart, which
exceeds 5e-2 where |y| >= 8.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
from repro_torch.models import build_model

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 128), (2, 100, 256), (3, 4096),
                                   (5, 2560), (2, 3, 1500)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, wdtype, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, r = (torch.randn(shape, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    w = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype)
    _close(rmsnorm_fwd(x, w), rmsnorm_ref(x, w), TOL[dtype])
    y, res = rmsnorm_fwd(x, w, r)
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
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 130, 512])
def test_wkv6_kernel_matches_plain(cuda, S, dtype, D, state):
    """One token (decode), ragged S (a partial last chunk), the serving
    prompt; from zero or from a given state."""
    args = _wkv_inputs(cuda, 2, S, 3, D, dtype, state)
    s_in = None if args[5] is None else args[5].clone()
    y, st = wkv6_fwd(*args)
    y_ref, st_ref = wkv6_ref(*args)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol, rtol = (5e-4, 0) if dtype == torch.float32 else (5e-2, 2 ** -7)
    _close(y, y_ref, rtol, atol=tol)
    _close(st, st_ref, 0, atol=tol)
    if s_in is not None:                     # the given state is not written
        assert torch.equal(args[5], s_in)


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
