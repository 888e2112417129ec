"""PyTorch port, the ViT embedder's one-pass residual add and LayerNorm
(``frp_tpu_torch/ops/add_ln_cuda.py``) on the CPU: the plain twin is the
eager ``x + d`` and ``nn.layer_norm`` bit for bit at the four kinds of site a
ViT forward calls it at, in f32 and bf16, at the test ViT's width and
ViT-L's; ``add_ln_f32``, the kernel's own arithmetic, is that LayerNorm
within the sums' order; the wrapper takes CPU tensors to the twin; the
launch checks take what the kernel takes and refuse the rest; a forward
calls it 2 x depth + 1 times. The kernel itself is held on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from frp_tpu_torch.models import nn, vit
from frp_tpu_torch.models.params import convert_params
from frp_tpu_torch.ops import add_ln_cuda

# each site's d and whether it is the last: 1 the pos_embed [T, W] broadcast
# over the batch with block 0's LN1; 2 a proj add with the block's LN2; 3 an
# fc2 add with the next block's LN1; 4 the last fc2 add with the final LN
SITES = ("pos_embed", "proj", "fc2", "last")
WIDTHS = (96, 768)
K, T = 3, 16


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(site, w, dtype, seed=0):
    """x, d and the LN's dict (float32 gamma and beta, as convert_params
    leaves them) of one site at width w."""
    rng = np.random.default_rng(seed + w)
    x = torch.from_numpy(rng.normal(0, 1.0, (K, T, w)).astype(np.float32)).to(dtype)
    shape = (T, w) if site == "pos_embed" else (K, T, w)
    d = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dtype)
    ln = {"gamma": torch.from_numpy(rng.uniform(0.8, 1.2, w).astype(np.float32)),
          "beta": torch.from_numpy(rng.normal(0, 0.2, w).astype(np.float32))}
    return x, d, ln


def _eager(site, x, d, ln):
    """Each site as the eager forward wrote it before the pass."""
    y = x + d
    if site == "last":
        z = nn.layer_norm(ln, y.to(torch.float32), vit.LN_EPS)
        return None, z.reshape(K, T * x.shape[-1]).to(x.dtype)
    return y, nn.layer_norm(ln, y, vit.LN_EPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("site", SITES)
def test_plain_twin_is_the_eager_forward(site, w, dtype):
    x, d, ln = _case(site, w, dtype)
    last = site == "last"
    r, u = add_ln_cuda.add_ln_plain(x, d, ln, vit.LN_EPS, last=last)
    want_r, want_u = _eager(site, x, d, ln)
    assert (r is None) == last
    if not last:
        assert r.dtype == dtype and torch.equal(r, want_r)
    else:
        u = u.reshape(K, T * w)
    assert u.dtype == dtype and torch.equal(u, want_u)


# f32: |LN(r)| up to about 6 times the relative error another order of the
# sums leaves in the statistics, about 2**-20 at 768 elements, with a margin
F32_ATOL = 3 * 6 * 2.0 ** -20


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("site", SITES)
def test_f32_version_is_the_eager_layer_norm(site, w, dtype):
    """``add_ln_f32``, the kernel's arithmetic that the card holds it to bit
    for bit, against the eager twin: r equal; LN(r) within ``F32_ATOL`` (the
    sums' order), and in bf16 within one rounding more."""
    x, d, ln = _case(site, w, dtype)
    last = site == "last"
    r, u = add_ln_cuda.add_ln_f32(x, d, ln, vit.LN_EPS, last=last)
    want_r, want_u = add_ln_cuda.add_ln_plain(x, d, ln, vit.LN_EPS, last=last)
    assert (r is None) == last and (last or torch.equal(r, want_r))
    assert u.dtype == dtype and u.shape == x.shape
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(u.float(), want_u.float(), rtol=rtol, atol=F32_ATOL)


@pytest.mark.parametrize("site", SITES)
def test_the_wrapper_takes_cpu_tensors_to_the_twin(site):
    x, d, ln = _case(site, 96, torch.bfloat16)
    before = add_ln_cuda.KERNEL.launches
    got = add_ln_cuda.add_ln(x, d, ln, vit.LN_EPS, last=site == "last")
    want = add_ln_cuda.add_ln_plain(x, d, ln, vit.LN_EPS, last=site == "last")
    assert add_ln_cuda.KERNEL.launches == before
    for g, v in zip(got, want):
        assert (g is None and v is None) or torch.equal(g, v)


def _params(x, last=False):
    dtype = torch.float32 if last else x.dtype
    w = x.shape[-1]
    return torch.ones(w, dtype=dtype), torch.zeros(w, dtype=dtype)


@pytest.mark.parametrize("w", WIDTHS + (8, 1024))
@pytest.mark.parametrize("site", SITES)
def test_launch_checks_take_what_the_kernel_takes(site, w):
    """At every site, in bf16 and f32, at the ViT widths and the widths at
    the kernel's ends (one vector, 32 elements a lane): the checks pass and
    give d's rows, T for the broadcast pos_embed and K x T otherwise."""
    for dtype in (torch.bfloat16, torch.float32):
        x, d, _ = _case(site, w, dtype)
        gamma, beta = _params(x, site == "last")
        assert add_ln_cuda.operands(x, d, gamma, beta) == (T if site == "pos_embed" else K * T)


def test_launch_checks_refuse_what_the_kernel_cannot_take():
    """Before any launch: a dtype the kernel has no lanes for, an input that
    is not contiguous, a d whose shape is neither x's nor its trailing axes,
    d of another dtype, a width that is no whole number of 16-byte vectors
    or is above MAX_WIDTH, gamma or beta of another width or a third dtype,
    an input that autograd would record, and a CPU tensor at the launch."""
    x, d, _ = _case("proj", 96, torch.bfloat16)
    gamma, beta = _params(x)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="f32 or bf16"):
            add_ln_cuda.operands(x.to(dtype), d.to(dtype), gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        add_ln_cuda.operands(x.transpose(0, 1), d, gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        add_ln_cuda.operands(x, d.transpose(0, 1), gamma, beta)
    for bad in (d[:2], d[:, :8], d[0, :8], torch.cat([d, d], 2)):
        with pytest.raises(ValueError, match="trailing axes"):
            add_ln_cuda.operands(x, bad.contiguous(), gamma, beta)
    with pytest.raises(ValueError, match="d is torch.float32"):
        add_ln_cuda.operands(x, d.float(), gamma, beta)
    for w in (12, 1032):
        xw, dw, _ = _case("proj", w, torch.bfloat16)
        with pytest.raises(ValueError, match=f"width {w}"):
            add_ln_cuda.operands(xw, dw, *_params(xw))
    with pytest.raises(ValueError, match="width 6 is not a multiple of 4"):
        add_ln_cuda.operands(x[..., :6].float().contiguous(), d[..., :6].float().contiguous(),
                             gamma[:6].float(), beta[:6].float())
    with pytest.raises(ValueError, match="gamma"):
        add_ln_cuda.operands(x, d, gamma[:48], beta)
    with pytest.raises(ValueError, match="beta"):
        add_ln_cuda.operands(x, d, gamma, beta.half())
    with pytest.raises(ValueError, match="gamma is torch.float32, beta"):
        add_ln_cuda.operands(x, d, gamma.float(), beta)
    with pytest.raises(ValueError, match="gamma"):
        add_ln_cuda.operands(x.float(), d.float(), gamma, beta)
    with pytest.raises(ValueError, match="no backward"):
        add_ln_cuda.operands(x, d.clone().requires_grad_(True), gamma, beta)
    with torch.no_grad():
        assert add_ln_cuda.operands(x, d.clone().requires_grad_(True), gamma, beta) == K * T
    with pytest.raises(ValueError, match="CUDA"):
        add_ln_cuda.add_ln(x.to("meta"), d.to("meta"), {"gamma": gamma, "beta": beta}, 1e-5)


def test_a_forward_calls_the_pass_at_each_site(monkeypatch):
    """A ViT forward of depth 3 calls ``add_ln`` 2 x 3 + 1 = 7 times: the
    pos_embed with block 0's LN1, then each block's proj add with its LN2
    and fc2 add with the next LN1, the last with the final LN alone."""
    params = convert_params(vit.init_vit(0, embed_dim=16, width=96, depth=3, mlp=192))
    seen = []
    real = add_ln_cuda.add_ln

    def counted(x, d, ln, eps, last=False):
        seen.append((tuple(d.shape), ln is params["norm"], last))
        return real(x, d, ln, eps, last)

    monkeypatch.setattr(add_ln_cuda, "add_ln", counted)
    x = torch.zeros(2, 112, 112, 3)
    assert vit.vit_forward(params, x, heads=2).shape == (2, 16)
    full = (2, 144, 96)
    assert seen == [((144, 96), False, False)] + [(full, False, False)] * 5 + [(full, True, True)]
