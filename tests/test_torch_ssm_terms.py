"""The ssm_terms op (the selective scan's a and b, ``kernels/ssm_terms``):
its plain version against the expression it replaced and the JAX package,
its fake and autograd formula, the wrapper's checks and the benchmark's
reader of its roofline share on the CPU; the CUDA kernel against the plain
version on the card.

The card's tests need no JAX (the one JAX comparison imports it inside the
test), so this file also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_ssm_terms.py
"""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.ssm_terms import ssm_terms, ssm_terms_plain
from repro_torch.kernels.ssm_terms.ops import STATES, _run_cuda, _terms_op
from repro_torch.models import ssm as tssm

ROOT = Path(__file__).resolve().parents[1]
#: the kernel against the plain version on the card, in units in the last place
#: of fp32 (a and b)
MAX_ULP = 0
# (B, S, di, n, dt_rank, dtype): falcon-mamba-7b's chunk, a ragged last chunk,
# a decode step, a tensor-parallel rank's share at B = 2, then the reduced
# presets' state size, fp32 inputs and channel counts that leave warps part empty
CARD_ROWS = [
    (1, 256, 8192, 16, 256, torch.bfloat16),
    (1, 203, 8192, 16, 256, torch.bfloat16),
    (1, 1, 8192, 16, 256, torch.bfloat16),
    (2, 37, 4096, 16, 256, torch.bfloat16),
    (1, 64, 1024, 16, 64, torch.float32),
    (2, 19, 100, 4, 4, torch.bfloat16),
    (3, 40, 72, 4, 5, torch.float32),
    (1, 33, 200, 16, 8, torch.bfloat16),
]


def _inputs(B, S, di, n, r, dtype, device="cpu", seed=0):
    """raw dt, dt_bias, A_log, x in the conv's (B, di, S) memory layout and B
    as a strided view of a (B, S, r + 2n) projection, as ``_selective_terms``
    hands them over (``_contiguous`` for the other layout). raw spans both
    sides of softplus's threshold and dt from ~1e-9 up."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((B, S, di), generator=g) * 4
    raw.view(-1)[::97] = 25.0
    raw.view(-1)[1::89] = -20.0
    dt = torch.exp(torch.rand(di, generator=g) * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)) \
        + 0.1 * torch.randn((di, n), generator=g)
    x = torch.randn((B, di, S), generator=g).transpose(1, 2)
    proj = torch.randn((B, S, r + 2 * n), generator=g)
    cast = lambda t: t.to(dtype).to(device)   # noqa: E731
    proj = cast(proj)
    return (cast(raw), dt_bias.to(device), A_log.to(device), cast(x),
            proj.split([r, n, n], dim=-1)[1])


def _contiguous(args):
    return [t.contiguous() for t in args]


def _expression(raw, dt_bias, A_log, x, B):
    """``_selective_terms``'s body before the op, verbatim."""
    dt = F.softplus(raw.float() + dt_bias)
    A = -torch.exp(A_log)
    a = torch.exp(dt[..., None] * A)
    b = (dt * x.float())[..., None] * B.float()[:, :, None, :]
    return a, b


def _ulp(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest distance between two fp32 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(x) - ordered(y)).abs().max()) if x.numel() else 0


@pytest.mark.parametrize("layout", ["model", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,di,n,r", [(1, 9, 12, 4, 3), (2, 5, 33, 16, 6)])
def test_plain_version_equals_the_expression_bitwise(B, S, di, n, r, dtype, layout):
    args = _inputs(B, S, di, n, r, dtype)
    assert not (args[3].is_contiguous() or args[4].is_contiguous())
    if layout == "contiguous":
        args = _contiguous(args)
    want = _expression(*args)
    for got in (ssm_terms_plain(*args), ssm_terms(*args)):
        assert all(g.dtype == torch.float32 for g in got)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_route_runs_the_plain_version_and_counts_no_launch():
    before = ssm_terms.launches
    ssm_terms(*_inputs(1, 4, 8, 4, 2, torch.bfloat16))
    assert ssm_terms.launches == before


def test_selective_terms_match_the_jax_package():
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models import ssm as jssm

    cfg, jcfg = get_reduced("falcon_mamba_7b"), jax_reduced("falcon_mamba_7b")
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    rng = np.random.default_rng(3)
    params = {
        "x_proj": rng.standard_normal((di, r + 2 * n)) / np.sqrt(di),
        "dt_proj": rng.standard_normal((r, di)) / np.sqrt(r),
        "dt_bias": rng.uniform(-7.0, -2.0, di),
        "A_log": np.log(np.tile(np.arange(1, n + 1), (di, 1))) + rng.normal(0, 0.1, (di, n)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x_conv = rng.standard_normal((2, 11, di)).astype(np.float32)
    want = jssm._selective_terms({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(x_conv), jcfg)
    got = tssm._selective_terms({k: torch.from_numpy(v) for k, v in params.items()},
                                torch.from_numpy(x_conv), cfg)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max())


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, torch.float32),
                                        (torch.float32, torch.float32),
                                        (torch.float64, torch.float64)])
def test_fake_gives_shapes_and_dtypes(dtype, want):
    from torch._subclasses.fake_tensor import FakeTensorMode
    raw, dt_bias, A_log, x, B = _inputs(2, 7, 24, 8, 3, torch.float32)
    raw, x, B = (t.to(dtype) for t in (raw, x, B))
    if dtype == torch.float64:
        dt_bias, A_log = dt_bias.double(), A_log.double()
    outs = [ssm_terms(*(t.to("meta") for t in (raw, dt_bias, A_log, x, B)))]
    with FakeTensorMode() as mode:
        outs.append(_terms_op(*(mode.from_tensor(t) for t in (raw, dt_bias, A_log, x, B))))
    for a, b in outs:
        assert a.shape == b.shape == (2, 7, 24, 8)
        assert a.dtype == b.dtype == want


@pytest.mark.parametrize("B,S,di,n,r", [(1, 3, 5, 4, 2), (2, 4, 3, 8, 3)])
def test_autograd_formula_passes_gradcheck_in_float64(B, S, di, n, r):
    raw, dt_bias, A_log, x, _ = _inputs(B, S, di, n, r, torch.float64)
    raw = raw / 4                          # clear of softplus's kink at the threshold
    raw.view(-1)[0] = 40.0                 # one past it, where d dt / d raw is 1
    dt_bias, A_log = dt_bias.double(), A_log.double()
    proj = torch.randn((B, S, r + 2 * n), dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (raw, dt_bias, A_log, x, proj)]

    def fn(raw, dt_bias, A_log, x, proj):
        return _terms_op(raw, dt_bias, A_log, x, proj[..., r:r + n])
    assert torch.autograd.gradcheck(fn, leaves)


@pytest.mark.parametrize("used", ["a", "b", "both"])
def test_autograd_formula_equals_autograd_of_the_expression(used):
    args = _inputs(2, 6, 16, 4, 3, torch.float32, seed=4)
    args = [t.detach().clone().requires_grad_() for t in args[:4]] + [args[4]]
    proj_b = args[4].detach().clone().requires_grad_()
    grads = []
    for fn in (_expression, _terms_op):
        a, b = fn(*args[:4], proj_b)
        g = torch.Generator().manual_seed(5)
        loss = {"a": (a * torch.randn(a.shape, generator=g)).sum(),
                "b": (b * torch.randn(b.shape, generator=g)).sum()}
        total = loss["a"] + loss["b"] if used == "both" else loss[used]
        grads.append(torch.autograd.grad(total, [*args[:4], proj_b], allow_unused=True))
    for got, want in zip(grads[1], grads[0]):
        want = torch.zeros_like(got) if want is None else want
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("bad", ["x shape", "B shape", "A_log shape", "dtypes", "devices"])
def test_wrapper_rejects_what_the_op_does_not_take(bad):
    raw, dt_bias, A_log, x, B = _inputs(1, 4, 8, 4, 2, torch.bfloat16)
    args = {"x shape": (raw, dt_bias, A_log, x[:, :3], B),
            "B shape": (raw, dt_bias, A_log, x, B[..., :3]),
            "A_log shape": (raw, dt_bias, A_log[:5], x, B),
            "dtypes": (raw, dt_bias, A_log, x.float(), B),
            "devices": (raw, dt_bias, A_log.to("meta"), x, B)}[bad]
    with pytest.raises((ValueError, TypeError)):
        ssm_terms(*args)


@pytest.mark.parametrize("bad", ["float64", "state size", "A_log layout"])
def test_cuda_route_refuses_what_the_kernel_does_not_take(bad):
    """The checks the CUDA route makes before it allocates or launches."""
    raw, dt_bias, A_log, x, B = _inputs(1, 4, 8, 4, 2, torch.bfloat16)
    if bad == "float64":
        raw, x, B = raw.double(), x.double(), B.double()
    elif bad == "state size":
        A_log, B = torch.zeros((8, 5)), torch.zeros((1, 4, 5), dtype=torch.bfloat16)
    else:
        A_log = torch.zeros((4, 8)).t()
    assert 8 not in STATES and 5 not in STATES
    with pytest.raises((ValueError, TypeError)):
        _run_cuda(raw, dt_bias, A_log, x, B)


def _reader():
    spec = importlib.util.spec_from_file_location(
        "ssm_terms_roofline", ROOT / "bench_port" / "metrics" / "ssm_terms_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reader_counts_each_chunk_and_reads_nothing_without_the_kernel():
    from bench_port import devtrace
    mod = _reader()
    config = {"intermediate_size": 64, "state_size": 16, "num_hidden_layers": 3,
              "torch_dtype": "bfloat16"}
    lengths = [600, 100]             # chunks 256, 256, 88 and 100
    invs = [SimpleNamespace(length=L, traced=True, kind="cold") for L in lengths]

    def ctx(trace):
        return SimpleNamespace(config=config, trace=trace,
                               traced=lambda kind=None: invs)
    ops = [("void (anonymous namespace)::ssm_terms_kernel<__nv_bfloat16, 16>", 10.0, 30.0),
           ("diag_recurrence_kernel", 30.0, 90.0),
           ("void (anonymous namespace)::ssm_terms_kernel<__nv_bfloat16, 16>", 100.0, 120.0)]
    moved = 3 * sum(2 * s * 64 * 16 * 4 + 2 * s * 64 * 2 + s * 16 * 2 + 64 * 17 * 4
                    for s in (256, 256, 88, 100))
    assert mod.read(ctx(devtrace.Trace(ops=ops))) == pytest.approx(
        100 * moved / 3.35e12 / 40e-6)
    assert mod.read(ctx(devtrace.Trace(ops=ops[1:2]))) is None
    assert mod.read(ctx(None)) is None
    config.pop("state_size")
    assert mod.read(ctx(devtrace.Trace(ops=ops))) is None


# ---------------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["model", "contiguous"])
@pytest.mark.parametrize("B,S,di,n,r,dtype", CARD_ROWS)
def test_kernel_matches_the_plain_version(B, S, di, n, r, dtype, layout):
    dev = _card()
    args = _inputs(B, S, di, n, r, dtype, dev, seed=S)
    if layout == "contiguous":
        args = _contiguous(args)
    before = ssm_terms.launches
    a, b = ssm_terms(*args)
    want_a, want_b = ssm_terms_plain(*args)
    torch.cuda.synchronize()
    assert ssm_terms.launches == before + 1
    assert a.shape == want_a.shape == (B, S, di, n) and a.is_contiguous()
    assert _ulp(a, want_a) <= MAX_ULP and _ulp(b, want_b) <= MAX_ULP


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_backward_on_the_card_matches_the_plain_version(dtype, tol):
    """Of the largest |gradient| in each tensor: 1e-4 in fp32 (sums in
    another order), 2e-2 for the bf16 leaves (one bf16 rounding apart)."""
    dev = _card()
    r, n = 256, 16
    raw, dt_bias, A_log, x, _ = _inputs(1, 64, 1024, n, r, dtype, dev, seed=7)
    proj = torch.randn((1, 64, r + 2 * n), device=dev).to(dtype)
    grads = []
    for fn in (ssm_terms_plain, ssm_terms):
        leaves = [t.clone().requires_grad_() for t in (raw, dt_bias, A_log, x, proj)]
        a, b = fn(*leaves[:4], leaves[4][..., r:r + n])
        g = torch.Generator(device=dev).manual_seed(8)
        loss = (a * torch.randn(a.shape, generator=g, device=dev)).sum() \
            + (b * torch.randn(b.shape, generator=g, device=dev)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for got, want in zip(grads[1], grads[0]):
        assert got.dtype == want.dtype and got.shape == want.shape
        got, want = got.float(), want.float()
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
def test_launches_per_prompt_through_a_reduced_depth_falcon():
    from repro_torch.models.transformer import forward, init_params
    dev = _card()
    cfg = dataclasses.replace(get_config("falcon_mamba_7b"), n_layers=2)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    L = 600
    tokens = torch.randint(0, cfg.vocab_size, (1, L), device=dev)
    before = ssm_terms.launches
    with torch.no_grad():
        logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert ssm_terms.launches - before == cfg.n_layers * -(-L // 256)
