"""The SSD chunk scan's backward on the CPU: the backward kernel's plain
version ``ssd_scan_backward_plain`` against ``jax.vjp`` of the reference's
``repro.models.ssm.ssd_chunked`` and against ``torch.autograd`` through
``ssd_scan_plain``; the scan's autograd Function ``SSDScan`` through
``ops.ssd_scan`` and the Mamba-2 block against ``jax.grad`` of the
reference's block; and the hybrid model's loss going through it.

Tolerances: every gradient within 1e-5 of its largest value. The port sums
the same f32 products in other orders than the reference, and at chunk
length 64 where the reference may run 128 (the two chunkings are the same
function; measured at most 1.5e-6 here, chunk 128 included). The block's
gradient leaves: 1e-4 relative L2, as ``tests/test_torch_loss.py`` holds
f32 leaves.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_ssm import KW, as_np, block_params, to_torch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SSDScan,
    ssd_scan,
    ssd_scan_backward,
    ssd_scan_backward_plain,
    ssd_scan_plain,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

TOL = 1e-5
BLOCK_REL = 1e-4

VJP_CASES = [
    # (B, L, H, P, N, the reference's chunk): chunk 64 is the port's own
    # chunking; 128 the reference's default; L = 32 one short chunk
    (2, 128, 4, 32, 16, 64),
    (1, 256, 2, 64, 64, 64),
    (1, 256, 2, 64, 64, 128),
    (2, 192, 3, 16, 32, 64),
    (1, 32, 2, 8, 16, 32),
]


def draws(seed, B, L, H, P, N):
    """x, dt in [0.01, 0.2], A in -[0.5, 2], B, C, and the cotangents of y
    and of the final state, as numpy f32 (model layout)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(B, L, H, P)).astype(f32), rng.uniform(0.01, 0.2, (B, L, H)).astype(f32),
            -rng.uniform(0.5, 2.0, (H,)).astype(f32), rng.normal(size=(B, L, N)).astype(f32),
            rng.normal(size=(B, L, N)).astype(f32), rng.normal(size=(B, L, H, P)).astype(f32),
            rng.normal(size=(B, H, P, N)).astype(f32))


def folded(x, dt, a):
    """The kernel's inputs: x·dt and A·dt, head-major."""
    return ((x * dt[..., None]).transpose(1, 2).contiguous(),
            (a * dt).transpose(1, 2).contiguous())


def close(got, want, what):
    want = as_np(want)
    err = np.abs(as_np(got) - want).max()
    assert err <= TOL * np.abs(want).max(), f"{what}: {err} of {np.abs(want).max()}"


@pytest.mark.parametrize("case", VJP_CASES)
def test_plain_backward_matches_reference_vjp(case):
    """dx, dlog_a, dB and dC with a nonzero final-state cotangent, carried
    through the fold (x·dt, A·dt) onto the reference's x, dt, A, B and C."""
    B, L, H, P, N, chunk = case
    x, dt, a, bm, cm, dy, ds = draws(3, B, L, H, P, N)

    def ref(x, dt, a, b, c):
        return jssm.ssd_chunked(x, dt, a, b[:, :, None], c[:, :, None], chunk=chunk)

    _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    gx, gdt, ga, gb, gc = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    tx, tdt, ta, tb, tc, tdy, tds = (torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy, ds))
    xh, log_a = folded(tx, tdt, ta)
    states = ssd_scan_plain(xh, log_a, tb, tc, return_states=True)[2]
    dxh, dla, db, dc = ssd_scan_backward_plain(xh, log_a, tb, tc,
                                               tdy.transpose(1, 2).contiguous(), tds, states)
    dxh, dla = dxh.transpose(1, 2), dla.transpose(1, 2)
    close(dxh * tdt[..., None], gx, "dx")
    close((dxh * tx).sum(-1) + dla * ta, gdt, "ddt")
    close((dla * tdt).sum((0, 1)), ga, "dA")
    close(db, gb, "dB")
    close(dc, gc, "dC")


@pytest.mark.parametrize("length", [50, 200, 30, 1])
@pytest.mark.parametrize("final", [True, False], ids=["ds_final", "no_ds_final"])
def test_plain_backward_matches_autograd_through_plain_scan(length, final):
    """At ragged lengths (the tail chunk padded) and below one chunk: the
    plain backward, with the forward's chunk states, against autograd
    through ``ssd_scan_plain``."""
    x, dt, a, bm, cm, dy, ds = draws(4, 2, length, 3, 16, 8)
    tx, tdt, ta, tb, tc, tdy, tds = (torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy, ds))
    xh, log_a = folded(tx, tdt, ta)
    dyh = tdy.transpose(1, 2).contiguous()
    ds_final = tds if final else None
    args = [t.clone().requires_grad_() for t in (xh, log_a, tb, tc)]
    y, s = ssd_scan_plain(*args)
    loss = (y * dyh).sum() + ((s * tds).sum() if final else 0.0)
    want = torch.autograd.grad(loss, args)
    _, _, states = ssd_scan_plain(xh, log_a, tb, tc, return_states=True)
    assert states.shape == (2, 3, -(-length // 64), 16, 8)
    got = ssd_scan_backward_plain(xh, log_a, tb, tc, dyh, ds_final, states)
    for name, g, w in zip(("dx", "dlog_a", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        close(g, w, name)


def test_autograd_function_on_cpu_runs_the_plain_versions():
    """``ssd_scan`` under grad goes through ``SSDScan``: its output equals
    the plain forward's, its gradient the plain backward's, and no kernel
    is launched; without grad it returns plain tensors."""
    x, dt, a, bm, cm, dy, ds = draws(5, 1, 100, 2, 8, 4)
    tx, tdt, ta, tb, tc, tdy, tds = (torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy, ds))
    xh, log_a = folded(tx, tdt, ta)
    dyh = tdy.transpose(1, 2).contiguous()
    args = [t.clone().requires_grad_() for t in (xh, log_a, tb, tc)]
    before = (ssd_scan.launches, ssd_scan_backward.launches)
    y, s = ssd_scan(*args)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    grads = torch.autograd.grad((y * dyh).sum() + (s * tds).sum(), args)
    assert (ssd_scan.launches, ssd_scan_backward.launches) == before
    y0, s0 = ssd_scan_plain(xh, log_a, tb, tc)
    assert torch.equal(y.detach(), y0) and torch.equal(s.detach(), s0)
    states = ssd_scan_plain(xh, log_a, tb, tc, return_states=True)[2]
    for g, w in zip(grads, ssd_scan_backward_plain(xh, log_a, tb, tc, dyh, tds, states)):
        assert torch.equal(g, w)
    y1, _ = ssd_scan(xh, log_a, tb, tc)
    assert y1.grad_fn is None and torch.equal(y1, y0)
    with pytest.raises(ValueError, match="return_states"):
        ssd_scan(*args, return_states=True)


def test_only_the_state_output_needs_a_gradient():
    """A loss on the final state alone (y unused) and on y alone (the final
    state unused) both reach the inputs through ``SSDScan``."""
    x, dt, a, bm, cm, dy, ds = draws(6, 1, 70, 2, 8, 4)
    tx, tdt, ta, tb, tc, tdy, tds = (torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy, ds))
    xh, log_a = folded(tx, tdt, ta)
    zero_dy = torch.zeros_like(xh)
    args = [t.clone().requires_grad_() for t in (xh, log_a, tb, tc)]
    _, s = SSDScan.apply(*args)
    got = torch.autograd.grad((s * tds).sum(), args)
    states = ssd_scan_plain(xh, log_a, tb, tc, return_states=True)[2]
    for g, w in zip(got, ssd_scan_backward_plain(xh, log_a, tb, tc, zero_dy, tds, states)):
        assert torch.equal(g, w)
    y, _ = SSDScan.apply(*args)
    dyh = tdy.transpose(1, 2).contiguous()
    got = torch.autograd.grad((y * dyh).sum(), args)
    for g, w in zip(got, ssd_scan_backward_plain(xh, log_a, tb, tc, dyh, None, states)):
        assert torch.equal(g, w)


def test_ops_ssd_scan_gradient_matches_reference():
    """``ops.ssd_scan`` in the model layout under autograd (the fold and
    ``log_a = A·dt`` by autograd, the scan through ``SSDScan``) against
    ``jax.vjp`` of ``ssd_chunked``: the gradients of x, dt, A, B and C."""
    B, L, H, P, N = 2, 128, 3, 16, 8
    x, dt, a, bm, cm, dy, ds = draws(7, B, L, H, P, N)

    def ref(x, dt, a, b, c):
        return jssm.ssd_chunked(x, dt, a, b[:, :, None], c[:, :, None], chunk=64)

    _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    args = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, bm, cm)]
    y, s = ops.ssd_scan(*args)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(),
                              args)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        close(g, w, name)


def test_mamba2_block_gradient_matches_reference():
    """The port's Mamba-2 block under autograd, its scan through
    ``SSDScan`` and the plain backward (counted), against ``jax.grad`` of
    the reference's block: the input's gradient and every parameter's, with
    cotangents on the output and on the block's final SSD state."""
    jp, tp = block_params(jnp.float32)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    cot = rng.normal(size=(2, 64, 64)).astype(np.float32)
    cot_s = rng.normal(size=(2, KW["n_heads"], KW["head_dim"], KW["d_state"])).astype(np.float32)

    def ref_loss(p, x):
        out, st = jssm.mamba2_block(x, p, **KW)
        return jnp.sum(out * cot) + jnp.sum(st["ssd"] * cot_s)

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = sorted(tp)
    for k in names:
        tp[k].requires_grad_(True)
    tx = to_torch(x).requires_grad_()
    with mock.patch.object(ssd_mod, "ssd_scan_backward_plain",
                           wraps=ssd_mod.ssd_scan_backward_plain) as spy:
        out, st = tssm.mamba2_block(tx, tp, **KW)
        loss = (out * to_torch(cot)).sum() + (st["ssd"] * to_torch(cot_s)).sum()
        grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in names])
    assert spy.call_count == 1
    for name, g, w in zip(["x"] + names, grads, [gx] + [gp[k] for k in names]):
        got, want = as_np(g), as_np(w)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= BLOCK_REL, f"{name}: rel L2 {err}"


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hybrid_loss_goes_through_the_ssd_backward(remat):
    """Reduced zamba2's ``Model.loss`` on the CPU runs every Mamba-2 block's
    scan through ``SSDScan``: one plain backward a block, and, under remat
    ``full``, two forwards a block (the forward and its recompute), as the
    card's launch counts are gated; the gradients equal remat ``none``'s."""
    cfg = get_config("zamba2-2.7b").reduced()
    blocks = cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (1, 64)))
    batch = {"tokens": tokens, "labels": tokens}
    model = Model(cfg, remat=remat)
    params = model.init(0, device="cpu")
    p_leaves = leaves(params)
    for p in p_leaves:
        p.requires_grad_(True)
    with mock.patch.object(ssd_mod, "ssd_scan_backward_plain",
                           wraps=ssd_mod.ssd_scan_backward_plain) as bwd, \
            mock.patch.object(ssd_mod, "ssd_scan_plain", wraps=ssd_mod.ssd_scan_plain) as fwd:
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, p_leaves)
    assert bwd.call_count == blocks
    assert fwd.call_count == (2 if remat == "full" else 1) * blocks
    assert all(torch.isfinite(g).all() for g in grads)
