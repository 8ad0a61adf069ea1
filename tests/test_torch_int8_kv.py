"""The port's int8 KV cache (dense family) against the reference, on the
CPU: the quantizer, the paged kernel's plain version on int8 pages, the
model's prefill and decode with ``kv_dtype="int8"``, and both packages'
``TwoPoolServer``.

The reference's decode dequantizes the whole cache to bf16 and runs jnp
attention; the port's paged kernel (and its plain version) dequantize each
page in f32 after the load, as the reference's TPU kernel does. So the
decode comparison is made twice: against the reference as it is, within 4
bf16 ulps at the logits' scale (its bf16 rounding of K and V moves f32
logits by ~0.014 at |logit| < 4), and against the reference with its
dequantization done in f32, within 1e-5; the two-pool comparison uses the
latter. Parameters are carried from the
reference with ``w_q``/``w_k`` tempered by 0.1, for the reason
``tests/test_torch_models.py`` gives.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import params as jparams_lib  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serving import TwoPoolServer  # noqa: E402

ARCH = "yi-6b"
BF16_ULPS = 4


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def to_torch(x):
    return params_from_numpy(np.asarray(x), device="cpu")


def bf16_tol(ref_out) -> float:
    """BF16_ULPS ulps of bf16 at the largest |value| of ``ref_out``."""
    top = float(np.abs(as_np(ref_out)).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_kv_bit_equal_to_reference(dtype):
    """Values, ties at .5 (half to even), an all-zero row (the 1e-6 floor)
    and a row of large values, in f32 and bf16 inputs."""
    rng = np.random.default_rng(0)
    t = rng.normal(size=(2, 24, 4, 32)).astype(np.float32) * 3.0
    t[0, 0, 0] = 0.0
    t[0, 1, 0] = 1e4 * rng.normal(size=32)
    t[0, 2, 0, :] = np.arange(32) - 15.5  # amax 15.5: scale 15.5 / 127
    t[0, 3, 0, :] = np.linspace(-127, 127, 32)  # ties of value / scale at .5
    t = jnp.asarray(t).astype(dtype)
    jq, js = jtransformer.quantize_kv(t)
    tq, ts = ttransformer.quantize_kv(to_torch(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(
        ttransformer.dequantize_kv(tq, ts).view(torch.int16).numpy(),
        np.asarray(jtransformer.dequantize_kv(jq, js)).view(np.int16),
    )


def int8_pages(scale_dtype):
    """The reference kernel test's case (``tests/test_kernels.py``
    ``test_paged_attention_int8_pages``), with f32 or f16 scales."""
    rng = np.random.default_rng(5)
    B, H, K, D, page, pps, total = 3, 8, 2, 64, 16, 4, 16
    q = jnp.asarray(rng.normal(size=(B, H, D)), jnp.float32)
    kp = jnp.asarray(rng.normal(size=(total, page, K, D)), jnp.float32)
    vp = jnp.asarray(rng.normal(size=(total, page, K, D)), jnp.float32)
    bt = jnp.asarray(rng.permutation(total)[: B * pps].reshape(B, pps), jnp.int32)
    lengths = jnp.asarray([64, 40, 13], jnp.int32)

    def quant(t):
        amax = jnp.max(jnp.abs(t), axis=-1, keepdims=True)
        s = jnp.maximum(amax, 1e-6) / 127.0
        qv = jnp.clip(jnp.round(t / s), -127, 127).astype(jnp.int8)
        return qv, s.astype(scale_dtype)

    (kq, ks), (vq, vs) = quant(kp), quant(vp)
    return q, kp, vp, bt, lengths, kq, ks, vq, vs


@pytest.mark.parametrize("scale_dtype", [jnp.float32, jnp.float16], ids=["f32", "f16"])
def test_int8_paged_plain_matches_reference(scale_dtype):
    """The plain version on int8 pages against the reference's Pallas kernel
    (interpret mode) on the same pages, and both against the f32 oracle
    within the reference test's 5e-2."""
    q, kp, vp, bt, lengths, kq, ks, vq, vs = int8_pages(scale_dtype)
    out = jops.paged_attention(q, kq, vq, bt, lengths, ks, vs, interpret=True)
    args = [to_torch(t) for t in (q, kq, vq, bt, lengths)]
    before = paged_attention.launches
    got = paged_attention(*args, to_torch(ks), to_torch(vs))
    assert paged_attention.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(as_np(got), as_np(out), atol=1e-5)
    expect = ref.paged_attention_ref(q, kp, vp, bt, lengths)
    np.testing.assert_allclose(as_np(got), as_np(expect), atol=5e-2)
    with pytest.raises(ValueError, match="scales"):
        paged_attention_plain(*args)


@functools.lru_cache(maxsize=None)
def reference_params():
    """The reference's parameter tree for the reduced arch, in f32, with its
    init rule (zeros, ones, normal(scale), normal over the fan-in
    ``shape[-2]``) drawn by numpy (its own init compiles one program per
    leaf); ``w_q``/``w_k`` scaled by 0.1."""
    rng = np.random.default_rng(0)

    def leaf(path, d):
        if d.init in ("zeros", "ones"):
            return jnp.asarray(np.full(d.shape, float(d.init == "ones"), np.float32))
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "normal" else 1.0 / np.sqrt(max(1, fan_in))
        v = rng.normal(0.0, std, d.shape).astype(np.float32)
        if path[-1].key in ("w_q", "w_k"):
            v = v * np.float32(0.1)
        return jnp.asarray(v)

    defs = JaxModel(jax_config(ARCH).reduced()).defs
    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=jparams_lib.is_def)


@pytest.fixture(scope="module")
def carried():
    jp = reference_params()
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return (JaxModel(jax_config(ARCH).reduced(), kv_dtype="int8"),
            Model(get_config(ARCH).reduced(), kv_dtype="int8"))


def test_prefill_matches_reference(models, carried):
    """Right-padded prompt: the logits, and the int8 caches with their
    scales. The two packages' f32 k/v differ by summation order, so a value
    at a rounding boundary may quantize one step apart."""
    jm, tm = models
    jp, tp = carried
    toks = np.zeros((1, 64), np.int32)
    toks[0, :41] = np.random.default_rng(1).integers(1, jm.cfg.vocab, 41)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray([40])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.tensor([40])})
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=1e-3)
    assert len(tc) == len(jc) == 4
    assert [t.dtype for t in tc] == [torch.int8, torch.int8, torch.float16, torch.float16]
    for a, b in zip(jc[:2], tc[:2]):
        diff = np.abs(b.numpy().astype(np.int32) - np.asarray(a).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for a, b in zip(jc[2:], tc[2:]):
        np.testing.assert_allclose(as_np(b), as_np(a), rtol=2e-3)


def test_decode_step_matches_reference(models, carried, monkeypatch):
    """One decode step over the same int8 cache in both packages: the
    logits, and the quantized K/V and scales written at ``index``."""
    jm, tm = models
    jp, tp = carried
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    kq, ks = jtransformer.quantize_kv(jnp.asarray(rng.normal(size=shape), jnp.float32))
    vq, vs = jtransformer.quantize_kv(jnp.asarray(rng.normal(size=shape), jnp.float32))
    jcache = (kq, vq, ks, vs)
    tcache = tuple(to_torch(t) for t in jcache)
    tok = np.array([[int(rng.integers(0, cfg.vocab))]], np.int32)
    jl, _ = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    tl, tnc = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(tok), "index": 41})
    assert tnc[0] is tcache[0]  # updated in place
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=bf16_tol(jl))
    monkeypatch.setattr(
        jtransformer, "dequantize_kv",
        lambda q, s: q.astype(jnp.float32) * s.astype(jnp.float32),
    )
    jl32, jnc = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok), "index": jnp.int32(41)})
    np.testing.assert_allclose(as_np(tl), as_np(jl32), atol=1e-5)
    # what was written: K/V one quantization step apart at most (f32
    # summation order), scales within one f16 ulp (2**-10 relative)
    keep = np.ones(64, bool)
    keep[41] = False
    for i, (a, b) in enumerate(zip(jnc, tnc)):
        a, b = np.asarray(a).astype(np.float32), b.float().numpy()
        np.testing.assert_array_equal(b[:, :, keep], a[:, :, keep])
        if i < 2:
            assert np.abs(b[:, :, 41] - a[:, :, 41]).max() <= 1
        else:
            np.testing.assert_allclose(b[:, :, 41], a[:, :, 41], rtol=2**-10)


def test_two_pool_server_matches_reference(monkeypatch):
    """The same requests through both packages' TwoPoolServer with an int8
    KV cache and f32 parameters: identical output tokens, pool choices and
    learned calibration. The reference dequantizes in f32 here (the TPU
    kernel's arithmetic, which the port's kernel follows): with its bf16
    dequantization the logits differ by ~0.01 (see the decode test), and a
    greedy near-tie then picks another token."""
    monkeypatch.setattr(
        jtransformer, "dequantize_kv",
        lambda q, s: q.astype(jnp.float32) * s.astype(jnp.float32),
    )
    jcfg = jax_config(ARCH).reduced()
    jp = reference_params()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(short_cmax=64, long_cmax=192, short_slots=3, long_slots=2)
    jsrv = JaxTwoPoolServer(JaxModel(jcfg, kv_dtype="int8"), jp, **kw)
    tsrv = TwoPoolServer(Model(get_config(ARCH).reduced(), kv_dtype="int8"), tp, **kw)
    assert tsrv.short_engine.cache.state[0].dtype == torch.int8

    rng = np.random.default_rng(7)
    jpools, tpools = {}, {}
    for i in range(9):
        cat = int(rng.integers(0, 4))
        n = int(rng.integers(4, 40))
        toks = [int(t) for t in rng.integers(0, jcfg.vocab, n)]
        mx = 80 if i % 4 == 0 else int(rng.integers(2, 6))
        nbytes = max(1, int(n * (2.0 + cat) + rng.normal(0, 3)))
        jpools[i] = jsrv.submit(i, toks, nbytes, mx, category=cat)
        tpools[i] = tsrv.submit(i, toks, nbytes, mx, category=cat)
        if i % 3 == 2:
            jsrv.step()
            tsrv.step()
    jsrv.run_to_completion()
    tsrv.run_to_completion()

    assert tpools == jpools
    jout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in jsrv.responses}
    tout = {r.request_id: (r.pool, r.output_tokens, r.spilled) for r in tsrv.responses}
    assert tout == jout
    assert tsrv.stats()["router"]["calibration"] == jsrv.stats()["router"]["calibration"]
