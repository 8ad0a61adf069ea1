"""The int8 compressed all-reduce against the reference's
``compressed_psum``: the quantizer bit for bit, one rank against the
reference's ``shard_map``'d synchronizer on a one-device mesh, two gloo
ranks (processes of their own, meeting through a file) against a numpy
oracle of ``compressed_psum``, and error feedback over rounds.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.distributed import collectives as ref  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    compressed_all_reduce,
    dequantize_int8,
    make_compressed_grad_sync,
    quantize_int8,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds a subprocess may take


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def inputs(dtype: torch.dtype, seed: int = 0) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(257,)), rng.normal(scale=1e-3, size=(16, 33)),
          rng.standard_cauchy(size=(1000,)), np.zeros((5,)), np.full((3, 3), -2.5)]
    return [torch.as_tensor(x, dtype=torch.float32).to(dtype) for x in xs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_bit_equal_to_reference(dtype):
    for x in inputs(dtype):
        q, scale = quantize_int8(x)
        rq, rscale = ref.quantize_int8(to_jax(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert scale.item() == float(rscale)
        np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(),
                                      np.asarray(ref.dequantize_int8(rq, rscale)))


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group for the test, torn down after it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_equals_reference_synchronizer(world1):
    grads = {"w": inputs(torch.float32)[0], "b": inputs(torch.bfloat16, 1)[1]}
    errors = {"w": torch.full((257,), 1e-3), "b": torch.zeros(16, 33)}
    means, new_err = make_compressed_grad_sync(world1, ("data",))(grads, errors)
    rmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rsync = ref.make_compressed_grad_sync(rmesh, ("data",))
    rmeans, rerr = rsync({k: to_jax(v) for k, v in grads.items()},
                         {k: to_jax(v) for k, v in errors.items()})
    for k in grads:
        np.testing.assert_array_equal(means[k].numpy(), np.asarray(rmeans[k]))
        np.testing.assert_array_equal(new_err[k].numpy(), np.asarray(rerr[k]))


def test_error_feedback_is_unbiased_over_rounds(world1):
    """The running sums of the compressed and the true gradients stay
    within a quantization step of each other (the reference's test)."""
    sync = make_compressed_grad_sync(world1, ("data",))
    rng = np.random.default_rng(1)
    err = {"w": torch.zeros(64)}
    total_true = np.zeros(64)
    total_comp = np.zeros(64)
    for _ in range(50):
        g = {"w": torch.as_tensor(rng.normal(size=(64,)), dtype=torch.float32)}
        mean, err = sync(g, err)
        total_true += g["w"].numpy()
        total_comp += mean["w"].numpy()
    assert np.abs(total_comp - total_true).max() < 0.1


def oracle(xs: list[np.ndarray], errs: list) -> tuple[np.ndarray, list[np.ndarray]]:
    """numpy's ``compressed_psum`` over the ranks' f32 inputs."""
    f32 = np.float32
    xf = [x.astype(f32) + (0 if e is None else e) for x, e in zip(xs, errs)]
    scales = [f32(max(np.abs(x).max(), f32(1e-12))) / f32(127) for x in xf]
    qs = [np.clip(np.round(x / s), -127, 127).astype(np.int8) for x, s in zip(xf, scales)]
    new_err = [x - q.astype(f32) * s for x, q, s in zip(xf, qs, scales)]
    smax = max(scales)
    total = sum(np.round(q.astype(f32) * (s / smax)).astype(np.int32) for q, s in zip(qs, scales))
    return total.astype(f32) * smax / f32(len(xs)), new_err


def test_two_ranks_equal_numpy_oracle(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                                         os.path.join(ROOT, "tests")]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"), "--phase",
         "collectives", "--rank", str(r), "--world", "2", "--init", str(tmp_path / "rdv"),
         "--out", str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp_path / f"collectives_rank{r}.pt") for r in range(2)]
    for name in ("float32", "bfloat16"):
        errs = [None, None]
        for rnd in range(2):
            xs = [r[f"comp/{name}/{rnd}/x"].float().numpy() for r in ranks]
            mean, errs = oracle(xs, errs)
            for r in ranks:
                np.testing.assert_array_equal(r[f"comp/{name}/{rnd}/mean"].numpy(), mean)
            for r, e in zip(ranks, errs):
                np.testing.assert_array_equal(r[f"comp/{name}/{rnd}/err"].numpy(), e)
