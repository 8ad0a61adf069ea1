"""The port's serving engine and two-pool server (CPU, reduced widths):
the reference's ``tests/test_serving.py`` mirrored on the port, one run of
both packages' ``TwoPoolServer`` on the same prompts, and the port's
import hygiene."""

import pathlib
import re
import subprocess
import sys

import hypothesis.strategies as st
import numpy as np
import pytest
from hypothesis import given, settings

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import TwoPoolServer as JaxTwoPoolServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SamplingParams,
    ServeRequest,
    ServingEngine,
    SlotAllocator,
    TwoPoolServer,
    bucket_length,
    sample,
)

settings.register_profile("fast", max_examples=25, deadline=None)
settings.load_profile("fast")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("granite-3-8b").reduced()
    model = Model(cfg)
    params = model.init(0, device="cpu")
    return cfg, model, params


class TestSlotAllocator:
    @given(ops=st.lists(st.booleans(), max_size=40))
    def test_alloc_release_invariants(self, ops):
        alloc = SlotAllocator(4)
        held = []
        for do_alloc in ops:
            if do_alloc:
                s = alloc.alloc()
                if len(held) < 4:
                    assert s is not None and s not in held
                    held.append(s)
                else:
                    assert s is None
            elif held:
                alloc.release(held.pop())
            assert alloc.num_free == 4 - len(held)

    def test_double_release_raises(self):
        a = SlotAllocator(2)
        s = a.alloc()
        a.release(s)
        with pytest.raises(ValueError):
            a.release(s)


class TestBucketing:
    @given(n=st.integers(1, 100_000))
    def test_bucket_covers_and_is_aligned(self, n):
        b = bucket_length(n, multiple=128, max_len=1 << 17)
        assert b % 128 == 0 or b == 1 << 17
        assert b >= min(n, 1 << 17)


class TestSampler:
    def test_greedy_and_top1_are_argmax(self):
        logits = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 50)))
        expect = logits.argmax(-1).to(torch.int32)
        assert torch.equal(sample(logits, 0), expect)
        hot = SamplingParams(temperature=0.7, top_k=1)
        assert torch.equal(sample(logits, 5, hot), expect)

    def test_temperature_draws_follow_the_seed(self):
        logits = torch.zeros(4, 64)
        hot = SamplingParams(temperature=1.0)
        a, b = sample(logits, 3, hot), sample(logits, 3, hot)
        assert a.dtype == torch.int32 and torch.equal(a, b)
        draws = {tuple(sample(logits, s, hot).tolist()) for s in range(6)}
        assert len(draws) > 1


class TestEngine:
    def test_greedy_matches_full_forward(self, small_model):
        cfg, model, params = small_model
        prompt = [int(t) for t in np.random.default_rng(1).integers(0, cfg.vocab, 12)]
        eng = ServingEngine(model, params, c_max=64, n_slots=2, prompt_bucket=16)
        eng.submit(ServeRequest(0, prompt, max_new_tokens=6))
        comp = eng.run_to_completion()[0]
        toks = list(prompt)
        for _ in range(6):
            logits, _ = model.forward(params, {"tokens": torch.tensor([toks])})
            toks.append(int(torch.argmax(logits[0, -1])))
        assert comp.output_tokens == toks[len(prompt):]

    def test_concurrent_slots_isolated(self, small_model):
        """Requests served together produce the same tokens as served alone."""
        cfg, model, params = small_model
        rng = np.random.default_rng(2)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, int(n))] for n in (8, 13, 21)]

        solo = {}
        for i, p in enumerate(prompts):
            eng = ServingEngine(model, params, c_max=64, n_slots=1, prompt_bucket=16)
            eng.submit(ServeRequest(i, p, max_new_tokens=4))
            solo[i] = eng.run_to_completion()[0].output_tokens

        eng = ServingEngine(model, params, c_max=64, n_slots=3, prompt_bucket=16)
        for i, p in enumerate(prompts):
            eng.submit(ServeRequest(i, p, max_new_tokens=4))
        together = {c.request_id: c.output_tokens for c in eng.run_to_completion()}
        assert together == solo

    def test_queueing_beyond_slots(self, small_model):
        cfg, model, params = small_model
        eng = ServingEngine(model, params, c_max=64, n_slots=2, prompt_bucket=16)
        rng = np.random.default_rng(3)
        for i in range(7):
            eng.submit(
                ServeRequest(i, [int(t) for t in rng.integers(0, cfg.vocab, 10)], max_new_tokens=3)
            )
        comps = eng.run_to_completion()
        assert sorted(c.request_id for c in comps) == list(range(7))
        assert all(len(c.output_tokens) == 3 for c in comps)
        assert eng.decode_tokens == 7 * 2  # the first token comes from prefill

    def test_prompt_over_cmax_rejected(self, small_model):
        cfg, model, params = small_model
        eng = ServingEngine(model, params, c_max=32, n_slots=2)
        ok = eng.submit(ServeRequest(0, list(range(40)), max_new_tokens=3))
        assert not ok and eng.rejections == 1

    def test_usage_prompt_tokens_reported(self, small_model):
        cfg, model, params = small_model
        eng = ServingEngine(model, params, c_max=64, n_slots=2, prompt_bucket=16)
        eng.submit(ServeRequest(0, list(range(1, 18)), max_new_tokens=2))
        comp = eng.run_to_completion()[0]
        assert comp.prompt_tokens == 17  # exact, independent of bucketing


class TestTwoPoolServer:
    def test_routing_and_feedback(self, small_model):
        cfg, model, params = small_model
        srv = TwoPoolServer(
            model, params,
            short_cmax=64, long_cmax=256, short_slots=4, long_slots=2,
        )
        rng = np.random.default_rng(4)
        pools = {}
        for i in range(10):
            n = int(rng.integers(4, 30))
            toks = [int(t) for t in rng.integers(0, cfg.vocab, n)]
            mx = 100 if i % 5 == 0 else int(rng.integers(2, 6))
            pools[i] = srv.submit(i, toks, int(n * 4.4), mx)
        resps = srv.run_to_completion()
        assert len(resps) == 10
        # long-output requests must be in the long pool (total-budget rule)
        for i, pool in pools.items():
            if i % 5 == 0:
                assert pool == "long"
        stats = srv.stats()["router"]
        assert stats["calibration"]["count"][0] > 0
        ratio = stats["calibration"]["ratio"][0]
        assert 3.5 < ratio < 5.5  # learned ≈ 4.4 bytes/token

    def test_hard_miss_bounces_to_long(self, small_model):
        """Estimate says short, prompt actually exceeds short c_max."""
        cfg, model, params = small_model
        srv = TwoPoolServer(
            model, params,
            short_cmax=32, long_cmax=256, short_slots=2, long_slots=2,
            bytes_per_token_hint=40.0,  # wildly wrong → underestimates tokens
        )
        toks = list(range(1, 41))  # 40 tokens > short c_max 32
        srv.submit(0, toks, prompt_bytes=160, max_output_tokens=2)
        resps = srv.run_to_completion()
        assert resps[0].pool == "long"
        assert len(resps[0].output_tokens) == 2


def test_two_pool_server_matches_reference():
    """The same requests through both packages' TwoPoolServer, f32 params
    carried from the reference (w_q/w_k tempered by 0.1, as in
    tests/test_torch_models.py, so near-arg-max attention does not turn
    1e-7 differences into different tokens): identical output tokens, pool
    choices and learned calibration."""
    arch = "granite-3-8b"
    jcfg = jax_config(arch).reduced()
    jparams = JaxModel(jcfg).init(jax.random.key(0))
    blocks = dict(jparams["blocks"])
    for name in ("w_q", "w_k"):
        blocks[name] = blocks[name].astype(jnp.float32) * 0.1
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32), {**jparams, "blocks": blocks})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(short_cmax=64, long_cmax=192, short_slots=3, long_slots=2)
    jsrv = JaxTwoPoolServer(JaxModel(jcfg), jparams, **kw)
    tsrv = TwoPoolServer(Model(get_config(arch).reduced()), tparams, **kw)

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
    jstats, tstats = jsrv.stats(), tsrv.stats()
    assert tstats["router"]["calibration"] == jstats["router"]["calibration"]
    assert tstats["router"]["routed"] == jstats["router"]["routed"]
    assert {"long", "short"} == set(tpools.values())


def test_serve_entry_point_on_cpu(capsys):
    """launch/serve.py end to end at reduced widths on the CPU."""
    from repro_torch.launch.serve import serve

    out = serve("yi-6b", requests=6, short_cmax=64, long_cmax=128, device="cpu")
    assert sorted(r.request_id for r in out["responses"]) == list(range(6))
    assert sum(out["by_pool"].values()) == 6
    assert sum(out["stats"]["router"]["calibration"]["count"]) == 6
    assert "[serve] pool split" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Import hygiene: the port needs neither jax nor the reference package
# ---------------------------------------------------------------------------


def test_port_imports_without_jax():
    """Every module of the port, and every ``benchmarks/port_*.py`` and
    ``examples/port_*.py`` script (imported, not run), loads with jax and
    the reference package blocked."""
    root = SRC.parent
    scripts = sorted(root.glob("benchmarks/port_*.py")) + sorted(root.glob("examples/port_*.py"))
    assert len(scripts) >= 13
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.sim import FleetSim, run_fleet, plan_fleet\n"
        "from repro_torch.sim.torch_engine import run_fleet_torch\n"
        "from repro_torch.traces import generate_trace_columns\n"
        "from repro_torch.kernels.sim_decode import decode_advance\n"
        "from repro_torch.core import *\n"
        "from repro_torch.training import *\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.launch.train import train\n"
        "from repro_torch.distributed import StepTimer, SimulatedFailure, largest_mesh_shape\n"
        "from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_backward\n"
        "for path in sys.argv[1:]:\n"
        "    if '/benchmarks/' in path:\n"
        "        importlib.import_module('benchmarks.' + path.rsplit('/', 1)[1][:-3])\n"
        "    else:\n"
        "        spec = importlib.util.spec_from_file_location(path.rsplit('/', 1)[1][:-3], path)\n"
        "        spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " and sys.modules[n] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, *map(str, scripts)],
        capture_output=True, text=True, timeout=120, cwd=root,
        env={"PYTHONPATH": f"{SRC}:{root}", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_never_name_jax_or_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    # legacy global-state numpy RNG is not used in the port
    legacy = re.compile(r"np\.random\.(seed|rand|randn|randint|normal|uniform|choice)\(")
    assert [str(f) for f in files if legacy.search(f.read_text())] == []
