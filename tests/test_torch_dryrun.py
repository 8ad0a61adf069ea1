"""The port's launch arithmetic and dry run: ``analytic_cost`` and the
roofline against the reference's, ``comm_count``'s ring model against the
reference's HLO parse on the same collectives, the H100 constants, and
``python -m repro_torch.launch.dryrun`` over a fake process group (each run
in a process of its own: a process has one default group, and the runs go
side by side): yi-6b and zamba2 cells, an MoE cell on an int8 KV cache
with ``--remat dots``, and xlstm-350m cells with ``--remat none``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs import SHAPES_BY_NAME as REF_SHAPES  # noqa: E402
from repro.core.cost_model import TPU_V5E as REF_TPU_V5E  # noqa: E402
from repro.launch import analytic_cost as ref_cost  # noqa: E402
from repro.launch import hlo_parse as ref_hlo  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES_BY_NAME, shape_applicable  # noqa: E402
from repro_torch.core.cost_model import H100_SXM, TPU_V5E  # noqa: E402
from repro_torch.launch import analytic_cost, comm_count, roofline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 240  # seconds a subprocess may take
ARCH_SHAPES = [(a, s) for a in REGISTRY for s in SHAPES_BY_NAME]
VARIANTS = [
    dict(),
    dict(causal_mode="triangle", optimizer="adafactor", remat="dots", kv_dtype="int8"),
    dict(moe_cf=2.0, remat="none"),
]


# ---------------------------------------------------------------------------
# Analytic cost and the roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES)
def test_analytic_cost_as_reference(arch, shape):
    cfg, cell = REGISTRY[arch], SHAPES_BY_NAME[shape]
    rcfg, rcell = REF_REGISTRY[arch], REF_SHAPES[shape]
    n = 1_234_567_891
    for kw in VARIANTS:
        got = analytic_cost.cell_cost(cfg, cell, n, **kw).as_dict()
        want = ref_cost.cell_cost(rcfg, rcell, n, **kw).as_dict()
        assert got == want
    for mode in ("masked", "triangle"):
        assert (analytic_cost.forward_flops(cfg, cell, causal_mode=mode)
                == ref_cost.forward_flops(rcfg, rcell, causal_mode=mode))
    assert analytic_cost.hbm_bytes(cfg, cell, n) == ref_cost.hbm_bytes(rcfg, rcell, n)


def test_roofline_on_tpu_v5e_as_reference():
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(REF_TPU_V5E)
    for flops, nbytes, coll, chips in ((3.1e15, 2.2e12, 5.5e9, 256), (1e9, 7e12, 0.0, 512),
                                       (0.0, 0.0, 1e6, 1)):
        got = roofline.Roofline(flops, nbytes, coll, chips, hw=TPU_V5E)
        want = ref_roofline.Roofline(flops, nbytes, coll, chips, hw=REF_TPU_V5E)
        assert got.as_dict() == want.as_dict()
        assert got.bound_s == want.bound_s
        assert got.model_flops_fraction(1e12) == want.model_flops_fraction(1e12)
    stats = comm_count.collective_stats([("all-reduce", 4096, 4)])
    ref_stats = ref_roofline.CollectiveStats(counts={}, wire_bytes_per_chip=stats.wire_bytes_per_chip,
                                             by_op={})
    cost = {"flops": 2e15, "bytes accessed": 3e12}
    assert (roofline.make_roofline(cost, stats, 64, hw=TPU_V5E).as_dict()
            == ref_roofline.make_roofline(cost, ref_stats, 64, hw=REF_TPU_V5E).as_dict())
    for train in (True, False):
        assert (roofline.model_flops_estimate(7_000_000_000, 4096, train=train)
                == ref_roofline.model_flops_estimate(7_000_000_000, 4096, train=train))


def test_h100_constants():
    """The data-sheet figures ``chip_smoke.py`` also reads."""
    assert (H100_SXM.hbm_bytes, H100_SXM.peak_flops_bf16, H100_SXM.hbm_bw) == (80e9, 989e12, 3.35e12)
    assert H100_SXM.ici_bw == 50e9
    assert roofline.Roofline(1.0, 1.0, 1.0, 1).hw is H100_SXM


# ---------------------------------------------------------------------------
# comm_count's ring model against the reference's HLO parse
# ---------------------------------------------------------------------------

_HLO_OPS = {  # op: (HLO text of the output, the port's record bytes)
    "all-gather": lambda n: (f"f32[{8 * n},128]", 8 * n * 128 * 4),
    "all-reduce": lambda n: ("bf16[64,256]", 64 * 256 * 2),
    "reduce-scatter": lambda n: ("f32[8,128]", 8 * n * 128 * 4),  # the input's bytes
    "all-to-all": lambda n: ("s8[4096]", 4096),
    "collective-permute": lambda n: ("f32[16,16]", 16 * 16 * 4),
}


@pytest.mark.parametrize("op", list(_HLO_OPS))
@pytest.mark.parametrize("n", [2, 4, 16])
def test_ring_model_as_reference_hlo_parse(op, n):
    out_shape, nbytes = _HLO_OPS[op](n)
    group = ",".join(str(i) for i in range(n))
    hlo = textwrap.dedent(f"""
        HloModule t

        ENTRY %main (a: f32[8,128]) -> f32[8,128] {{
          %a = f32[8,128]{{1,0}} parameter(0)
          %c = {out_shape}{{1,0}} {op}(%a), replica_groups={{{{{group}}}}}
          ROOT %out = f32[8,128]{{1,0}} add(%a, %a)
        }}
    """)
    want = ref_hlo.parse_collectives(hlo)
    got = comm_count.collective_stats([(op, nbytes, n), (op, nbytes, 1)])  # a group of one moves nothing
    assert got.counts == want.executed
    assert got.by_op == pytest.approx(want.by_op, rel=1e-12)
    assert got.wire_bytes_per_chip == pytest.approx(want.wire_bytes_per_chip, rel=1e-12)


_COUNTER_SCRIPT = """
import json, sys, torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.launch.comm_count import CommCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
t = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Replicate(), Shard(0)])
p = DTensor.from_local(torch.empty(64, 32, device="meta", dtype=torch.bfloat16), mesh,
                       [Replicate(), Partial()])
with CommCounter() as counter:
    t.redistribute(mesh, [Replicate(), Replicate()])
    p.redistribute(mesh, [Replicate(), Replicate()])
    p.redistribute(mesh, [Replicate(), Shard(0)])
json.dump({"records": counter.records, "stats": counter.stats().by_op}, open(sys.argv[1], "w"))
"""


def test_comm_counter_records_what_dtensor_issues(tmp_path):
    out = tmp_path / "counter.json"
    proc = subprocess.run([sys.executable, "-c", _COUNTER_SCRIPT, str(out)],
                          env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out.read_text())
    assert [tuple(r) for r in got["records"]] == [
        ("all-gather", 64 * 32 * 4, 4),  # f32 output, gathered over the 4-wide model axis
        ("all-reduce", 64 * 32 * 2, 4),
        ("reduce-scatter", 64 * 32 * 2, 4),  # bf16 input
    ]
    assert got["stats"]["all-reduce"] == pytest.approx(2 * 3 / 4 * 64 * 32 * 2)


# ---------------------------------------------------------------------------
# The dry run, in a process of its own
# ---------------------------------------------------------------------------

DRY_ARCHS = ("yi-6b", "zamba2-2.7b")
DRY_SHAPES = ("decode_32k", "train_4k", "long_500k")
#: The runs with other flags: name → (archs, shapes, flags).
VARIANT_RUNS = {
    "int8": (("qwen3-235b-a22b",), ("decode_32k",), ("--kv-dtype", "int8", "--remat", "dots")),
    "none": (("xlstm-350m",), ("train_4k", "decode_32k"), ("--remat", "none")),
}


def dryrun_cmd(archs, shapes, flags=()) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", *archs,
            "--shape", *shapes, *flags]


@pytest.fixture(scope="module")
def dry_records(tmp_path_factory):
    """The default-flag records by (arch, shape), the runs' stdout, and each
    variant run's records. zamba2's train_4k step (the longest) runs in a
    process of its own beside the rest."""
    root = tmp_path_factory.mktemp("dryrun")
    runs = {"default": dryrun_cmd(DRY_ARCHS, [s for s in DRY_SHAPES if s != "train_4k"]),
            "default_train": dryrun_cmd(DRY_ARCHS[:1], ["train_4k"]),
            "default_train_hybrid": dryrun_cmd(DRY_ARCHS[1:], ["train_4k"])}
    runs.update({name: dryrun_cmd(*run) for name, run in VARIANT_RUNS.items()})
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen([*cmd, "--out", str(root / name)], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, cmd in runs.items()}
    records, stdout = {}, ""
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=TIMEOUT)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        group = records.setdefault(name.split("_")[0], {})
        for path in os.listdir(root / name):
            with open(root / name / path) as f:
                rec = json.load(f)
            group[(rec["arch"], rec["shape"])] = rec
        if name.startswith("default"):
            stdout += out
    return records.pop("default"), stdout, records


def test_dryrun_writes_one_record_a_cell(dry_records):
    records, stdout, _ = dry_records
    assert set(records) == {(a, s) for a in DRY_ARCHS for s in DRY_SHAPES}
    assert all(r["mesh"] == "pod16x16" for r in records.values())
    assert stdout.count("\n[") + stdout.startswith("[") == len(records)


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dense_cells_are_ok_with_every_term(dry_records, shape):
    rec = dry_records[0][("yi-6b", shape)]
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["hardware"] == H100_SXM.name
    held = rec["bytes_per_rank"]
    parts = {"decode_32k": "cache", "train_4k": "opt_state"}[shape]
    assert held[parts] > 0 and held["total"] == sum(v for k, v in held.items() if k != "total")
    assert rec["fits"] == (rec["memory_analysis"]["peak_bytes"] <= 0.9 * 80e9)
    r = rec["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert r[term] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    colls = rec["collectives"]
    assert sum(colls["counts"].values()) > 0
    assert colls["wire_bytes_per_chip"] == pytest.approx(sum(colls["by_op"].values()))
    assert r["collective_s"] == pytest.approx(colls["wire_bytes_per_chip"] / H100_SXM.ici_bw)
    assert 0 < rec["useful_flops_fraction"] < 1


@pytest.mark.parametrize("arch", DRY_ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_records_count_causal_attention_as_the_triangle(dry_records, arch, shape):
    """The port's flash kernel never visits the blocks above the diagonal,
    so the dry run's analytic cost is the triangle count (held to the
    reference's arithmetic in both modes above), not the masked one."""
    rec = dry_records[0][(arch, shape)]
    cfg, cell = REGISTRY[arch], SHAPES_BY_NAME[shape]
    kw = dict(moe_cf=1.25 if cell.kind == "train" else 2.0,
              optimizer=rec.get("optimizer", "adamw"), remat="full")
    assert rec["analytic_cost"] == analytic_cost.cell_cost(
        cfg, cell, rec["params"], causal_mode="triangle", **kw).as_dict()
    if cell.kind == "train":  # a decode step attends to its whole cache either way
        masked = analytic_cost.cell_cost(cfg, cell, rec["params"], causal_mode="masked", **kw)
        assert rec["analytic_cost"]["flops_total"] < masked.flops_total


def test_decode_cache_bytes_a_rank(dry_records):
    """yi-6b's 4 KV heads do not divide the 16-wide model axis, so its
    cache shards its sequence: 128/16 sequences x 32,768/16 positions x 32
    layers x (K, V) x 4 heads x 128 x 2 bytes."""
    rec = dry_records[0][("yi-6b", "decode_32k")]
    assert rec["policy"]["rules"]["kv_seq"] == "model"
    assert rec["bytes_per_rank"]["cache"] == 8 * 2048 * 32 * 2 * 4 * 128 * 2


def test_skip_rule(dry_records):
    records = dry_records[0]
    for (arch, shape), rec in records.items():
        applicable = shape_applicable(REGISTRY[arch], SHAPES_BY_NAME[shape])
        assert (rec["status"] == "skipped") == (not applicable), (arch, shape)
    assert records[("yi-6b", "long_500k")]["status"] == "skipped"


def test_other_families_are_shape_only(dry_records):
    """No family is shape-only any more: the xLSTM's cells run their step
    on the meta DTensors (its sLSTM loop as shapes only) and count their
    collectives, every roofline term set."""
    for shape in VARIANT_RUNS["none"][1]:
        rec = dry_records[2]["none"][("xlstm-350m", shape)]
        assert rec["status"] == "ok"
        colls = rec["collectives"]
        assert sum(colls["counts"].values()) > 0 and colls["wire_bytes_per_chip"] > 0
        assert rec["roofline"]["collective_s"] == pytest.approx(
            colls["wire_bytes_per_chip"] / H100_SXM.ici_bw)
        assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
        assert rec["roofline"]["memory_s"] > 0 and rec["bytes_per_rank"]["params"] > 0


@pytest.mark.parametrize("arch,shape", [("zamba2-2.7b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
                                        ("qwen3-235b-a22b", "decode_32k")])
def test_moe_and_hybrid_cells_run_their_step(dry_records, arch, shape):
    """The hybrid's and the MoE family's cells run their step on the meta
    DTensors: status ok, the collectives counted, every roofline term."""
    rec = dry_records[0].get((arch, shape)) or dry_records[2]["int8"][(arch, shape)]
    assert rec["status"] == "ok"
    colls = rec["collectives"]
    assert sum(colls["counts"].values()) > 0 and colls["wire_bytes_per_chip"] > 0
    assert all(rec["roofline"][k] > 0 for k in ("compute_s", "memory_s", "collective_s"))


@pytest.mark.parametrize("run,arch,shape", [
    ("int8", "qwen3-235b-a22b", "decode_32k"), ("none", "xlstm-350m", "train_4k"),
    ("none", "xlstm-350m", "decode_32k")])
def test_remat_and_kv_dtype_reach_the_cost_as_the_reference(dry_records, run, arch, shape):
    """``--remat`` and ``--kv-dtype`` reach the analytic cost as the
    reference's dry run passes them (its causal mode set to the triangle);
    an int8 cache is placed in int8 with f16 scales."""
    rec = dry_records[2][run][(arch, shape)]
    flags = dict(zip(VARIANT_RUNS[run][2][::2], VARIANT_RUNS[run][2][1::2]))
    remat, kv_dtype = flags["--remat"], flags.get("--kv-dtype", "bf16")
    assert rec["variant"] == {"causal_mode": "triangle", "remat": remat, "kv_dtype": kv_dtype}
    cell = REF_SHAPES[shape]
    want = ref_cost.cell_cost(REF_REGISTRY[arch], cell, rec["params"], causal_mode="triangle",
                              moe_cf=1.25 if cell.kind == "train" else 2.0,
                              optimizer=rec.get("optimizer", "adamw"), remat=remat,
                              kv_dtype=kv_dtype)
    assert rec["analytic_cost"] == want.as_dict()
    if kv_dtype == "int8":
        # qwen3's 4 KV heads do not divide the 16-wide model axis, so the
        # cache shards its sequence: 128/16 sequences x 32,768/16 positions x
        # 94 layers x (K, V) x 4 heads x (128 int8 codes + one f16 scale)
        assert rec["policy"]["rules"]["kv_seq"] == "model"
        assert rec["bytes_per_rank"]["cache"] == 8 * 2048 * 94 * 2 * 4 * (128 + 2)


def test_ssd_scan_on_meta_gives_the_plain_shapes():
    """The dry run's meta tensors take the SSD scan's and its backward's
    shapes and dtypes without running the scan; they equal the plain
    version's on the CPU."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        x, log_a = torch.randn(2, 3, 70, 8, generator=gen), -torch.rand(2, 3, 70, generator=gen)
        b, c = (torch.randn(2, 70, 4, generator=gen).to(dtype) for _ in range(2))
        dy, ds = torch.randn_like(x), torch.randn(2, 3, 8, 4)

        def meta(*ts):
            return [t.to("meta") for t in ts]

        cpu = ssd.ssd_scan(x, log_a, b, c, return_states=True)
        for args, run in (((x, log_a, b, c), lambda *a: ssd.ssd_scan(*a, return_states=True)),
                          ((x, log_a, b, c, dy, ds, cpu[2]), ssd.ssd_scan_backward)):
            want, got = run(*args), run(*meta(*args))
            assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
            assert all(t.device.type == "meta" for t in got)


def test_dryrun_module_does_nothing_at_import():
    import torch.distributed as dist

    import repro_torch.launch.dryrun  # noqa: F401

    assert not dist.is_initialized()
