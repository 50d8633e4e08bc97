"""The port's launch tooling (``repro_torch.launch``: specs, variants,
the roofline's model half, rederive, the dry-run) against the
reference's (``repro.launch``) on the CPU.

Shapes, dtypes, variant tables and rule-derived records must be equal;
the analytic FLOP and byte counts of the roofline are the reference's
formulas on the same integers and are held at ``rel=1e-12``.  The
dry-run runs smollm-135m's smoke config at a small shape on a fake 16 x
16 mesh: its argument bytes must be the sum over the state's and the
batch's leaves of each leaf's bytes over the shard factor the
reference's partition specs give it.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import adapt_rules_for  # noqa: E402
from repro.distributed.sharding import prune_to_mesh  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.launch import rederive as jrederive  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import variants as jvariants  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models.params import param_pspecs as jparam_pspecs  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, rederive, roofline  # noqa: E402
from repro_torch.launch import specs, variants  # noqa: E402
from repro_torch.launch.mesh import HW, fake_mesh  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402

REL = 1e-12


def _cells():
    return [(a, s.name) for a in configs.ARCH_IDS
            for s in tconfig.shapes_for(configs.get_config(a))]


def _shape(name, mod):
    return {s.name: s for s in mod.ALL_SHAPES}[name]


def test_shapes_are_the_references():
    assert [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.ALL_SHAPES]
    for a in configs.ARCH_IDS:
        assert [s.name for s in tconfig.shapes_for(configs.get_config(a))] \
            == [s.name for s in jconfig.shapes_for(jconfigs.get_config(a))]


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_and_bytes_match(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    ts, js = _shape(shape, tconfig), _shape(shape, jconfig)
    na = roofline.active_params(cfg)
    assert na == jroofline.active_params(jcfg)
    for mode in ("train", "prefill", "decode"):
        assert roofline.model_flops(cfg, ts, na, mode) == pytest.approx(
            jroofline.model_flops(jcfg, js, na, mode), rel=REL)
    assert roofline.executed_flops(cfg, ts, na) == pytest.approx(
        jroofline.executed_flops(jcfg, js, na), rel=REL)
    for chips in (1, 256, 512):
        assert roofline.ideal_bytes(cfg, ts, chips) == pytest.approx(
            jroofline.ideal_bytes(jcfg, js, chips), rel=REL)


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match(arch, shape):
    """Same names, shapes and dtypes; token ids int64 where the
    reference's are int32."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = specs.input_specs(cfg, _shape(shape, tconfig))
    want = jspecs.input_specs(jcfg, _shape(shape, jconfig))
    assert set(got) == set(want)
    for part in want:
        want_leaves = jax.tree.leaves_with_path(want[part])
        got_leaves = dict(_leaves(got[part]))
        assert len(got_leaves) == len(want_leaves)
        for path, w in want_leaves:
            key = "/" + "/".join(k.key for k in path)
            g = got_leaves[key]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), key
            wdt = str(w.dtype).replace("int32", "int64") \
                if key != "/len" else str(w.dtype)
            assert str(g.dtype).replace("torch.", "") == wdt, key


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_variant_tables():
    want = dict(jvariants.KERNEL_VARIANTS)
    want["cached_cuda"] = {"target": "cuda", "cache": True}
    del want["cached_pallas"]
    assert variants.KERNEL_VARIANTS == want
    assert variants.kernel_variant("cached_cuda") == want["cached_cuda"]
    assert variants.CFG_OVERRIDES == jvariants.CFG_OVERRIDES
    assert sorted(variants.VARIANTS) == sorted(jvariants.VARIANTS)


def test_hw_is_the_h100s():
    assert HW["peak_flops_bf16"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["link_bw"] == 900e9 and HW["hbm_bytes"] == 80 * 1024**3


def _records():
    """Synthetic dry-run records: each dominant term and both kinds."""
    out = []
    for kind, flops, byts, coll in (("train", 900.0, 1.0, 1e-4),
                                    ("train", 1.0, 900.0, 0.0),
                                    ("prefill", 5.0, 6.0, 3.0),
                                    ("decode", 0.5, 80.0, 0.2)):
        out.append({"kind": kind, "hlo_gbytes": byts,
                    "cpu_artifact_gbytes": 0.0, "ideal_gbytes": byts / 3,
                    "t_compute": flops * 1e9 / HW["peak_flops_bf16"],
                    "executed_gflops_per_chip": flops * 1.2,
                    "t_collective": coll,
                    "model_gflops_per_chip": flops * 0.9})
    return out


def test_rederive_matches_the_reference(monkeypatch, tmp_path):
    """The reference's rederive with its HW swapped for the port's."""
    monkeypatch.setattr(jrederive, "HW", HW)
    for rec in _records():
        got = rederive.rederive(dict(rec))
        want = jrederive.rederive(dict(rec))
        assert got == want
    (tmp_path / "m" / "v").mkdir(parents=True)
    for i, rec in enumerate(_records()):
        (tmp_path / "m" / "v" / f"r{i}.json").write_text(json.dumps(rec))
    assert rederive.main(str(tmp_path)) == 4
    back = json.loads((tmp_path / "m" / "v" / "r0.json").read_text())
    assert back["dominant"] == "compute"


def test_build_report_prices_against_the_h100():
    cfg = configs.get_config("smollm-135m")
    shape = _shape("train_4k", tconfig)
    coll = {"bytes": {k: 0 for k in roofline.COLLECTIVES},
            "count": {k: 0 for k in roofline.COLLECTIVES},
            "total_bytes": 9e8}
    rep = roofline.build_report(arch="smollm-135m", shape=shape,
                                mesh_name="m", chips=256,
                                cost={"flops": 2e12, "bytes accessed": 3e10},
                                mem_bytes=1.0, coll=coll, cfg=cfg)
    assert rep.t_compute == 2e12 / 989e12
    assert rep.t_memory == 3e10 / 3.35e12
    assert rep.t_collective == 9e8 / 900e9
    assert rep.cpu_artifact_gbytes == 0.0
    d = rep.to_dict()
    assert d["dominant"] in ("compute", "memory", "collective")


@pytest.fixture
def pod16x16():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield fake_mesh((16, 16), ("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dry_run_argument_bytes(pod16x16, tmp_path):
    """smollm-135m's smoke config, 32 x 64 tokens, on the fake 16 x 16
    mesh: one device's argument bytes are each leaf's bytes over the
    shard factor of the reference's partition spec for it."""
    cfg = configs.get_smoke("smollm-135m")
    jcfg = jconfigs.get_smoke("smollm-135m")
    shape = tconfig.ShapeConfig("small_train", 64, 32, "train")
    rec = dryrun.run_cell("smollm-135m", shape, mesh=pod16x16,
                          mesh_name="pod16x16", cfg=cfg,
                          out_dir=str(tmp_path), verbose=False)
    jmesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    rules = adapt_rules_for(prune_to_mesh(BASELINE_RULES, jmesh), jmesh,
                            n_kv=jcfg.n_kv, n_experts=jcfg.n_experts,
                            n_heads=jcfg.n_heads, d_ff=jcfg.d_ff,
                            vocab=jcfg.padded_vocab)
    factor = {"data": 16, "model": 16}

    def cut(spec):
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= factor[a]
        return n
    pspecs = jax.tree.leaves(
        jparam_pspecs(jmodel_defs(jcfg), rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    defs = jax.tree.leaves(jmodel_defs(jcfg),
                           is_leaf=lambda x: hasattr(x, "logical"))
    param_bytes = sum(int(np.prod(d.shape)) * 4 / cut(s)
                      for d, s in zip(defs, pspecs))
    # params, AdamW m and v (float32), the int32 step; tokens and targets
    # int64, cut on the batch dim over "data"
    batch_bytes = 2 * shape.global_batch * shape.seq_len * 8 / 16
    assert rec["argument_bytes"] == 3 * param_bytes + 4 + batch_bytes
    assert rec["mesh"] == "pod16x16" and rec["chips"] == 256
    assert rec["temp_bytes"] > 0 and rec["hlo_gflops"] > 0
    assert sum(rec["coll_counts"].values()) > 0
    assert (tmp_path / "pod16x16" / "baseline"
            / "smollm-135m__small_train.json").exists()
    assert not dist.is_initialized() or dist.get_world_size() == 256


def test_dry_run_refuses_decode_cells_for_now(pod16x16, tmp_path):
    shape = tconfig.ShapeConfig("small_decode", 64, 32, "decode")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dryrun.run_cell("smollm-135m", shape, mesh=pod16x16,
                        mesh_name="pod16x16",
                        cfg=configs.get_smoke("smollm-135m"),
                        out_dir=str(tmp_path), verbose=False)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m"])
def test_dry_run_of_a_prefill_cell(arch, tmp_path):
    """A prefill step on a fake 4 x 4 mesh (the smoke configs' heads
    divide 4): the params placed, the batch cut over "data", the caches
    by their axes and written whole."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = fake_mesh((4, 4), ("data", "model"))
    try:
        rec = dryrun.run_cell(arch, tconfig.ShapeConfig("small_prefill", 64,
                                                        8, "prefill"),
                              mesh=mesh, mesh_name="fake4x4",
                              cfg=configs.get_smoke(arch),
                              out_dir=str(tmp_path), verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["kind"] == "prefill" and rec["argument_bytes"] > 0
    assert rec["model_gflops_per_chip"] > 0


#: one architecture of each family
FAMILY_ARCHS = ("smollm-135m", "granite-moe-3b-a800m", "mamba2-780m",
                "zamba2-7b", "whisper-small", "llama-3.2-vision-11b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dry_run_of_each_family_on_a_4x4_mesh(arch, tmp_path):
    """Each family's smoke config traced on a fake 4 x 4 mesh (its head
    and expert counts divide 4): every constrain, reshape and local_map
    of its train step places, and the record prices it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = fake_mesh((4, 4), ("data", "model"))
    try:
        rec = dryrun.run_cell(arch, tconfig.ShapeConfig("small", 64, 8,
                                                        "train"),
                              mesh=mesh, mesh_name="fake4x4",
                              cfg=configs.get_smoke(arch),
                              out_dir=str(tmp_path), verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["device_type"] == "cpu" and rec["chips"] == 16
    assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["hlo_gflops"] > 0 and sum(rec["coll_counts"].values()) > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_dry_run_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.runtime import DeviceNotFoundError
    with pytest.raises(DeviceNotFoundError):
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k"])
