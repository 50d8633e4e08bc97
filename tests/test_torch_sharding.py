"""The port's sharding rules (``repro_torch.distributed.sharding``) and
the placements they give, against the reference's
(``repro.distributed.sharding``, ``tests/test_sharding.py``'s cases).

The reference's functions run on ``jax.sharding.AbstractMesh``es of the
production shapes, which need no devices; the port's on
``DeviceMesh``es of the same shapes over the fake process group
(``repro_torch.launch.mesh.fake_mesh``), started and destroyed by each
test.  Everything compared here is exact: rule tables, partition-spec
entries per parameter leaf, cache axes and placements.
"""

import dataclasses
import os

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import variants as jvariants  # noqa: E402
from repro.models import cache_logical_axes as jcache_axes  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models.config import ALL_SHAPES as JSHAPES  # noqa: E402
from repro.models.params import param_pspecs as jparam_pspecs  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import variants as tvariants  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.models import cache_logical_axes, model_defs  # noqa: E402
from repro_torch.models.config import ALL_SHAPES  # noqa: E402
from repro_torch.models.params import param_pspecs  # noqa: E402

TABLES = ("BASELINE_RULES", "PREFILL_RULES", "DECODE_RULES",
          "LONG_DECODE_RULES")
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def meshes():
    """(port DeviceMesh, reference AbstractMesh) of one production shape,
    the port's over a fake process group torn down after the test."""
    made = []

    def make(name):
        shape, names = MESHES[name]
        if dist.is_initialized():
            dist.destroy_process_group()
        made.append(True)
        return fake_mesh(shape, names), \
            jax.sharding.AbstractMesh(shape, names)
    yield make
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _fields(rules):
    return dataclasses.asdict(rules)


def _jspec(spec):
    return tuple(spec)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_are_the_references(table):
    assert _fields(getattr(TS, table)) == _fields(getattr(JS, table))


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("logical", [
    ("batch", None, "mlp"), ("batch", "seq", "heads", "head_dim"),
    ("batch", "act_seq", "d_model"), ("vocab", "embed_fsdp"),
    (None, "batch", "kv_heads", "cache_seq", "head_dim"),
    ("experts", "batch", "moe_capacity", "d_model"), ()])
def test_spec_entries_are_the_partition_specs(table, logical):
    assert getattr(TS, table).spec(*logical) == \
        _jspec(getattr(JS, table).spec(*logical))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table", TABLES)
def test_prune_to_mesh_matches(meshes, mesh_name, table):
    tmesh, jmesh = meshes(mesh_name)
    assert _fields(TS.prune_to_mesh(getattr(TS, table), tmesh)) == \
        _fields(JS.prune_to_mesh(getattr(JS, table), jmesh))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_divisible_matches(meshes, mesh_name):
    tmesh, jmesh = meshes(mesh_name)
    for n in (1, 2, 3, 9, 16, 32, 48, 49152, 49155, 512):
        for axis in (None, "data", "model", "pod", ("pod", "data"),
                     ("data", "model")):
            assert TS.divisible(n, tmesh, axis) == \
                JS.divisible(n, jmesh, axis), (n, axis)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_adapt_rules_for_matches(meshes, mesh_name, arch):
    tmesh, jmesh = meshes(mesh_name)
    cfg = configs.get_config(arch)
    kw = dict(n_kv=cfg.n_kv, n_experts=cfg.n_experts, n_heads=cfg.n_heads,
              d_ff=cfg.d_ff, vocab=cfg.padded_vocab)
    for table in TABLES:
        assert _fields(TS.adapt_rules_for(getattr(TS, table), tmesh,
                                          **kw)) == \
            _fields(JS.adapt_rules_for(getattr(JS, table), jmesh, **kw))
    assert _fields(TS.rules_for_model(cfg, tmesh)) == _fields(
        JS.adapt_rules_for(JS.prune_to_mesh(JS.BASELINE_RULES, jmesh),
                           jmesh, **kw))


@pytest.fixture(scope="module")
def jrules_for():
    """The reference dry-run's ``rules_for``.  Importing its module sets
    ``XLA_FLAGS`` for 512 host devices; JAX is started first so this
    process keeps its one device, and the variable is put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import rules_for
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return rules_for


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_and_rules_for_every_variant(meshes, jrules_for,
                                                  mesh_name, arch):
    """For every rule table, every variant and every shape of the arch:
    the dry-run's rules, and each parameter leaf's partition-spec entries
    under them, equal the reference's."""
    tmesh, jmesh = meshes(mesh_name)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    tdefs, jdefs = model_defs(cfg), jmodel_defs(jcfg)
    variants = ["baseline"] + sorted(jvariants.VARIANTS)
    assert sorted(tvariants.VARIANTS) == sorted(jvariants.VARIANTS)
    tshapes = {s.name: s for s in ALL_SHAPES}
    for jshape in JSHAPES:
        for v in variants:
            tr = tdryrun.rules_for(cfg, tshapes[jshape.name], tmesh, v)
            jr = jrules_for(jcfg, jshape, jmesh, v)
            assert _fields(tr) == _fields(jr), (jshape.name, v)
    for table in TABLES:
        for v in variants:
            base_t, base_j = getattr(TS, table), getattr(JS, table)
            if v != "baseline":
                base_t = tvariants.VARIANTS[v](base_t, cfg, None, tmesh)
                base_j = jvariants.VARIANTS[v](base_j, jcfg, None, jmesh)
            got = dict(_leaves(param_pspecs(tdefs, base_t)))
            want = jax.tree.leaves_with_path(
                jparam_pspecs(jdefs, base_j),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want = {"/" + "/".join(k.key for k in path): _jspec(s)
                    for path, s in want}
            assert got == want, (table, v)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_logical_axes_match(arch):
    want = jcache_axes(jconfigs.get_config(arch))
    assert cache_logical_axes(configs.get_config(arch)) == \
        {k: tuple(v) for k, v in want.items()}


def test_constrain_is_a_no_op_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert TS.constrain(x, TS.BASELINE_RULES, "batch", "mlp") is x
    assert TS.constrain(x, None, "batch", "mlp") is x


def test_placements_of_tuples_and_repeats(meshes):
    tmesh, _ = meshes("pod2x16x16")
    rules = TS.BASELINE_RULES
    # batch on ("pod", "data"): the batch dim cut over both mesh dims
    assert TS.logical_to_sharding(tmesh, rules, ("batch", None, "mlp")) == \
        [Shard(0), Shard(0), Shard(2)]
    # cache_seq on ("data", "model"), batch gone (long decode)
    assert TS.logical_to_sharding(
        tmesh, TS.LONG_DECODE_RULES,
        (None, "batch", "kv_heads", "cache_seq", "head_dim")) == \
        [Replicate(), Shard(3), Shard(3)]
    # two dims on "model" (the TP fallback of experts): the first keeps it
    tp = tvariants.VARIANTS["moe_tp_fallback"](rules, None, None, tmesh)
    assert TS.logical_to_sharding(
        tmesh, tp, ("experts", "embed_fsdp", "expert_mlp")) == \
        [Replicate(), Shard(1), Shard(0)]
